"""Versioned factor/eigenbasis mailboxes: the curvature service's transport.

Port of ``kfac_pytorch_tpu/service/mailbox.py``. Two directions share one
abstraction: the trainer publishes factor snapshots (``{layer: {"A"|
"A_diag": ..., "G": ...}}``) toward the worker, and the worker publishes
refreshed eigenbases (``{layer: {"QA", "dA", ...}}`` plus optional scalars)
back. Every publish carries a monotonically increasing **version**, and a
consumer only ever sees *complete* versions: a torn write never hands the
training step half a basis.

Two transports, one protocol:

* :class:`HostMailbox`: a directory-backed ringbuffer, for a worker in
  another process (the twins' ``--service-devices`` worker rank). The same
  on-disk format as the JAX package's, so a box written by either package
  reads in the other: ``v-%08d`` directories, a ``payload.npz`` of
  ``::``-joined keys written through one buffer and ``os.replace``, then
  ``manifest.json`` (atomic rename), so ``latest()`` skipping
  manifest-less directories IS the completeness check; old versions pruned
  to ``keep``. Tensors cross as numpy arrays: bfloat16 ones (Q under
  ``eigen_dtype=torch.bfloat16``) widen exactly to float32, as numpy has
  no bfloat16, and the client narrows them back on install.
* :class:`DeviceMailbox`: an in-process slot (the shared-card layout:
  trainer and worker are threads of one process). ``publish`` stores the
  tensors themselves; the publisher makes them complete first (the
  worker synchronizes its CUDA stream before it publishes a basis; a
  factor snapshot carries the trainer stream's event in ``meta["ready"]``
  for the worker's stream to wait on).

The payload is a two-level ``{name: {key: tensor or array}}`` dict,
flattened with ``::``-joined keys for the npz form.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch.observability.trace import get_trace

_MANIFEST = "manifest.json"
_PAYLOAD = "payload.npz"
_CLOSED = "closed"
_VERSION_DIR = re.compile(r"^v-(\d{8})$")
_KEY_SEP = "::"


def _check_names(payload: Dict[str, Any]) -> None:
    for name in payload:
        if _KEY_SEP in name:
            raise ValueError(f"mailbox layer name may not contain '{_KEY_SEP}': {name!r}")


def _as_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _flatten(payload: Dict[str, Dict[str, Any]]) -> Dict[str, np.ndarray]:
    _check_names(payload)
    return {
        f"{name}{_KEY_SEP}{key}": _as_numpy(value)
        for name, sub in payload.items()
        for key, value in sub.items()
    }


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for fk, value in flat.items():
        name, key = fk.split(_KEY_SEP, 1)
        out.setdefault(name, {})[key] = value
    return out


def _publish_event(box: str, version: int, meta: Optional[Dict[str, Any]]) -> None:
    get_trace().event(
        "mailbox_publish", box=box, basis_version=int(version), step=(meta or {}).get("step")
    )


def _wait_for(box, where: str, version: int, timeout_s: float, poll_s: float) -> int:
    deadline = time.monotonic() + float(timeout_s)
    while True:
        v = box.latest_version()
        if v >= version:
            return v
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"curvature mailbox {where}: no complete version >= {version} after "
                f"{timeout_s}s (newest: {v}) — is the curvature worker alive?"
            )
        time.sleep(poll_s)


class HostMailbox:
    """Directory-backed versioned mailbox (see the module docstring).

    One publisher per mailbox (the trainer's rank 0 for factors, the
    worker for bases); several training jobs give each its own ``name``
    under a shared root. :meth:`close` marks the box finished, so a
    serving worker can stop (:attr:`closed`)."""

    def __init__(self, root: str, name: str = "factors", keep: int = 2):
        self.name = name
        self.root = os.path.join(os.path.abspath(root), name)
        self.keep = max(1, int(keep))
        os.makedirs(self.root, exist_ok=True)

    def _version_dir(self, version: int) -> str:
        return os.path.join(self.root, f"v-{int(version):08d}")

    def publish(
        self,
        version: int,
        payload: Dict[str, Dict[str, Any]],
        meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write version ``version``; returns its directory. Payload first,
        manifest last (atomic rename); versions only move forward."""
        latest = self.latest_version()
        if version <= latest:
            raise ValueError(
                f"mailbox version must be monotonic: publishing {version} after {latest}"
            )
        flat = _flatten(payload)
        d = self._version_dir(version)
        os.makedirs(d, exist_ok=True)
        # one buffer, one write: a crashed publisher leaves no short
        # payload.npz that a later manifest rename could legitimize
        buf = io.BytesIO()
        np.savez(buf, **flat)
        tmp = os.path.join(d, f"{_PAYLOAD}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(buf.getvalue())
        os.replace(tmp, os.path.join(d, _PAYLOAD))
        manifest = {
            "version": int(version),
            "complete": True,
            "published_t": time.time(),
            "meta": dict(meta or {}),
        }
        mtmp = os.path.join(d, f"{_MANIFEST}.tmp")
        with open(mtmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(mtmp, os.path.join(d, _MANIFEST))
        _publish_event(self.name, version, meta)
        self._prune()
        return d

    def _complete_versions(self) -> list:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in names:
            m = _VERSION_DIR.match(n)
            if m and os.path.isfile(os.path.join(self.root, n, _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def versions(self) -> list:
        """Complete versions present, ascending."""
        return self._complete_versions()

    def latest_version(self) -> int:
        """Newest complete version, or -1 when the box is empty."""
        vs = self._complete_versions()
        return vs[-1] if vs else -1

    def read(self, version: int) -> Tuple[Dict[str, Dict[str, np.ndarray]], Dict[str, Any]]:
        """``(payload, meta)`` of a complete version."""
        d = self._version_dir(version)
        with open(os.path.join(d, _MANIFEST)) as fh:
            manifest = json.load(fh)
        with np.load(os.path.join(d, _PAYLOAD)) as z:
            flat = {k: np.array(z[k]) for k in z.files}
        return _unflatten(flat), manifest.get("meta", {})

    def latest(self) -> Optional[Tuple[int, Dict[str, Dict[str, np.ndarray]], Dict[str, Any]]]:
        """``(version, payload, meta)`` of the newest complete version."""
        v = self.latest_version()
        if v < 0:
            return None
        payload, meta = self.read(v)
        return v, payload, meta

    def wait_for(self, version: int, timeout_s: float = 60.0, poll_s: float = 0.02) -> int:
        """Block until a complete version >= ``version`` exists; returns it.
        Raises ``TimeoutError``: a dead worker fails the run loudly."""
        return _wait_for(self, self.root, version, timeout_s, poll_s)

    def close(self) -> None:
        """Mark the box finished: the publisher has nothing more to send."""
        with open(os.path.join(self.root, _CLOSED), "w"):
            pass

    @property
    def closed(self) -> bool:
        return os.path.isfile(os.path.join(self.root, _CLOSED))

    def _prune(self) -> None:
        for v in self._complete_versions()[: -self.keep]:
            shutil.rmtree(self._version_dir(v), ignore_errors=True)


class DeviceMailbox:
    """In-process versioned slot (see the module docstring). Keeps only the
    newest version (device memory is the scarce resource, and a consumer
    that skipped versions wants the newest anyway). Thread-safe: the
    in-process worker publishes from its own thread."""

    def __init__(self, name: str = "factors"):
        self.name = name
        self._lock = threading.Lock()
        self._version = -1
        self._payload: Optional[Dict[str, Dict[str, Any]]] = None
        self._meta: Dict[str, Any] = {}
        self._closed = False

    def publish(
        self,
        version: int,
        payload: Dict[str, Dict[str, Any]],
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        # the npz transport's name rule, so a payload is valid on both
        _check_names(payload)
        with self._lock:
            if version <= self._version:
                raise ValueError(
                    f"mailbox version must be monotonic: publishing {version} "
                    f"after {self._version}"
                )
            self._version = int(version)
            self._payload = payload
            self._meta = dict(meta or {})
        _publish_event(self.name, version, meta)

    def latest_version(self) -> int:
        with self._lock:
            return self._version

    def latest(self) -> Optional[Tuple[int, Dict[str, Dict[str, Any]], Dict[str, Any]]]:
        with self._lock:
            if self._payload is None:
                return None
            return self._version, self._payload, self._meta

    def wait_for(self, version: int, timeout_s: float = 60.0, poll_s: float = 0.002) -> int:
        return _wait_for(self, repr(self.name), version, timeout_s, poll_s)

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed
