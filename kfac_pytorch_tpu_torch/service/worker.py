"""Curvature worker: runs the eigen (or rsvd) refresh off the training path.

Port of ``kfac_pytorch_tpu/service/worker.py``. A :class:`CurvatureWorker`
turns factor snapshots into eigenbases:

    factors mailbox --(consume v)--> refresh() --(publish v)--> basis mailbox

``refresh`` is the inline world-1 refresh of ``KFAC.update``, the same
functions with no second implementation: ``replicated_eigen_update`` with
``KFAC._rank_fn()``, the eigenvectors written in ``eigen_dtype``, and
``KFAC._finish_refresh`` (the embeddings' ``A_diag`` floor, and under
``solver="rsvd"`` the spectrum mass). So a staleness-0 service run is the
inline schedule whose refresh runs one step after each boundary: the same
factors in, the same basis out, only the *where* and *when* moved. The
service's constructor rows (no streaming fold, no chunks, ``diag_blocks``
1, no owner stacks, no shard-lens layers) keep this one replicated path
the only one the worker needs.

On a CUDA ``device`` the refresh runs on a CUDA stream of the worker's
own, which is how, on one card, the worker's eigh overlaps the trainer's
next capture steps. The stream first waits on the snapshot's ``ready``
event (taken on the trainer's stream after the copy), and a version is
complete only once the stream's work has finished: the worker synchronizes
the stream before it publishes (the JAX worker's ``device_get``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import torch

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.observability.trace import get_trace
from kfac_pytorch_tpu_torch.parallel.sharded_eigh import replicated_eigen_update

# Reserved payload key for run-level scalars riding a basis publish (the
# mailbox otherwise carries per-layer dicts only).
SCALARS_KEY = "__scalars__"


def require_service(kfac, who: str) -> None:
    if int(getattr(kfac, "service_devices", 0) or 0) <= 0:
        raise ValueError(f"{who} requires a KFAC configured with service_devices > 0")


class CurvatureWorker:
    """Consumes factor snapshots, publishes refreshed eigenbases.

    Args:
      kfac: the service-mode ``KFAC``: the worker reads ``eps``, the solver's
        rank plumbing and ``eigen_dtype`` from it, so its math tracks the
        trainer's configuration with no second source of truth.
      factors, basis: the two mailboxes (either transport); ``factors`` is
        consumed, ``basis`` published.
      device: where the refresh runs (default: the preconditioner's device).
      supervisor: an optional elastic ``Supervisor``: :meth:`serve` and
        :meth:`step` beat ``worker_beat`` through it, so a stalled worker is
        seen though it never advances the training step.
    """

    def __init__(self, kfac, factors, basis, device=None, supervisor=None):
        require_service(kfac, "CurvatureWorker")
        self.kfac = kfac
        self.factors = factors
        self.basis = basis
        self.device = torch.device(device) if device is not None else kfac.device
        self.supervisor = supervisor
        self.last_version = -1
        # the host milliseconds of each refresh served
        self.refresh_ms: list = []
        # the worker's own CUDA stream (created on first use, on the thread
        # that refreshes)
        self._stream = None

    # -- the math ------------------------------------------------------

    def _stream_ctx(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def _on_device(self, v) -> torch.Tensor:
        t = torch.as_tensor(v).to(self.device, non_blocking=True)
        if self._stream is not None:
            # made on the trainer's stream, read on this one: the caching
            # allocator must not hand its memory out before this read
            t.record_stream(self._stream)
        return t

    def refresh(self, facs: Dict[str, Dict[str, Any]], ready=None) -> Dict[str, Dict[str, Any]]:
        """One refresh of the factor snapshot ``facs`` (tensors or numpy
        arrays); returns the publishable basis payload, complete. ``ready``
        is the CUDA event the snapshot's copy recorded, which the worker's
        stream waits on before reading it."""
        kfac = self.kfac
        with self._stream_ctx():
            if ready is not None and self._stream is not None:
                self._stream.wait_event(ready)
            facs = {n: {k: self._on_device(v) for k, v in f.items()} for n, f in facs.items()}
            names = sorted(facs)
            blocks = {n: 1 for n in names}  # diag_blocks is 1 under the service
            eigen = replicated_eigen_update(
                facs, blocks, kfac.eps, kfac.eigen_dtype, rank_fn=kfac._rank_fn()
            )
            eigen, mass = kfac._finish_refresh(facs, eigen, names, None, kfac.solver == "rsvd")
            payload: Dict[str, Dict[str, Any]] = {n: eigen[n] for n in names}
            if mass is not None:
                payload[SCALARS_KEY] = {"spectrum_mass": mass}
            if self._stream is not None:
                # "complete" means the numbers exist: the trainer may read
                # them on its own stream with no event to wait on
                self._stream.synchronize()
        return payload

    # -- the loop ------------------------------------------------------

    def step(self, timeout_s: float = 0.0) -> Optional[int]:
        """Process at most one new factor snapshot; returns its version.
        With ``timeout_s`` 0 a poll (``None`` when nothing new is pending);
        positive blocks for the next one."""
        if timeout_s > 0:
            try:
                self.factors.wait_for(self.last_version + 1, timeout_s=timeout_s)
            except TimeoutError:
                return None
        got = self.factors.latest()
        if got is None:
            return None
        version, facs, meta = got
        if version <= self.last_version:
            return None
        meta = dict(meta)
        ready = meta.pop("ready", None)
        tr = get_trace()
        tr.event("worker_refresh_begin", basis_version=int(version), step=meta.get("step"))
        t0 = time.monotonic()
        payload = self.refresh(facs, ready)
        refresh_ms = (time.monotonic() - t0) * 1000.0
        tr.event("worker_refresh_end", basis_version=int(version), refresh_ms=refresh_ms)
        self.basis.publish(version, payload, meta={**meta, "refresh_ms": refresh_ms})
        self.last_version = version
        self.refresh_ms.append(refresh_ms)
        tel = get_telemetry()
        tel.set_gauge("kfac/basis_version", version)
        tel.observe("kfac/service_refresh_ms", refresh_ms)
        if self.supervisor is not None:
            self.supervisor.worker_beat(version=version)
        return version

    def serve(
        self,
        stop_version: Optional[int] = None,
        idle_timeout_s: float = 60.0,
        poll_s: float = 0.01,
    ) -> int:
        """The refresh loop of a dedicated worker (thread or process).

        Runs until it has served a snapshot of version >= ``stop_version``
        (with ``None``, until the factors box is closed and every snapshot
        in it served); raises ``TimeoutError`` after ``idle_timeout_s``
        with no new snapshot: a silent trainer is an error, as a silent
        worker is on the trainer's side. Returns the last served version."""
        last_new = time.monotonic()
        while True:
            v = self.step(timeout_s=0.0)
            if v is not None:
                last_new = time.monotonic()
                if stop_version is not None and v >= stop_version:
                    return v
                continue
            if stop_version is None and getattr(self.factors, "closed", False):
                # a publish may land between the poll and the close check
                if self.step(timeout_s=0.0) is None:
                    return self.last_version
                continue
            if self.supervisor is not None:
                self.supervisor.worker_beat(version=self.last_version)
            if time.monotonic() - last_new > idle_timeout_s:
                raise TimeoutError(
                    "curvature worker idle: no factor snapshot in "
                    f"{idle_timeout_s}s (last served version {self.last_version})"
                )
            time.sleep(poll_s)

