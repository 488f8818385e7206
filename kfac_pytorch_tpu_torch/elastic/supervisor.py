"""Host-side elastic supervision: snapshots, preemption, liveness.

Port of ``kfac_pytorch_tpu/elastic/supervisor.py``: the loop the trainers
wire between steps (``--snapshot-every`` / ``--preempt-save-dir``).
Everything here is host Python, outside the train step:

* **periodic snapshots** — every ``snapshot_every`` steps the live
  ``TrainState`` is captured (``state_io.capture_snapshot``: the device
  idle, the gathers, host copies of their own; the part the step blocks
  on, whose duration ``kfac/snapshot_duration_ms`` reports) and the
  payload and manifest are written, on one process by a background thread
  (joined before the next snapshot, so at most one write is in flight; an
  error of that write is raised as ``SnapshotError`` by the next
  :meth:`Supervisor.wait`). With more than one rank every rank enters the
  capture's gathers on its main thread and rank 0 writes synchronously, as
  the JAX package forces snapshots synchronous across processes;
* **SIGTERM/preemption-triggered emergency snapshot** —
  :meth:`Supervisor.install_signal_handlers` flips a flag; the next
  :meth:`Supervisor.on_step` takes a synchronous snapshot and tells the
  trainer to stop. The flag is each rank's own and no collective agrees on
  it, as in the JAX package: ``torchrun`` forwards SIGTERM to every
  worker, and the fault injector fires at the same step on every rank;
* **restart-scan-resume** — :meth:`Supervisor.scan_resume` picks rank 0's
  newest COMPLETE snapshot, restores it into the target's tensors,
  re-homes the K-FAC state for the current world (the deterministic resize
  replan when the owner world changed) and reloads the refresh cadence, so
  mid-interval resumes are exact;
* **per-rank liveness heartbeat** — each rank writes a timestamped beat
  under ``<save_dir>/heartbeats/``; ``kfac/host_liveness`` gauges how many
  beat within the window. A curvature-service worker beats on wall clock
  through :meth:`Supervisor.worker_beat`.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from kfac_pytorch_tpu_torch.elastic import replan as _replan
from kfac_pytorch_tpu_torch.elastic import state_io
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.observability.trace import get_trace
from kfac_pytorch_tpu_torch.parallel import launch

_HEARTBEAT_DIR = "heartbeats"


class Preempted(RuntimeError):
    """Raised by trainers that prefer an exception over a stop-flag."""


class Supervisor:
    """One per process. See the module docstring for the contract."""

    def __init__(
        self,
        save_dir: str,
        snapshot_every: int = 0,
        keep: int = 2,
        kfac: Any = None,
        cadence: Any = None,
        heartbeat_every: int = 0,
        liveness_window_s: float = 300.0,
        async_snapshots: bool = True,
        fault_injector: Any = None,
    ):
        self.save_dir = os.path.abspath(save_dir)
        self.snapshot_every = int(snapshot_every)
        self.keep = max(1, int(keep))
        self.kfac = kfac
        self.cadence = cadence
        self.heartbeat_every = int(heartbeat_every)
        self.liveness_window_s = float(liveness_window_s)
        # across ranks every rank must enter the capture's gathers together
        self.async_snapshots = bool(async_snapshots) and launch.size() == 1
        self.fault_injector = fault_injector
        self.preempt_requested = False
        self._last_worker_beat = 0.0
        self.last_snapshot_step: Optional[int] = None
        self.snapshot_durations_ms: list = []
        # the writes' own seconds (rank 0), beside the blocking durations
        self.write_durations_ms: list = []
        self._writer: Optional[threading.Thread] = None
        self._writer_error: list = []
        if launch.is_primary():
            os.makedirs(self.save_dir, exist_ok=True)

    # -- signals ------------------------------------------------------

    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """Route preemption signals into the stop-and-snapshot path. Only
        flips a flag; the snapshot happens at the next :meth:`on_step`."""
        for sig in signals:
            signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        self.preempt_requested = True

    # -- snapshots ----------------------------------------------------

    def wait(self) -> None:
        """Join any in-flight background snapshot write; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error:
            err = self._writer_error.pop()
            raise state_io.SnapshotError(f"background snapshot write failed: {err}")

    def _write(self, step: int, payload, manifest) -> None:
        t0 = time.monotonic()
        state_io.write_snapshot(self.save_dir, step, payload, manifest)
        if launch.is_primary():
            self.write_durations_ms.append((time.monotonic() - t0) * 1e3)
        get_trace().event("snapshot_commit",
                          snapshot_id=os.path.basename(state_io.snapshot_dir(self.save_dir, step)),
                          step=int(step))
        self._gc()

    def snapshot(
        self,
        step: int,
        state: Any,
        extra: Optional[Dict[str, Any]] = None,
        sync: bool = False,
        aux: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write ``snap-<step>``; in the background on one process unless
        ``sync`` (see the module docstring). Every rank must call it.

        Returns the snapshot path at once; a background write's manifest
        appears when it commits."""
        self.wait()
        t0 = time.monotonic()
        snap = state_io.snapshot_dir(self.save_dir, step)
        background = self.async_snapshots and not sync
        get_trace().event("snapshot_begin", snapshot_id=os.path.basename(snap), step=int(step),
                          sync=not background)
        payload, manifest = state_io.capture_snapshot(
            step, state, kfac=self.kfac, cadence=self.cadence, extra=extra, aux=aux)
        if background:
            def write():
                try:
                    self._write(step, payload, manifest)
                except Exception as e:  # noqa: BLE001 — raised by wait()
                    self._writer_error.append(f"{type(e).__name__}: {e}")

            self._writer = threading.Thread(target=write, name="kfac-snapshot", daemon=True)
            self._writer.start()
        else:
            self._write(step, payload, manifest)
            # every rank returns with the snapshot on disk
            launch.barrier()
        dur_ms = (time.monotonic() - t0) * 1e3
        self.snapshot_durations_ms.append(dur_ms)
        self.last_snapshot_step = int(step)
        tel = get_telemetry()
        tel.set_gauge("kfac/snapshot_duration_ms", dur_ms)
        tel.set_gauge("kfac/snapshot_age_steps", 0)
        return snap

    def _gc(self) -> None:
        """Drop all but the newest ``keep`` complete snapshots (rank 0)."""
        if not launch.is_primary():
            return
        for _, path in state_io.list_snapshots(self.save_dir)[: -self.keep]:
            get_trace().event("snapshot_gc", snapshot_id=os.path.basename(path))
            shutil.rmtree(path, ignore_errors=True)

    # -- the per-step hook --------------------------------------------

    def on_step(
        self,
        step: int,
        state_fn: Callable[[], Any],
        extra: Optional[Dict[str, Any]] = None,
        aux: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> bool:
        """Call once per completed step. Returns True when training must
        stop NOW (preemption observed; the emergency snapshot is on disk).
        ``state_fn`` (and ``aux``, this rank's host-loop tensors) are
        zero-argument, so they are materialized only when a snapshot is
        due."""
        if self.fault_injector is not None:
            self.fault_injector.on_step(step, self)
        tel = get_telemetry()
        if self.preempt_requested:
            self.snapshot(step, state_fn(), extra=extra, sync=True,
                          aux=None if aux is None else aux())
            self.wait()
            return True
        if self.snapshot_every > 0 and step > 0 and step % self.snapshot_every == 0:
            self.snapshot(step, state_fn(), extra=extra, aux=None if aux is None else aux())
        if self.heartbeat_every > 0 and step % self.heartbeat_every == 0:
            self.heartbeat(step)
            tel.set_gauge("kfac/host_liveness", self.liveness())
        age = step if self.last_snapshot_step is None else step - self.last_snapshot_step
        tel.set_gauge("kfac/snapshot_age_steps", age)
        return False

    # -- resume -------------------------------------------------------

    def scan_resume(
        self, target: Any, params: Any = None
    ) -> Optional[Tuple[Any, Dict[str, Any], int]]:
        """``(state, manifest, resume_step)`` from rank 0's newest complete
        snapshot, restored into ``target``'s tensors, or None when the
        directory holds none. Every rank must call it.

        The K-FAC state is re-homed for ``self.kfac``'s world; when the
        snapshot is owner-form, the preconditioner asked for the owner mode
        and the data world changed, the deterministic resize replan
        re-scatters the stacks (``params``, default the target's model, is
        the shape oracle). The manifest's ``aux`` is this rank's row of the
        saved host-loop tensors."""
        found = state_io.broadcast_latest(self.save_dir)
        if found is None:
            return None
        step, snap = found
        manifest = state_io.load_manifest(snap)
        kfac = self.kfac
        place = None
        if (
            kfac is not None
            and manifest.get("sharding") == "owner"
            and getattr(kfac, "requested_factor_sharding", None) == "owner"
            and int(manifest.get("world") or 0) != int(kfac.world.size)
        ):
            model = params if params is not None else target.model

            def place(kstate):
                state_io.validate_state_keys(kstate)
                return _replan.replan_state(
                    kfac, kstate, model, int(manifest["world"]),
                    expect_fingerprint=manifest.get("shard_plan_fingerprint"))

        state, manifest = state_io.restore_snapshot(snap, target, kfac=kfac,
                                                    cadence=self.cadence, place=place)
        resume_step = int(manifest.get("step", step))
        get_trace().event("resume", snapshot_id=os.path.basename(snap), step=resume_step)
        return state, manifest, resume_step

    # -- liveness -----------------------------------------------------

    def _beat(self, name: str, record: Dict[str, Any]) -> None:
        path = os.path.join(self.save_dir, _HEARTBEAT_DIR, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh)
        os.replace(tmp, path)

    def heartbeat(self, step: int) -> None:
        """Write this rank's beat (atomic rename, shared-storage safe)."""
        self._beat(f"host-{launch.rank()}.json", {"t": time.time(), "step": int(step)})
        get_trace().event("heartbeat", step=int(step))

    def worker_beat(self, version: int = -1, min_interval_s: Optional[float] = None) -> None:
        """Liveness beat for curvature-service workers, which never advance
        the training step: on wall clock (at most every ``min_interval_s``,
        default a quarter of the liveness window), recording the basis
        version they last published in place of a step."""
        if min_interval_s is None:
            min_interval_s = self.liveness_window_s / 4.0
        now = time.time()
        if now - self._last_worker_beat < float(min_interval_s):
            return
        self._last_worker_beat = now
        self._beat(f"worker-{launch.rank()}.json",
                   {"t": now, "version": int(version), "role": "curvature-worker"})
        get_trace().event("worker_heartbeat", basis_version=int(version))

    def liveness(self) -> int:
        """Ranks whose last beat is within the liveness window."""
        d = os.path.join(self.save_dir, _HEARTBEAT_DIR)
        if not os.path.isdir(d):
            return 0
        now = time.time()
        live = 0
        for name in os.listdir(d):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as fh:
                    beat = json.load(fh)
            except (OSError, ValueError):
                continue
            if now - float(beat.get("t", 0)) <= self.liveness_window_s:
                live += 1
        return live
