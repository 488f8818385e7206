"""Trainer-side curvature-service client: publish factors, install bases.

Port of ``kfac_pytorch_tpu/service/client.py``. Two layers:

* :class:`ServiceClient`: the install primitive. It splices a published
  basis payload into the K-FAC state where the inline refresh would have
  left it (``split_eigen_state`` into ``eigen``/``eigen_stacked``, plus
  ``spectrum_mass``), on the trainer's device.
* :class:`CurvatureService`: the loop facade the twins use::

      svc = CurvatureService(kfac, cadence, worker_devices=(dev,))
      for step in range(steps):
          state.kfac_state = svc.before_step(step, state.kfac_state)
          state, metrics = train_step(state, batch, ...)   # capture + apply
          svc.after_step(step, state.kfac_state)

  ``after_step`` publishes a copy of the factors at every refresh boundary
  (``step % kfac_update_freq == 0``, after the boundary step's EMA and
  forced flush) and kicks the worker; ``before_step`` installs the newest
  complete basis before the next step. The staleness guarantee: with
  ``staleness_budget`` S the basis of boundary step s is installed no later
  than the start of step ``s + 1 + S``: the client trains on the old basis
  while the worker computes, and blocks at the deadline rather than exceed
  the budget. S = 0 blocks every boundary's next step until the fresh
  basis lands, which is the inline schedule with its refresh one step
  after each boundary.

The transport is the deployment's shape: ``mailbox_dir=None`` is the
in-process layout (``DeviceMailbox`` pairs, the worker a thread of this
process refreshing on its own CUDA stream on ``worker_devices[0]``, which
may be the trainer's own card); a directory is the worker-process layout
(``HostMailbox`` pairs under it, a worker in another process serving them,
``run_worker=False`` here). On a training world of several ranks (the
preconditioner's ``world``), rank 0 alone publishes, and rank 0 chooses the
version every rank installs at each step and broadcasts it over the
training group, so no two ranks install at different steps.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.observability.trace import get_trace
from kfac_pytorch_tpu_torch.ops import precondition as precond_ops
from kfac_pytorch_tpu_torch.service.mailbox import DeviceMailbox, HostMailbox
from kfac_pytorch_tpu_torch.service.worker import SCALARS_KEY, CurvatureWorker, require_service

KFACState = Dict[str, Any]


class ServiceClient:
    """Installs published eigenbases into trainer-side K-FAC state."""

    def __init__(self, kfac, cadence=None):
        self.kfac = kfac
        self.cadence = cadence
        self.installed_version = -1
        self.installed_step = -1

    def _on_trainer(self, key: str, v) -> torch.Tensor:
        kfac = self.kfac
        t = torch.as_tensor(v)
        # the npz transport widened a bfloat16 Q to float32: narrow it back
        if key.startswith("Q") and t.dtype != kfac.eigen_dtype:
            t = t.to(kfac.eigen_dtype)
        t = t.to(kfac.device)
        if t.is_cuda:
            # made on the worker's stream, read on the trainer's from now on
            t.record_stream(torch.cuda.current_stream(t.device))
        return t

    def install(
        self,
        state: KFACState,
        payload: Dict[str, Dict[str, Any]],
        version: int,
        step: int,
        slip: int = 0,
    ) -> KFACState:
        """A new state with the published basis swapped in. The payload is
        the worker's per-layer eigen dict; the singles/stacked split happens
        here, so the mailbox carries the plain per-layer form."""
        entries = {
            n: {k: self._on_trainer(k, v) for k, v in e.items()}
            for n, e in payload.items()
            if n != SCALARS_KEY
        }
        eigen, stacked = precond_ops.split_eigen_state(entries)
        new_state = dict(state)
        new_state["eigen"] = eigen
        new_state["eigen_stacked"] = stacked
        scalars = payload.get(SCALARS_KEY) or {}
        if "spectrum_mass" in scalars and "spectrum_mass" in state:
            new_state["spectrum_mass"] = self._on_trainer("", scalars["spectrum_mass"]).float()
        self.installed_version = int(version)
        self.installed_step = int(step)
        get_trace().event("basis_install", basis_version=int(version), step=int(step),
                          slip=int(slip))
        if self.cadence is not None and hasattr(self.cadence, "note_basis_installed"):
            self.cadence.note_basis_installed(version=version, step=step, slip=slip)
        else:
            tel = get_telemetry()
            tel.set_gauge("kfac/basis_version", int(version))
            tel.set_gauge("kfac/basis_staleness_steps", int(slip))
        return new_state


class CurvatureService:
    """The service facade: mailboxes, worker and install loop (see the
    module docstring). ``tenant`` namespaces the mailboxes, so one worker
    fleet can serve several training jobs from one root."""

    def __init__(
        self,
        kfac,
        cadence=None,
        worker_devices: Sequence[Any] = (),
        supervisor=None,
        mailbox_dir: Optional[str] = None,
        tenant: str = "job0",
        run_worker: bool = True,
        async_worker: bool = True,
        staleness_budget: Optional[int] = None,
        timeout_s: float = 300.0,
    ):
        require_service(kfac, "CurvatureService")
        self.kfac = kfac
        self.cadence = cadence
        if mailbox_dir is not None:
            self.factors_box = HostMailbox(mailbox_dir, f"{tenant}-factors")
            self.basis_box = HostMailbox(mailbox_dir, f"{tenant}-basis")
        else:
            self.factors_box = DeviceMailbox(f"{tenant}-factors")
            self.basis_box = DeviceMailbox(f"{tenant}-basis")
        self.client = ServiceClient(kfac, cadence)
        self.worker: Optional[CurvatureWorker] = None
        if run_worker:
            self.worker = CurvatureWorker(
                kfac, self.factors_box, self.basis_box,
                device=(worker_devices[0] if worker_devices else None), supervisor=supervisor,
            )
        self.async_worker = bool(async_worker)
        self.staleness_budget = (
            int(kfac.staleness_budget) if staleness_budget is None else int(staleness_budget)
        )
        self.timeout_s = float(timeout_s)
        self.published_version = 0
        self.published_step = -1
        self._worker_thread: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        # the trainer's intra-op thread count: a new thread starts from the
        # process default, and a CPU eigh's rounding follows the count
        self._threads = torch.get_num_threads()
        # host milliseconds of each publish, install and deadline wait, and
        # each install's (version, step, slip)
        self.record: Dict[str, list] = {
            "publish_ms": [], "install_ms": [], "install_wait_ms": [], "installs": []}
        get_telemetry().set_gauge(
            "kfac/service_worker_count", len(worker_devices) if worker_devices else 1
        )

    # -- loop hooks ----------------------------------------------------

    def before_step(self, step: int, state: KFACState) -> KFACState:
        """Install the newest complete basis; block only at the staleness
        deadline (the module docstring's guarantee)."""
        if self.published_step < 0 or self.published_version <= self.client.installed_version:
            return state
        version = self._choose_version(step)
        if version > self.client.installed_version:
            t0 = time.monotonic()
            if isinstance(self.basis_box, HostMailbox):
                payload, _meta = self.basis_box.read(version)
            else:
                # the in-process worker may have landed a newer one since
                version, payload, _meta = self.basis_box.latest()
            get_trace().event("basis_consume", basis_version=int(version), step=int(step))
            # slip: steps late against the staleness-0 ideal of "installed
            # before the step after its publish boundary"
            slip = max(0, step - (self.published_step + 1))
            state = self.client.install(state, payload, version, step, slip=slip)
            self.record["install_ms"].append((time.monotonic() - t0) * 1000.0)
            self.record["installs"].append((int(version), int(step), int(slip)))
        return state

    def _choose_version(self, step: int) -> int:
        """The basis version to install before ``step`` (or the installed
        one): the newest complete, waited for at the deadline. On several
        training ranks rank 0 chooses and broadcasts its choice."""
        world = self.kfac.world
        version = -1
        if world.rank == 0:
            deadline = self.published_step + 1 + self.staleness_budget
            if self.basis_box.latest_version() < self.published_version and step >= deadline:
                tel, tr = get_telemetry(), get_trace()
                tel.inc("kfac/service_deadline_blocks")
                tr.event("install_wait_begin", basis_version=int(self.published_version),
                         step=int(step))
                t0 = time.monotonic()
                with tel.span("trace/kfac/service_install_wait"):
                    self._join_worker()
                    self.basis_box.wait_for(self.published_version, timeout_s=self.timeout_s)
                wait_ms = (time.monotonic() - t0) * 1000.0
                self.record["install_wait_ms"].append(wait_ms)
                tr.event("install_wait_end", basis_version=int(self.published_version),
                         step=int(step), wait_ms=wait_ms)
            version = self.basis_box.latest_version()
        if world.distributed and world.size > 1:
            version = _broadcast_int(version, world, self.kfac.device)
        return version

    def after_step(self, step: int, state: KFACState) -> None:
        """At a refresh boundary: publish a copy of the factors (on the
        training rank 0) and kick the worker."""
        if step % int(self.kfac.hparams.kfac_update_freq) != 0:
            return
        self.published_version += 1
        self.published_step = step
        if self.kfac.world.rank != 0:
            return
        t0 = time.monotonic()
        get_trace().event("factor_publish", basis_version=int(self.published_version),
                          step=int(step))
        snapshot, meta = self._snapshot_factors(state)
        self.factors_box.publish(self.published_version, snapshot,
                                 meta={**meta, "step": int(step)})
        publish_ms = (time.monotonic() - t0) * 1000.0
        self.record["publish_ms"].append(publish_ms)
        get_telemetry().observe("kfac/service_publish_ms", publish_ms)
        if self.worker is not None:
            if self.async_worker:
                self._join_worker()
                self._worker_thread = threading.Thread(
                    target=self._worker_step_guarded, daemon=True
                )
                self._worker_thread.start()
            else:
                self.worker.step(timeout_s=self.timeout_s)

    def _snapshot_factors(self, state: KFACState):
        """``(snapshot, meta)``: a copy of the live factors, which the next
        steps change in place (the int8 flush merges in place; an elastic
        restore copies into them). In-process it is a device copy taken on
        the trainer's stream, with the stream's ``ready`` event in ``meta``
        for the worker's stream to wait on; the host transport copies to
        the host inside ``publish``."""
        facs = state["factors"]
        if isinstance(self.factors_box, HostMailbox):
            return facs, {}
        snapshot = {n: {k: v.clone() for k, v in f.items()} for n, f in facs.items()}
        meta: Dict[str, Any] = {}
        dev = self.kfac.device
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            meta["ready"] = ready
        return snapshot, meta

    def _worker_step_guarded(self) -> None:
        try:
            torch.set_num_threads(self._threads)
            self.worker.step(timeout_s=self.timeout_s)
        except BaseException as e:  # noqa: BLE001 — re-raised on the trainer
            self._worker_error = e

    def _join_worker(self) -> None:
        t = self._worker_thread
        if t is not None:
            t.join(timeout=self.timeout_s)
            self._worker_thread = None
        if self._worker_error is not None:
            # a dead worker fails the run on the trainer's thread, not
            # silently at the staleness deadline's TimeoutError
            err, self._worker_error = self._worker_error, None
            raise RuntimeError("curvature worker failed") from err

    def close(self) -> None:
        """End of training: join the in-process worker and close the
        factors box, so a serving worker process stops (training rank 0)."""
        self._join_worker()
        if self.kfac.world.rank == 0:
            self.factors_box.close()


def _broadcast_int(value: int, world, device: torch.device) -> int:
    """Training rank 0's ``value`` on every rank of ``world``."""
    dev = device if dist.get_backend(world.group) == "nccl" else torch.device("cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    src = 0 if world.group is None else dist.get_global_rank(world.group, 0)
    dist.broadcast(t, src=src, group=world.group)
    return int(t.item())
