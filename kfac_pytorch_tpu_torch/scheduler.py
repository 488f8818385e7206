"""KFACParamScheduler and EigenRefreshCadence: the host-side schedules.

Port of ``kfac_pytorch_tpu/scheduler.py``. ``KFACParamScheduler``:
StepLR-like multiplicative decay of damping and of the factor /
preconditioner update frequencies, mutating the preconditioner's
host-side ``KFACHParams``. ``EigenRefreshCadence``: the per-step refresh
flags of the pipelined refresh, the staleness slip, the streaming solver
and the deferred factor flush, reading the same live ``KFACHParams``.

Both publish the JAX package's telemetry: the scheduler the live
hyperparameters (``kfac/damping``, ``kfac/fac_update_freq``,
``kfac/kfac_update_freq``), the cadence every step its chunk phase, basis
age, solver, overlap mode, staleness and streaming gauges, and its slips,
catch-ups, forced flushes and re-orthonormalizations as flight-recorder
events (``observability/trace.py``). The gauges read the cadence's
counters: ``_reorth_count``, ``_swap_slip``, ``_flush_slip``,
``_since_flush`` (capture steps since the last deferred flush) and
``basis_age`` (steps since the last refresh or swap). Under the curvature
service (``service_devices > 0``) no refresh flag ever fires, the deferred
flush is forced at every boundary (the published snapshot is the merged
factors), and the service gauges read the worker count and the installed
basis's version and slip (:meth:`EigenRefreshCadence.note_basis_installed`).
"""

from __future__ import annotations

from typing import List, Optional

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.observability.trace import get_trace
from kfac_pytorch_tpu_torch.preconditioner import KFAC, KFACHParams

#: Comm/compute pressure above which a ``staleness_budget > 0`` cadence
#: starts slipping pending eigen swaps (the JAX package's constant).
STALENESS_PRESSURE_THRESHOLD = 1.0


class KFACParamScheduler:
    """Updates K-FAC hyperparameters according to the epoch.

    Args:
      kfac: the ``KFAC`` preconditioner (its ``hparams`` are mutated).
      damping_alpha: multiplicative damping factor.
      damping_schedule: epochs at which to multiply damping by the alpha.
      update_freq_alpha: multiplicative update-freq factor.
      update_freq_schedule: epochs at which to scale both update freqs.
      start_epoch: resume position.
    """

    def __init__(
        self,
        kfac: KFAC,
        damping_alpha: float = 1,
        damping_schedule: Optional[List[int]] = None,
        update_freq_alpha: float = 1,
        update_freq_schedule: Optional[List[int]] = None,
        start_epoch: int = 0,
    ):
        self.kfac = kfac
        params: KFACHParams = kfac.hparams

        self.damping_base = params.damping
        self.damping_alpha = damping_alpha
        self.damping_schedule = damping_schedule
        self.damping_factor_func = self._get_factor_func(damping_schedule, damping_alpha)

        self.fac_update_freq_base = params.fac_update_freq
        self.kfac_update_freq_base = params.kfac_update_freq
        self.update_freq_alpha = update_freq_alpha
        self.update_freq_schedule = update_freq_schedule
        self.update_freq_factor_func = self._get_factor_func(
            update_freq_schedule, update_freq_alpha
        )

        self.epoch = start_epoch

    @staticmethod
    def _get_factor_func(schedule: Optional[List[int]], alpha: float):
        """α^k where k = number of schedule epochs already passed."""
        schedule = sorted(schedule, reverse=True) if schedule is not None else []

        def factor_func(epoch: int) -> float:
            factor = 1.0
            for e in schedule:
                if epoch >= e:
                    factor *= alpha
            return factor

        return factor_func

    def step(self, epoch: Optional[int] = None) -> None:
        """Recompute damping and update freqs for the (given or next) epoch."""
        if epoch is not None:
            self.epoch = epoch
        else:
            self.epoch += 1

        params = self.kfac.hparams
        params.damping = self.damping_base * self.damping_factor_func(self.epoch)

        factor = self.update_freq_factor_func(self.epoch)
        params.fac_update_freq = max(1, int(self.fac_update_freq_base * factor))
        params.kfac_update_freq = max(1, int(self.kfac_update_freq_base * factor))

        # the live hyperparameters, so an exported snapshot shows which
        # schedule point produced it
        tel = get_telemetry()
        tel.set_gauge("kfac/damping", params.damping)
        tel.set_gauge("kfac/fac_update_freq", params.fac_update_freq)
        tel.set_gauge("kfac/kfac_update_freq", params.kfac_update_freq)


class EigenRefreshCadence:
    """Host-side step gating of the pipelined (chunked) eigen refresh.

    ``flags_for_step(step, epoch)`` every step, splatted into the train
    step. With ``eigh_chunks == 1`` (or ``kfac=None``) the flags equal
    ``training.step.kfac_flags_for_step``'s, so trainers use this class
    unconditionally.

    With ``K = eigh_chunks > 1`` each ``kfac_update_freq`` boundary opens a
    refresh interval: the steps at offsets ``0..k_eff-1`` each run one chunk
    into ``state["eigen_pending"]`` (``k_eff = min(K, kfac_update_freq)``,
    from the live hparams, so a schedule change re-plans at the next
    boundary), and the last chunk's step carries ``swap_eigen``. The
    invariant: swap only when every chunk of the interval's plan has
    landed. A plan that changes mid-interval (the update frequency shrank
    below the chunks in flight, the diag warmup ended) abandons the partial
    pass, which chunk 0 of the next interval overwrites. The first boundary
    runs the monolithic refresh instead: the init basis is zeros.

    Bounded staleness (``staleness_budget = S > 0``): while
    ``kfac.staleness_signal()`` exceeds :data:`STALENESS_PRESSURE_THRESHOLD`
    the last chunk withholds its swap, which lands later as a bare swap,
    at most ``S`` steps late and never past the interval's chunk-free
    steps. Streaming (``solver="streaming"``): no chunks; a boundary
    re-orthonormalizes (a refresh) when ``kfac.stream_drift_signal()``
    exceeds ``stream_drift_threshold``, and always before the first one or
    with no signal wired.

    Deferred factor communication (``kfac.factor_comm.defer``): the flags
    carry ``flush_factors``, set every ``factor_comm_freq``-th capture step
    and forced on a refresh, on chunk 0 and, under streaming, at every
    boundary (the fold must read merged factors). Under pressure a due
    flush that is not forced slips, at most ``staleness_budget`` steps,
    and catches up on the next capture step once the pressure drops or the
    budget runs out.
    """

    def __init__(self, kfac: Optional[KFAC], chunks: Optional[int] = None):
        self.kfac = kfac
        self.chunks = int(
            chunks if chunks is not None else getattr(kfac, "eigh_chunks", 1) or 1
        ) if kfac is not None else 1
        if self.chunks > 1 and kfac is not None and kfac.eigh_chunks <= 1:
            raise ValueError(
                "EigenRefreshCadence(chunks > 1) needs KFAC(eigh_chunks > 1) "
                "— the state carries no eigen_pending double buffer"
            )
        self._landed: set = set()
        self._plan_key = None  # (k_eff, diag_warmup_done) of the open interval
        self._last_refresh_step: Optional[int] = None
        self._bootstrapped = False
        self._swap_pending = False  # a complete pending basis awaits its swap
        self._swap_slip = 0  # steps the current swap has slipped
        self._flush_owed = False
        self._flush_slip = 0
        self._since_flush = 0
        self._reorth_count = 0  # streaming re-orthonormalizations so far
        self._stream_signal: Optional[float] = None  # the last drift read
        self._basis_version = -1
        self._basis_installed_step: Optional[int] = None
        self._basis_slip = 0
        self.basis_age = 0

    def state_dict(self) -> dict:
        """The host-side interval state, JSON-serializable (the JAX
        package's keys)."""
        return {
            "landed": sorted(self._landed),
            "plan_key": (
                None if self._plan_key is None
                else [int(self._plan_key[0]), bool(self._plan_key[1])]
            ),
            "last_refresh_step": self._last_refresh_step,
            "bootstrapped": self._bootstrapped,
            "swap_pending": self._swap_pending,
            "swap_slip": self._swap_slip,
            "flush_owed": self._flush_owed,
            "flush_slip": self._flush_slip,
            "since_flush": self._since_flush,
            "reorth_count": self._reorth_count,
            "basis_version": self._basis_version,
            "basis_installed_step": self._basis_installed_step,
            "basis_slip": self._basis_slip,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore :meth:`state_dict`'s output."""
        self._landed = set(int(c) for c in d.get("landed", []))
        pk = d.get("plan_key")
        self._plan_key = None if pk is None else (int(pk[0]), bool(pk[1]))
        lrs = d.get("last_refresh_step")
        self._last_refresh_step = None if lrs is None else int(lrs)
        self._bootstrapped = bool(d.get("bootstrapped", False))
        self._swap_pending = bool(d.get("swap_pending", False))
        self._swap_slip = int(d.get("swap_slip", 0))
        self._flush_owed = bool(d.get("flush_owed", False))
        self._flush_slip = int(d.get("flush_slip", 0))
        self._since_flush = int(d.get("since_flush", 0))
        self._reorth_count = int(d.get("reorth_count", 0))
        self._basis_version = int(d.get("basis_version", -1))
        bis = d.get("basis_installed_step")
        self._basis_installed_step = None if bis is None else int(bis)
        self._basis_slip = int(d.get("basis_slip", 0))

    def note_basis_installed(self, version: int, step: int, slip: int = 0) -> None:
        """Record a curvature-service basis install before ``step``
        (``service.ServiceClient.install``): it is that mode's refresh
        event, and ``slip`` (steps past the staleness-0 ideal, at most
        ``staleness_budget``) feeds ``kfac/basis_staleness_steps``."""
        self._basis_version = int(version)
        self._basis_installed_step = int(step)
        self._basis_slip = int(slip)
        self._last_refresh_step = int(step)
        self._bootstrapped = True

    def _pressure(self) -> float:
        signal = getattr(self.kfac, "staleness_signal", None)
        return 0.0 if signal is None else float(signal())

    def flags_for_step(self, step: int, epoch: Optional[int] = None) -> dict:
        """The ``KFAC.update`` flags of ``step`` (and the cadence's gauges
        and events)."""
        if self.kfac is None:
            return {"update_factors": False, "update_eigen": False}
        hp = self.kfac.hparams
        warm = epoch is None or epoch >= self.kfac.diag_warmup
        flags = {
            "update_factors": step % hp.fac_update_freq == 0,
            "update_eigen": False,
            "diag_warmup_done": warm,
        }
        k_eff = max(1, min(self.chunks, hp.kfac_update_freq))
        boundary = step % hp.kfac_update_freq == 0
        chunk = None
        budget = int(getattr(self.kfac, "staleness_budget", 0) or 0)
        slipping = budget > 0 and self._pressure() > STALENESS_PRESSURE_THRESHOLD
        # a swap slips only into the interval's chunk-free tail
        swap_allowance = min(budget, hp.kfac_update_freq - k_eff)
        streaming = getattr(self.kfac, "solver", "eigh") == "streaming"
        service = int(getattr(self.kfac, "service_devices", 0) or 0) > 0
        if service:
            # the workers refresh out of band and the service installs
            # their bases between steps: only capture stays in the step
            pass
        elif streaming:
            if boundary:
                signal = getattr(self.kfac, "stream_drift_signal", None)
                if not self._bootstrapped or signal is None:
                    reorth = True
                else:
                    self._stream_signal = float(signal())
                    reorth = self._stream_signal > float(
                        getattr(self.kfac, "stream_drift_threshold", 0.0)
                    )
                if reorth:
                    flags["update_eigen"] = True
                    self._bootstrapped = True
                    self._last_refresh_step = step
                    self._reorth_count += 1
                    get_trace().event(
                        "cadence_reorth_fired", step=int(step), residual=self._stream_signal
                    )
                else:
                    get_trace().event(
                        "cadence_reorth_skipped", step=int(step), residual=self._stream_signal
                    )
        elif k_eff == 1:
            flags["update_eigen"] = boundary
            if boundary:
                self._last_refresh_step = step
                self._bootstrapped = True
                self._landed = set()
                self._plan_key = None
                self._swap_pending = False
                self._swap_slip = 0
        elif boundary and not self._bootstrapped:
            flags["update_eigen"] = True
            self._bootstrapped = True
            self._last_refresh_step = step
            self._landed = set()
            self._plan_key = None
        else:
            offset = step % hp.kfac_update_freq
            plan_key = (k_eff, warm)
            if boundary:
                self._landed = set()
                self._plan_key = plan_key
                self._swap_pending = False
                self._swap_slip = 0
            if offset < k_eff and self._plan_key == plan_key:
                chunk = offset
                self._landed.add(offset)
                swap = self._landed == set(range(k_eff))
                if swap and slipping and swap_allowance > 0:
                    # run the last chunk, withhold the swap
                    swap = False
                    self._swap_pending = True
                    self._swap_slip = 1
                    get_trace().event("cadence_swap_slipped", step=int(step), slip=1)
                flags["eigen_chunk"] = (offset, k_eff)
                flags["swap_eigen"] = swap
                if swap:
                    self._last_refresh_step = step
            elif self._swap_pending:
                if slipping and self._swap_slip < swap_allowance:
                    self._swap_slip += 1
                    get_trace().event(
                        "cadence_swap_slipped", step=int(step), slip=int(self._swap_slip)
                    )
                else:
                    # the slipped swap lands as a bare promote
                    flags["swap_eigen"] = True
                    self._swap_pending = False
                    get_trace().event(
                        "cadence_swap_catchup", step=int(step), slip=int(self._swap_slip)
                    )
                    self._swap_slip = 0
                    self._last_refresh_step = step
        comm = getattr(self.kfac, "factor_comm", None)
        if comm is not None and comm.defer:
            self._flush_flag(flags, step, chunk, boundary, streaming or service, budget,
                             slipping, comm)
        self.basis_age = 0 if self._last_refresh_step is None else step - self._last_refresh_step
        self._publish(k_eff, chunk, streaming, comm, service)
        return flags

    def _publish(self, k_eff, chunk, streaming, comm, service=False) -> None:
        """The JAX cadence's per-step gauges."""
        tel = get_telemetry()
        if not tel.enabled:
            return
        tel.set_gauge("kfac/eigh_chunks", k_eff)
        tel.set_gauge("kfac/eigen_chunk_phase", -1 if chunk is None else chunk)
        tel.set_gauge("kfac/eigen_basis_age_steps", self.basis_age)
        # the solver (static per run, emitted with the cadence gauges so
        # refresh-latency series segment by solver)
        tel.set_gauge(
            "kfac/solver",
            {"rsvd": 1, "streaming": 2}.get(getattr(self.kfac, "solver", "eigh"), 0),
        )
        tel.set_gauge("kfac/solver_rank", getattr(self.kfac, "solver_rank", 0))
        # the overlap plane's wire mode (0 serial, 1 fused, 2 ring), capture
        # steps of statistics waiting unmerged, and the eigen swap's slip
        tel.set_gauge("kfac/overlap_mode", getattr(comm, "overlap_mode", 0) if comm else 0)
        tel.set_gauge("kfac/staleness_age_steps", self._since_flush)
        tel.set_gauge("kfac/eigen_swap_slip", self._swap_slip)
        if streaming:
            # the last host-read residual mass (-1 until a wired signal was
            # consulted), the re-orthonormalizations so far, the basis age
            tel.set_gauge(
                "kfac/stream_residual_mass",
                -1.0 if self._stream_signal is None else self._stream_signal,
            )
            tel.set_gauge("kfac/stream_reorth_count", self._reorth_count)
            tel.set_gauge("kfac/stream_basis_age_steps", self.basis_age)
        if service:
            # the carved workers, the version of the basis preconditioning
            # now and how late it was installed
            tel.set_gauge("kfac/service_worker_count", int(self.kfac.service_devices))
            tel.set_gauge("kfac/basis_version", self._basis_version)
            tel.set_gauge("kfac/basis_staleness_steps", self._basis_slip)

    def _flush_flag(self, flags, step, chunk, boundary, every_boundary, budget, slipping, comm):
        """The deferred factor flush of ``step`` into ``flags``: forced
        before eigen work reads the factors (a refresh, chunk 0; with
        ``every_boundary``, under streaming or the curvature service, every
        boundary, so the fold's input never depends on the drift verdict and
        the published snapshot is merged), due every ``comm_freq``-th capture
        step, and a due flush slipped under pressure within the staleness
        budget."""
        forced = flags["update_eigen"] or chunk == 0 or (every_boundary and boundary)
        due = comm.flush_due(step, self.kfac.hparams.fac_update_freq)
        flush = forced or due
        if budget > 0 and not forced:
            if self._flush_owed:
                self._flush_slip += 1
                if flags["update_factors"] and not (slipping and self._flush_slip < budget):
                    # catch-up on a capture step once the pressure drops or
                    # the budget runs out
                    flush = True
                    get_trace().event(
                        "cadence_flush_catchup", step=int(step), slip=int(self._flush_slip)
                    )
            elif due and slipping:
                # withhold a due flush under pressure
                flush = False
                self._flush_owed = True
                self._flush_slip = 1
                get_trace().event("cadence_flush_slipped", step=int(step), slip=1)
        if forced and flush:
            get_trace().event("cadence_flush_forced", step=int(step))
        if flush:
            self._flush_owed = False
            self._flush_slip = 0
            self._since_flush = 0
        elif flags["update_factors"]:
            self._since_flush += 1
        flags["flush_factors"] = flush
