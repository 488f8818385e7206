"""The train step's variant budget and the recompile monitor.

Port of ``kfac_pytorch_tpu/compile_cache.py`` (``expected_step_variants``,
``RecompileMonitor``). The JAX trainers compile one program per distinct
set of the step's static flags; the port's counterpart is
``training.graphs.GraphedTrainStep``, which captures one CUDA graph per
such set (and per batch shape). :func:`expected_step_variants` budgets
that count exactly, by replaying the same host-side cadence
(``scheduler.EigenRefreshCadence``) the trainers drive the step with, and
:class:`RecompileMonitor` turns any growth beyond it into the
``compile/retraces`` counter.

``enable_persistent_cache`` is not ported: it points XLA's on-disk
compilation cache at a directory, which exists only under JAX.
"""

from __future__ import annotations

import math
import types
from typing import Dict


def expected_step_variants(kfac, plan=None, autotune_candidates: int = 0) -> int:
    """The number of distinct step variants (flag sets) the standard
    schedules give a K-FAC train step: the budget the trainers hand to
    :meth:`RecompileMonitor.watch`.

    The count is exact: it replays ``scheduler.EigenRefreshCadence`` over
    two periods of the flag schedule past the bootstrap and counts the
    distinct sorted flag tuples (the key ``GraphedTrainStep`` captures
    under). ``plan`` (a ``planner.Plan``) budgets a plan before a KFAC is
    built with it: the cadence replays ``kfac``'s schedule hparams with the
    plan's levers in place. ``autotune_candidates`` reserves a plain and a
    capture variant for each candidate the warmup autotune times.

    A nonzero ``diag_warmup`` replays both phases on one cadence (the
    mid-run flip) and a fresh cadence past the warmup (a resume). With a
    ``staleness_budget`` and a chunked refresh shorter than
    ``kfac_update_freq``, the withheld-swap and bare-swap twins are
    budgeted; under ``solver="streaming"`` every ``update_eigen`` variant
    gets its eigen-off twin (a boundary whose drift skips the re-orth). The
    solver's truncation, the apply kernels and the int8 wire swap what a
    variant computes, never how many there are.
    """
    if kfac is None:
        return 1 + 2 * int(autotune_candidates)

    from kfac_pytorch_tpu_torch.observability import telemetry as _telemetry
    from kfac_pytorch_tpu_torch.scheduler import EigenRefreshCadence

    sim = kfac
    if plan is not None:
        comm = getattr(kfac, "factor_comm", None)
        multi = bool(comm is not None and comm.multi_device)
        sim = types.SimpleNamespace(
            hparams=kfac.hparams,
            diag_warmup=kfac.diag_warmup,
            eigh_chunks=int(plan.eigh_chunks),
            factor_comm=types.SimpleNamespace(
                defer=plan.factor_comm_freq > 1 and multi,
                comm_freq=int(plan.factor_comm_freq),
                # EigenRefreshCadence's flush test
                flush_due=lambda step, fac_freq, n=int(plan.factor_comm_freq): (
                    step % fac_freq == 0 and (step // fac_freq) % n == 0
                ),
            ),
            solver=plan.solver,
            solver_rank=plan.solver_rank,
            staleness_budget=int(getattr(plan, "staleness_budget", 0)),
            staleness_signal=None,
            stream_drift_threshold=float(getattr(plan, "stream_drift_threshold", 0.05)),
            stream_drift_signal=None,
            service_devices=int(getattr(plan, "service_devices", 0)),
        )

    hp = sim.hparams
    comm = getattr(sim, "factor_comm", None)
    comm_freq = (comm.comm_freq if comm.defer else 1) if comm is not None else 1
    # one period of the flag schedule (eigen boundaries, capture steps and
    # the deferred flush phase); two periods past the bootstrap show every
    # steady-state combination
    period = math.lcm(int(hp.kfac_update_freq), int(hp.fac_update_freq) * int(comm_freq))
    horizon = min(2 * period + int(hp.kfac_update_freq) + 1, 20000)

    variants = set()

    def replay(cadence, start, steps, epoch):
        for s in range(start, start + steps):
            variants.add(tuple(sorted(cadence.flags_for_step(s, epoch=epoch).items())))
        return start + steps

    # the replay is a simulation: keep it off the cadence's real gauges
    tel = _telemetry.get_telemetry()
    prev_enabled = tel.enabled
    tel.enabled = False
    try:
        warm_epoch = sim.diag_warmup
        cadence = EigenRefreshCadence(sim)
        if sim.diag_warmup > 0:
            nxt = replay(cadence, 0, horizon, epoch=0)
            replay(cadence, nxt, horizon, epoch=warm_epoch)
            replay(EigenRefreshCadence(sim), 0, horizon, epoch=warm_epoch)
        else:
            replay(cadence, 0, horizon, epoch=warm_epoch)
    finally:
        tel.enabled = prev_enabled

    # the staleness slip's swap twins: the last chunk with its swap
    # withheld, and the bare swap on a later chunk-free step (a slipped
    # flush reuses existing variants)
    budget = int(getattr(sim, "staleness_budget", 0) or 0)
    k_eff = max(1, min(int(getattr(sim, "eigh_chunks", 1) or 1), int(hp.kfac_update_freq)))
    if budget > 0 and 1 < k_eff < int(hp.kfac_update_freq):
        extra = set()
        for key in variants:
            flags = dict(key)
            if flags.get("swap_eigen") and "eigen_chunk" in flags:
                extra.add(tuple(sorted({**flags, "swap_eigen": False}.items())))
            if ("eigen_chunk" not in flags and not flags.get("update_eigen")
                    and not flags.get("swap_eigen")):
                extra.add(tuple(sorted({**flags, "swap_eigen": True}.items())))
        variants |= extra

    # streaming: a boundary whose drift stays under the threshold folds
    # instead of re-orthonormalizing
    if getattr(sim, "solver", "eigh") == "streaming":
        variants |= {
            tuple(sorted({**dict(key), "update_eigen": False}.items()))
            for key in variants if dict(key).get("update_eigen")
        }

    return len(variants) + 2 * int(autotune_candidates)


class RecompileMonitor:
    """Watch compiled step callables for cache growth beyond their budget.

    ``watch(name, fn, expected_variants)`` registers a callable that has a
    ``_cache_size()`` (a ``training.graphs.GraphedTrainStep``: its
    captured graphs); any other callable, such as an eager step, is
    skipped, as the JAX monitor skips one that is not jitted. ``check()``,
    cheap enough for once an epoch, mirrors each size into the
    ``compile/cache_size/<name>`` gauge, bumps ``compile/retraces`` once
    per new variant over budget, and returns ``{name: excess}``.
    """

    def __init__(self, telemetry=None):
        if telemetry is None:
            from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry

            telemetry = get_telemetry()
        self._telemetry = telemetry
        self._watched: Dict[str, tuple] = {}
        self._reported: Dict[str, int] = {}

    def watch(self, name: str, fn, expected_variants: int = 1) -> None:
        """Track ``fn``, whose schedule legitimately makes
        ``expected_variants`` variants; a callable with no ``_cache_size``
        is skipped."""
        if not hasattr(fn, "_cache_size"):
            return
        self._watched[name] = (fn, int(expected_variants))
        self._reported.setdefault(name, 0)

    def check(self) -> Dict[str, int]:
        """``{name: variants over budget}`` for the watched callables over
        their budget; each new excess bumps ``compile/retraces``."""
        excess: Dict[str, int] = {}
        for name, (fn, budget) in self._watched.items():
            try:
                size = int(fn._cache_size())
            except Exception:
                continue
            self._telemetry.set_gauge(f"compile/cache_size/{name}", size)
            over = max(0, size - budget)
            new = over - self._reported[name]
            if new > 0:
                self._telemetry.inc("compile/retraces", new)
                self._reported[name] = over
            if over:
                excess[name] = over
        return excess
