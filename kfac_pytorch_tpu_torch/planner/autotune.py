"""Warmup micro-autotune: time 2–3 candidate plans, pin the winner.

Port of ``kfac_pytorch_tpu/planner/autotune.py``. The cost model is
analytic — it knows MAC counts and bytes, not what the card actually
overlaps. The
autotuner closes that gap empirically without a search: it times the
resolved plan against at most two principled fallbacks (the same plan
with the risky levers off, and the all-defaults safe plan) for a handful
of warmup steps each, then pins the strict winner for the rest of the
run.

Determinism: candidates are an ordered, deduplicated list; the winner is
the strict minimum of the measured times with ties broken toward the
EARLIER candidate (the cost model's preference), so identical timings on
every host pick identical plans. The trainers time candidates before the
real step counter starts (``examples/autotune.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.planner.profiles import Plan, PlanEnv, fit_plan

#: default warmup steps timed per candidate (CLI: --autotune-steps)
DEFAULT_AUTOTUNE_STEPS = 3


def candidate_plans(plan: Plan, env: PlanEnv) -> List[Plan]:
    """The ordered candidate list for a resolved plan.

    1. the resolved plan itself (cost-model preference — wins ties);
    2. the same plan with the two *numerics-adjacent* levers off
       (dense solver, monolithic refresh) — the fallback when truncation
       or pipelining scheduling costs more than it saves;
    3. the all-defaults safe plan.

    Deduplicated preserving order, so an already-safe plan yields one
    candidate and autotuning degenerates to a no-op.
    """
    conservative = dataclasses.replace(
        plan, solver="eigh", eigh_chunks=1
    )
    conservative, _ = fit_plan(conservative, env)
    out: List[Plan] = []
    for cand in (plan, conservative, Plan()):
        if cand not in out:
            out.append(cand)
    return out


@dataclasses.dataclass(frozen=True)
class AutotuneReport:
    """What the autotuner measured and picked."""

    candidates: Tuple[Plan, ...]
    timings_s: Tuple[float, ...]
    winner_index: int
    steps_per_candidate: int

    @property
    def winner(self) -> Plan:
        return self.candidates[self.winner_index]


def autotune(
    candidates: Sequence[Plan],
    measure: Callable[[Plan, int], float],
    steps: int = DEFAULT_AUTOTUNE_STEPS,
    telemetry=None,
) -> AutotuneReport:
    """Time each candidate and pick the strict winner.

    ``measure(plan, steps)`` runs ``steps`` warmup steps under ``plan``
    and returns total seconds (the trainer owns how — on the card it times
    with CUDA events after a synchronize, so device work is included, and
    runs untimed steps first so kernel builds are excluded). Ties break toward
    the earlier candidate, so the result is a pure function of the
    measured times and every host that measures the same times pins the
    same plan. (Multi-host runs should measure on one host and broadcast,
    or rely on identical candidate order + a host-agreed tie-break.)
    """
    if not candidates:
        raise ValueError("autotune needs at least one candidate plan")
    if steps < 1:
        raise ValueError(f"autotune steps must be >= 1, got {steps}")
    timings = [float(measure(plan, steps)) for plan in candidates]
    winner = min(range(len(timings)), key=lambda i: (timings[i], i))
    tel = telemetry if telemetry is not None else get_telemetry()
    tel.set_gauge("kfac/autotune_candidates", float(len(candidates)))
    tel.set_gauge("kfac/autotune_winner", float(winner))
    tel.set_gauge("kfac/autotune_ms_best", timings[winner] * 1000.0)
    return AutotuneReport(
        candidates=tuple(candidates),
        timings_s=tuple(timings),
        winner_index=winner,
        steps_per_candidate=int(steps),
    )
