"""Warmup micro-autotune glue shared by the trainers (``--autotune-steps``).

Port of the JAX package's ``examples/_autotune.py``. The planner's
``autotune()`` times candidate plans through a ``measure(plan, steps)``
callback; this module owns the callback: build a fresh model, K-FAC,
state and train step for the candidate (the trainer's own ``build``, so
the timings are honest), run one capture step and one plain step untimed
(they build the kernels), then time ``steps`` plain steps plus one
capture step, the per-step surface every lever changes. On the card the
window is timed with CUDA events after a synchronize; on the CPU with the
host clock. The eigen refresh is not timed: the analytic model prices it
best, and refreshing under ``eigh_chunks`` would drag the chunk cadence
into warmup. A candidate's model and K-FAC state are dropped before the
next is built.

Several processes: every one runs every candidate (the timed steps carry
collectives), then they agree on rank 0's winner through ``broadcast``, so
host-local timing jitter cannot pin two plans.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch import planner

_CAPTURE = {"update_factors": True, "update_eigen": False}
_PLAIN = {"update_factors": False, "update_eigen": False}


def time_steps(step_fn, state, batch, lr: float, damping: float, steps: int,
               device: torch.device) -> float:
    """Seconds of ``steps`` plain steps and one capture step of ``step_fn``
    from ``state``, after one untimed step of each kind."""
    state, _ = step_fn(state, batch, lr, damping, **_CAPTURE)
    state, _ = step_fn(state, batch, lr, damping, **_PLAIN)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step_fn(state, batch, lr, damping, **_PLAIN)
    state, _ = step_fn(state, batch, lr, damping, **_CAPTURE)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return time.perf_counter() - t0


def autotune_kfac(
    kfac,
    build: Callable[[planner.Plan], tuple],
    batch,
    lr: float,
    steps: int,
    device: torch.device,
    broadcast: Callable = lambda x: x,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[Optional[planner.Plan], Optional[planner.AutotuneReport]]:
    """Time the candidate plans of ``kfac``'s resolved plan; return the
    winning plan and the report, or ``(None, None)`` when autotuning is
    off, ``kfac`` has no plan or the candidate list holds one plan.

    ``build(plan)`` returns a fresh ``(kfac, state, train_step)`` whose
    ``KFAC`` was built with ``profile=plan``.
    """
    if kfac is None or kfac.plan is None or steps <= 0:
        return None, None
    candidates = planner.candidate_plans(kfac.plan, kfac.plan_env)
    if len(candidates) < 2:
        return None, None

    def measure(plan, n):
        k, state, step_fn = build(plan)
        seconds = time_steps(step_fn, state, batch, lr, k.hparams.damping, n, device)
        del k, state, step_fn
        return seconds

    report = planner.autotune(candidates, measure, steps=steps)
    winner = candidates[int(broadcast(report.winner_index))]
    if log is not None:
        timings = " ".join(f"{t * 1e3:.1f}ms" for t in report.timings_s)
        log(
            f"autotune: {len(candidates)} candidates x {steps} steps "
            f"[{timings}] -> winner {candidates.index(winner)}: {winner.describe()}"
        )
    return winner, report
