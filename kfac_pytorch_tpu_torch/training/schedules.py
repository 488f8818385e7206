"""Learning-rate schedules (port of ``kfac_pytorch_tpu/training/schedules.py``)."""

from __future__ import annotations

from typing import Callable, Sequence


def create_lr_schedule(
    workers: int,
    warmup_epochs: float,
    decay_schedule: Sequence[int],
    alpha: float = 0.1,
) -> Callable[[float], float]:
    """Returns ``epoch (float) -> lr factor``: linear warmup of the factor
    from 1/workers to 1 over ``warmup_epochs``, then ×``alpha`` at each epoch
    of ``decay_schedule``. The caller multiplies by ``base_lr × workers``."""
    decay = sorted(decay_schedule)

    def lr_factor(epoch: float) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return 1.0 / workers + (1.0 - 1.0 / workers) * (epoch / warmup_epochs)
        f = 1.0
        for e in decay:
            if epoch >= e:
                f *= alpha
        return f

    return lr_factor
