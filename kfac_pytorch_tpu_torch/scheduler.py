"""KFACParamScheduler: epoch-keyed multiplicative hyperparameter schedules.

Port of ``kfac_pytorch_tpu/scheduler.py::KFACParamScheduler``: StepLR-like
multiplicative decay of damping and of the factor / preconditioner update
frequencies, mutating the preconditioner's host-side ``KFACHParams``.
"""

from __future__ import annotations

from typing import List, Optional

from kfac_pytorch_tpu_torch.preconditioner import KFAC, KFACHParams


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
