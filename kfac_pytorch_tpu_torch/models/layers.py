"""K-FAC-aware layers: ``nn.Conv2d`` / ``nn.Linear`` subclasses.

Port of ``KFACConv`` and ``KFACDense`` from ``kfac_pytorch_tpu/models/
layers.py``. The JAX layers compute and ``sow`` their own statistics
because JAX has no hooks; here the layers are plain PyTorch modules that
mark themselves as preconditionable, and ``capture.py`` attaches forward
and backward hooks to them — the reference's own design. Grouped convs
(``groups > 1``) are the ImageNet slice's work (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch.nn as nn


class KFACConv(nn.Conv2d):
    """2-D convolution (NCHW/OIHW) that K-FAC preconditions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1:
            raise NotImplementedError(
                "grouped KFACConv (groups > 1) is not ported yet (ROADMAP "
                "queue 1 item 5, ImageNet path)"
            )
        if self.padding_mode != "zeros":
            raise NotImplementedError(
                f"KFACConv supports zero padding only, got {self.padding_mode!r}"
            )

    def factor_padding(self) -> Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]:
        """This conv's padding in the factor functions' form."""
        if isinstance(self.padding, str):
            return self.padding.upper()
        ph, pw = self.padding
        return ((ph, ph), (pw, pw))


class KFACDense(nn.Linear):
    """Dense layer (``y = x Wᵀ + b``) that K-FAC preconditions."""
