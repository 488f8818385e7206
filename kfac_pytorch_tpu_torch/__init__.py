"""kfac_pytorch_tpu_torch: the PyTorch/CUDA port of ``kfac_pytorch_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module layout (``ops/``, ``models/``, ``capture.py``, ``preconditioner.py``,
``scheduler.py``, ``training/``, ``observability/``) so each function has a findable
counterpart. It imports ``torch`` and never JAX or the JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``; a
run that asks for no device and finds no GPU raises instead of dropping to
the CPU (:func:`kfac_pytorch_tpu_torch.device.resolve_device`). The
hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/kernel_build.py``).
"""

from kfac_pytorch_tpu_torch.preconditioner import KFAC, KFACHParams
from kfac_pytorch_tpu_torch.scheduler import EigenRefreshCadence, KFACParamScheduler

__all__ = ["EigenRefreshCadence", "KFAC", "KFACHParams", "KFACParamScheduler"]
