"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says otherwise.

    ``None`` means ``"cuda"``. Asking for CUDA on a machine without a GPU
    raises: the port never drops to the CPU on its own, so a CPU run is
    always one the caller asked for (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU (its kernels then take their plain PyTorch "
            "versions)"
        )
    return dev


def use_ieee_f32() -> None:
    """Turn off TF32 in cuDNN convolutions and cuBLAS matmuls.

    The JAX reference computes factor statistics at full float32
    (``Precision.HIGHEST``); cuDNN's TF32 default keeps ~3 decimal digits
    and would silently change the statistics the eigendecompositions see.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
