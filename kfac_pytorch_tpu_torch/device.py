"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


# precond_precision names, as the JAX package takes them (lax.Precision)
PRECOND_PRECISIONS = ("default", "high", "highest")


def resolve_precond_precision(precision: Optional[str]) -> Optional[str]:
    """Validate ``precond_precision``: ``None`` or one of
    :data:`PRECOND_PRECISIONS` (any case), returned lower-cased."""
    if precision is None:
        return None
    name = str(precision).lower()
    if name not in PRECOND_PRECISIONS:
        raise ValueError(
            f"Invalid precond_precision: {precision!r} (choose from "
            f"{PRECOND_PRECISIONS} or None)"
        )
    return name


@contextlib.contextmanager
def rotation_precision(precision: Optional[str]) -> Iterator[None]:
    """The matmul precision of the dense eigenbasis rotations (and the
    inverse method's products) inside the block, restored after it.

    The JAX package's ``precond_precision`` maps onto the card as follows:

    * ``None``, ``"highest"`` and ``"high"``: IEEE float32, what
      :func:`use_ieee_f32` sets. cuBLAS has no 3-pass (3xTF32) float32
      route, and IEEE float32 is at least as exact as the TPU's 3-pass
      bf16 ``HIGH``;
    * ``"default"``: one TF32 pass (10 mantissa bits per operand, float32
      accumulation), for these products only. Its bound: each rotation's
      entries within ~2^-10 relative of the float32 product per operand
      rounding, so an update within ~1e-2 relative of the IEEE one after
      the four rotations and the damped divide (``chip_smoke.py`` holds the
      card to it).

    On the CPU all three names compute in float32 (the flag is the CUDA
    matmul's), as the JAX package's names do on the CPU.
    """
    if precision != "default":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
