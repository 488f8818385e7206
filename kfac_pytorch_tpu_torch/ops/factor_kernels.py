"""Conv A factors without im2col: the CUDA patch-covariance kernel.

Port of ``kfac_pytorch_tpu/ops/factor_kernels.py`` for the main path
(groups = 1 convs). :func:`compute_a_conv_fused` is the kernel's wrapper:

* a CUDA tensor launches ``csrc/patch_cov.cu`` (it replaces the TPU kernel
  ``compute_a_conv_fused`` → ``_patch_cov_pallas`` → ``_patch_cov_kernel``;
  the source says what bounds it and how its design answers that), or
  raises — there is no fallback;
* a CPU tensor takes :func:`compute_a_conv_fused_plain`, the same function
  in plain PyTorch: raw ``PᵀP`` sums with the bias column folded in as a
  ones feature, scaled once by ``1/(spatial²·B)`` at the end — the kernel's
  arithmetic, not the oracle's divide-first order.

``compute_a_conv_fused.launches`` counts kernel launches (CUDA calls only).

Routing (:func:`dispatch_compute_a_conv`): ``"dense"`` is the im2col
oracle ``ops/factors.py::compute_a_conv``, kept as the explicit option the
JAX package also has; ``"auto"`` (the default) always goes through the
kernel wrapper; ``"kernel"`` insists on the kernel and refuses a CPU tensor.
The JAX package routes through an ambient scope; here the kind is an
argument, held by the capture hooks.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from kfac_pytorch_tpu_torch.ops import factors, kernel_build
from kfac_pytorch_tpu_torch.ops.factors import resolve_padding as _resolve_padding

Padding = Union[str, Sequence[Tuple[int, int]]]

FACTOR_KERNELS = ("auto", "kernel", "dense")

_TILE = 64  # output tile side of csrc/patch_cov.cu
_DEPTH = 16  # patch rows per stage of csrc/patch_cov.cu


def resolve_factor_kernel(kind: str, device: torch.device) -> str:
    """Validate ``kind``; ``"kernel"`` needs a CUDA device."""
    if kind not in FACTOR_KERNELS:
        raise ValueError(
            f"Invalid factor_kernel: {kind!r} (choose from {FACTOR_KERNELS})"
        )
    if kind == "kernel" and torch.device(device).type != "cuda":
        raise ValueError(
            "factor_kernel='kernel' launches the CUDA patch-covariance "
            f"kernel and needs a CUDA device, got {device}; use 'auto' (the "
            "plain PyTorch version on CPU tensors) or 'dense'"
        )
    return kind


def compute_a_conv_fused_plain(
    a: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Plain PyTorch version of the patch-covariance kernel.

    ``Σ_rows P'ᵀP'`` with the bias as a ones feature, times
    ``1/(spatial²·B)``; the same function as the oracle up to float32
    summation order.
    """
    b = a.shape[0]
    patches, oh, ow = factors.extract_patches(
        a.float(), kernel_size, strides, padding, kernel_dilation
    )
    p = patches.reshape(-1, patches.shape[-1])
    if has_bias:
        p = torch.cat([p, p.new_ones((p.shape[0], 1))], dim=1)
    spatial = oh * ow
    scale = 1.0 / (float(spatial) ** 2 * float(b))
    return (p.T @ p) * scale


def compute_a_conv_fused(
    a: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Drop-in for ``factors.compute_a_conv`` minus the im2col temporary.

    ``a``: NCHW activations. CUDA tensors run ``csrc/patch_cov.cu``; CPU
    tensors the plain version. Returns ``[F(+1), F(+1)]`` float32.
    """
    if a.device.type == "cpu":
        return compute_a_conv_fused_plain(
            a, kernel_size, strides, padding, has_bias, kernel_dilation
        )
    if a.device.type != "cuda":
        raise ValueError(f"compute_a_conv_fused: unsupported device {a.device}")
    if a.dtype != torch.float32 or a.dim() != 4:
        raise ValueError(
            "compute_a_conv_fused: the CUDA kernel takes float32 NCHW "
            f"activations, got {a.dtype} {tuple(a.shape)}"
        )
    a = a.contiguous()
    b, c, h, w = a.shape
    kernel_size, strides = tuple(kernel_size), tuple(strides)
    kernel_dilation = tuple(kernel_dilation)
    pads, oh, ow = _resolve_padding(h, w, kernel_size, strides, padding, kernel_dilation)
    fp = c * kernel_size[0] * kernel_size[1] + int(has_bias)
    n_t = -(-fp // _TILE)
    tiles = n_t * (n_t + 1) // 2
    rows = b * oh * ow
    # enough blocks to fill the card several times over, but at least a few
    # stages of rows per split
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(-(-4 * sms // tiles), -(-rows // (8 * _DEPTH))))
    rows_per_split = -(-rows // splits)
    rows_per_split = -(-rows_per_split // _DEPTH) * _DEPTH
    splits = -(-rows // rows_per_split)
    side = n_t * _TILE
    part = torch.empty((splits, side, side), dtype=torch.float32, device=a.device)
    out = torch.empty((fp, fp), dtype=torch.float32, device=a.device)
    scale = 1.0 / (float(oh * ow) ** 2 * float(b))
    lib = kernel_build.load("patch_cov")
    err = lib.kfac_patch_cov(
        a.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, c, h, w, kernel_size[0], kernel_size[1], strides[0], strides[1],
        pads[0][0], pads[1][0], kernel_dilation[0], kernel_dilation[1],
        oh, ow, int(has_bias), splits, rows_per_split, scale,
        kernel_build.current_stream_handle(a.device),
    )
    kernel_build.check(err, "patch_cov")
    compute_a_conv_fused.launches += 1
    return out


compute_a_conv_fused.launches = 0


def dispatch_compute_a_conv(
    a: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
    *,
    kind: str = "auto",
) -> torch.Tensor:
    """Route one conv layer's A contribution: oracle or kernel wrapper."""
    resolve_factor_kernel(kind, a.device)
    a = a.detach()
    if kind == "dense":
        return factors.compute_a_conv(
            a, kernel_size, strides, padding, has_bias, kernel_dilation
        )
    return compute_a_conv_fused(
        a, kernel_size, strides, padding, has_bias, kernel_dilation
    )
