"""Kronecker factor statistics (A = input covariance, G = grad-output covariance).

Port of ``kfac_pytorch_tpu/ops/factors.py`` (the conv/dense subset of the
main path). The math is the reference's; the layouts are PyTorch's:

* activations and output-grads are NCHW, conv weights OIHW
  ``[out, in, kh, kw]``, dense weights ``[out, in]``;
* the factor-space gradient matrix is ``[out, in*kh*kw (+1 bias)]`` with
  channel-major ``(c, kh, kw)`` columns, which is exactly the column order
  of ``F.unfold`` and of ``weight.reshape(out, -1)``, so factor matrices
  compare with the JAX package's as they are.

Every matmul here is a plain float32 library product (the entry points turn
TF32 off, ``device.use_ieee_f32``), matching the reference's
``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def _as_pairs(padding: Padding) -> Padding:
    """Normalize int / int-pair padding into ``((top, bottom), (left, right))``."""
    if isinstance(padding, str):
        return padding
    pairs = []
    for p in padding:
        if isinstance(p, int):
            pairs.append((p, p))
        else:
            pairs.append(tuple(p))
    return tuple(pairs)


def resolve_padding(
    h: int,
    w: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    dilation: Tuple[int, int],
):
    """Explicit pad pairs + output spatial dims, XLA conv semantics.

    SAME follows ``lax.padtype_to_pads``: out = ceil(in/stride), total pad =
    max((out-1)·stride + effective_window - in, 0), the extra pixel on the
    high side — the window grid the JAX package's patches see.
    """
    eff = tuple((k - 1) * d + 1 for k, d in zip(kernel_size, dilation))
    if isinstance(padding, str):
        pt = padding.upper()
        if pt == "VALID":
            pads = ((0, 0), (0, 0))
        elif pt == "SAME":
            pads = []
            for size, k_eff, s in zip((h, w), eff, strides):
                out = -(-size // s)
                total = max((out - 1) * s + k_eff - size, 0)
                pads.append((total // 2, total - total // 2))
            pads = tuple(pads)
        else:
            raise ValueError(f"unsupported padding string: {padding!r}")
    else:
        pads = _as_pairs(padding)
    oh = (h + pads[0][0] + pads[0][1] - eff[0]) // strides[0] + 1
    ow = (w + pads[1][0] + pads[1][1] - eff[1]) // strides[1] + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"empty conv output for input {(h, w)} with kernel={kernel_size} "
            f"strides={strides} padding={pads} dilation={dilation}"
        )
    return pads, oh, ow


def extract_patches(
    x: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> Tuple[torch.Tensor, int, int]:
    """im2col: ``[B, C, H, W] -> ([B, OH*OW, C*kh*kw], OH, OW)``.

    Features are channel-major ``(c, kh, kw)`` (``F.unfold``'s order).
    Asymmetric pads are applied with ``F.pad`` first, since ``F.unfold``
    pads symmetrically only.
    """
    pads, oh, ow = resolve_padding(
        x.shape[2], x.shape[3], tuple(kernel_size), tuple(strides), padding,
        tuple(kernel_dilation),
    )
    xp = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    cols = F.unfold(
        xp, tuple(kernel_size), dilation=tuple(kernel_dilation),
        stride=tuple(strides),
    )
    return cols.transpose(1, 2), oh, ow


def _flatten_leading(x: torch.Tensor) -> torch.Tensor:
    """``[..., d] -> [N, d]`` — dense layers may see [B, d] or [B, T, d]."""
    return x.reshape(-1, x.shape[-1])


def compute_a_dense(a: torch.Tensor, has_bias: bool) -> torch.Tensor:
    """Input covariance for a dense layer: ``A = aᵀ (a / N)`` (+ ones column)."""
    a = _flatten_leading(a)
    n = a.shape[0]
    if has_bias:
        a = torch.cat([a, a.new_ones((n, 1))], dim=1)
    return a.T @ (a / n)


def compute_a_conv(
    a: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Input covariance for a conv layer from NCHW activations (the oracle).

    Patch-extract, append the bias column BEFORE the ``1/spatial`` divide
    (so its entries are ``1/spatial``), then ``A = pᵀ (p / B)`` with B the
    batch size; the sum runs over ``B·OH·OW`` rows.
    """
    batch_size = a.shape[0]
    patches, oh, ow = extract_patches(a, kernel_size, strides, padding, kernel_dilation)
    spatial_size = oh * ow
    p = patches.reshape(-1, patches.shape[-1])
    if has_bias:
        p = torch.cat([p, p.new_ones((p.shape[0], 1))], dim=1)
    p = p / spatial_size
    return p.T @ (p / batch_size)


def compute_g_dense(g: torch.Tensor, batch_averaged: bool) -> torch.Tensor:
    """Grad-output covariance for a dense layer: ``gᵀ(g·N)`` or ``gᵀ(g/N)``."""
    g = _flatten_leading(g)
    n = g.shape[0]
    if batch_averaged:
        return g.T @ (g * n)
    return g.T @ (g / n)


def compute_g_conv(g: torch.Tensor, batch_averaged: bool) -> torch.Tensor:
    """Grad-output covariance for a conv layer from NCHW output-grads.

    ``[B, C, OH, OW] -> [B·OH·OW, C]``, rescale (×B if batch-averaged,
    ×spatial always), then ``G = gᵀ (g / rows)``.
    """
    batch_size = g.shape[0]
    spatial_size = g.shape[2] * g.shape[3]
    gm = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
    if batch_averaged:
        gm = gm * batch_size
    gm = gm * spatial_size
    return gm.T @ (gm / gm.shape[0])


def update_running_avg(
    new: torch.Tensor, current: torch.Tensor, alpha: float
) -> torch.Tensor:
    """EMA with ``alpha`` weight on history: ``alpha·current + (1-alpha)·new``.

    The reference CODE's semantics (not its docstring); returns a new tensor.
    """
    return alpha * current + (1.0 - alpha) * new


# ---------------------------------------------------------------------------
# Factor-space <-> parameter-space reshapes
# ---------------------------------------------------------------------------


def conv_kernel_to_mat(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight ``[out, in, kh, kw] -> [out, in*kh*kw]`` (channel-major)."""
    return weight.reshape(weight.shape[0], -1)


def mat_to_conv_kernel(mat: torch.Tensor, weight_shape) -> torch.Tensor:
    """Inverse of :func:`conv_kernel_to_mat`."""
    return mat.reshape(tuple(weight_shape))


def grads_to_mat(layer_grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Layer grad dict ``{'weight': ..., 'bias'?: ...}`` → ``[out, in(+1)]``.

    Conv weights flatten channel-major; a bias grad becomes the final column.
    """
    weight = layer_grads["weight"]
    if weight.dim() == 4:
        mat = conv_kernel_to_mat(weight)
    elif weight.dim() == 2:
        mat = weight
    else:
        raise ValueError(f"unsupported weight rank: {tuple(weight.shape)}")
    if layer_grads.get("bias") is not None:
        mat = torch.cat([mat, layer_grads["bias"].reshape(-1, 1)], dim=1)
    return mat


def mat_to_grads(mat: torch.Tensor, weight_shape, has_bias: bool) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`grads_to_mat`; returns contiguous tensors."""
    if has_bias:
        weight_mat, bias_col = mat[:, :-1], mat[:, -1]
    else:
        weight_mat, bias_col = mat, None
    out = {"weight": weight_mat.reshape(tuple(weight_shape)).contiguous()}
    if bias_col is not None:
        out["bias"] = bias_col.contiguous()
    return out
