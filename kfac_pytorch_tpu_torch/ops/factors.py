"""Kronecker factor statistics (A = input covariance, G = grad-output covariance).

Port of ``kfac_pytorch_tpu/ops/factors.py`` (the conv, grouped conv, dense
and diagonal-A embedding subset, ``compute_g_diag`` for the tied decoder
head, the shard lenses' stacks (``compute_a_row_sharded``,
``compute_g_dense_sharded``, the MoE sums ``compute_a_moe``/
``compute_g_moe`` and the one-hot oracle ``compute_a_moe_onehot``), the
running average and the factor wire's bucket merge
``merge_running_avg_buckets``). The math is the reference's; the layouts
are PyTorch's:

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

from typing import Dict, List, Optional, Sequence, Tuple, Union

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


def compute_a_conv_grouped(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Stacked per-group input covariances of a grouped conv: ``[G, a, a]``.

    A conv with ``groups=G`` is G independent convs, each reading its own
    ``C/G`` input-channel slice, so its K-FAC approximation is G Kronecker
    pairs; cross-group blocks are never formed. The JAX oracle vmaps
    :func:`compute_a_conv` over the slices; here the groups ride the batch
    axis of one im2col and one batched product, with the same arithmetic
    per group.
    """
    b, c, h, w = a.shape
    xg = a.reshape(b, groups, c // groups, h, w).transpose(0, 1)
    patches, oh, ow = extract_patches(
        xg.reshape(groups * b, c // groups, h, w), kernel_size, strides,
        padding, kernel_dilation,
    )
    p = patches.reshape(groups, -1, patches.shape[-1])  # [G, B·OH·OW, F]
    if has_bias:
        p = torch.cat([p, p.new_ones(p.shape[:2] + (1,))], dim=2)
    p = p / (oh * ow)
    return p.transpose(1, 2) @ (p / b)


def compute_a_row_sharded(a: torch.Tensor, shards: int) -> torch.Tensor:
    """Per-shard input covariances of a ROW-sharded dense kernel:
    ``[T, a/T, a/T]``, each the covariance of one disjoint feature slice of
    the input (the shard lens, arxiv 2311.00636). No bias column (a
    row-sharded layer has none); scaled ``/N`` as :func:`compute_a_dense`."""
    a = _flatten_leading(a)
    n = a.shape[0]
    am = a.reshape(n, shards, a.shape[-1] // shards).transpose(0, 1)  # [T, N, a/T]
    return am.transpose(1, 2) @ (am / n)


def compute_a_moe(x: torch.Tensor, expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Per-expert UNNORMALIZED input-covariance sums ``[E, a, a]``: expert
    ``e``'s slot is ``(1/N)·Σ_{t: id_t=e} x_t x_tᵀ`` with the GLOBAL ``N``,
    so the sums stay linear in per-token contributions (the ranks' mean is
    exact) and the per-expert normalization waits for the EMA
    (``shardwise.moe_ema``). Each expert's rows are selected with an
    ``[N]`` boolean mask; the ``[N, E]`` one-hot is never formed."""
    x = _flatten_leading(x)
    ids = expert_ids.reshape(-1)
    n = x.shape[0]
    out = []
    for e in range(num_experts):
        xm = x * (ids == e)[:, None].to(x.dtype)
        out.append(xm.T @ (xm / n))
    return torch.stack(out)


def compute_a_moe_onehot(x: torch.Tensor, expert_ids: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """The dense one-hot oracle of :func:`compute_a_moe`: the ``[N, E]``
    dispatch one-hot is formed and each expert masks with its column, the
    same elementwise product, so the two are bitwise equal."""
    x = _flatten_leading(x)
    n = x.shape[0]
    onehot = F.one_hot(expert_ids.reshape(-1).long(), num_experts).to(x.dtype)
    out = []
    for e in range(num_experts):
        xm = x * onehot[:, e][:, None]
        out.append(xm.T @ (xm / n))
    return torch.stack(out)


def compute_a_embed(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Input-covariance DIAGONAL of an embedding layer: token frequencies.

    A lookup is a dense layer over one-hot rows, whose covariance is exactly
    ``diag(counts / N)``; the ``[vocab]`` vector is stored instead of the
    ``[vocab, vocab]`` matrix. A scatter-add of ones, then one float32
    division by ``N`` (by a device tensor: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which rounds differently).
    """
    flat = ids.reshape(-1)
    n = flat.numel()
    counts = torch.zeros(vocab, dtype=torch.float32, device=ids.device)
    counts.index_add_(0, flat.long(), torch.ones(n, dtype=torch.float32, device=ids.device))
    return counts / torch.full((), float(n), dtype=torch.float32, device=ids.device)


def compute_g_dense(g: torch.Tensor, batch_averaged: bool) -> torch.Tensor:
    """Grad-output covariance for a dense layer: ``gᵀ(g·N)`` or ``gᵀ(g/N)``."""
    g = _flatten_leading(g)
    n = g.shape[0]
    if batch_averaged:
        return g.T @ (g * n)
    return g.T @ (g / n)


def compute_g_diag(g: torch.Tensor, batch_averaged: bool) -> torch.Tensor:
    """DIAGONAL of the grad-output covariance, ``diag(gᵀg·s)``, without
    ``gᵀg``: the tied decoder head's ``[vocab]`` logit statistics, which join
    the shared table's diagonal A side (the reduce lens). The scale is
    :func:`compute_g_dense`'s (×N batch-averaged, /N otherwise)."""
    g = _flatten_leading(g)
    n = g.shape[0]
    scale = float(n) if batch_averaged else 1.0 / n
    return torch.sum(g * g, dim=0) * scale


def compute_g_dense_sharded(g: torch.Tensor, shards: int, batch_averaged: bool) -> torch.Tensor:
    """Per-shard grad-output covariances of a COLUMN-sharded dense kernel:
    ``[T, m/T, m/T]``. The shards' outputs are disjoint slices, so the G
    factor is exactly block-diagonal; one batched product, scaled as
    :func:`compute_g_dense` (×N batch-averaged, /N otherwise)."""
    g = _flatten_leading(g)
    n = g.shape[0]
    gm = g.reshape(n, shards, g.shape[-1] // shards).transpose(0, 1)  # [T, N, m/T]
    scale = float(n) if batch_averaged else 1.0 / n
    return gm.transpose(1, 2) @ (gm * scale)


def compute_g_moe(g: torch.Tensor, batch_averaged: bool) -> torch.Tensor:
    """Per-expert UNNORMALIZED grad-output covariance sums ``[E, m, m]``
    from the ``[.., E, m]`` gradient of the dense per-expert outputs,
    already expert-masked by the top-1 routing (a token's rows are zero for
    every expert it did not visit). Scaled over the GLOBAL token count as
    :func:`compute_g_dense`; the per-expert normalization waits for the EMA
    (see :func:`compute_a_moe`)."""
    g = g.reshape(-1, g.shape[-2], g.shape[-1]).transpose(0, 1)  # [E, N, m]
    n = g.shape[1]
    scale = float(n) if batch_averaged else 1.0 / n
    return g.transpose(1, 2) @ (g * scale)


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


def compute_g_conv_grouped(
    g: torch.Tensor, groups: int, batch_averaged: bool
) -> torch.Tensor:
    """Stacked per-group grad-output covariances: ``[G, cout/G, cout/G]``.

    Output channel ``k·(cout/G) + j`` belongs to group k, so the NCHW grad
    goes to ``[B·OH·OW, G, cout/G]`` once its channels move last; one
    batched contraction per layer, scaled as :func:`compute_g_conv` (×B if
    batch-averaged, ×spatial, then /rows).
    """
    batch_size = g.shape[0]
    spatial_size = g.shape[2] * g.shape[3]
    gm = g.permute(0, 2, 3, 1).reshape(-1, groups, g.shape[1] // groups)
    if batch_averaged:
        gm = gm * batch_size
    gm = gm * spatial_size
    gm = gm.transpose(0, 1)  # [G, rows, cout/G]
    return gm.transpose(1, 2) @ (gm / gm.shape[1])


def update_running_avg(
    new: torch.Tensor, current: torch.Tensor, alpha: float
) -> torch.Tensor:
    """EMA with ``alpha`` weight on history: ``alpha·current + (1-alpha)·new``.

    The reference CODE's semantics (not its docstring); returns a new tensor.
    """
    return alpha * current + (1.0 - alpha) * new


def merge_running_avg_buckets(
    bufs: Sequence[torch.Tensor], comm_dtype: Optional[torch.dtype], world
) -> List[torch.Tensor]:
    """The ranks' uniform-weight mean of each flat bucket (a
    ``parallel.mesh.World``'s ranks): one ``all_reduce`` per bucket, its
    payload in ``comm_dtype`` when given (each rank's value rounds once),
    each result back in its bucket's dtype; the inputs are not modified.

    Exact for the deferred factor flush because :func:`update_running_avg`
    is linear in its contributions: after ``m`` local updates from a synced
    ``F0`` rank ``r`` holds ``α^m·F0 + (1−α)·Σ_j α^(m−1−j)·c_j^(r)``, so the
    ranks' mean weighs step j's mean contribution as a per-step mean would
    have (DP-KFAC). In float32 the bucketed mean is elementwise what one
    mean per leaf gives: bitwise where the backend's sum is order-free (two
    ranks)."""
    out = []
    for buf in bufs:
        wire = buf.clone() if comm_dtype is None else buf.to(comm_dtype)
        world.all_reduce_sum_(wire)
        out.append(wire.div_(world.size).to(buf.dtype))
    return out


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
    An embedding's ``{'embedding': [vocab, d]}`` table becomes ``[d, vocab]``
    ("in" is the one-hot vocab axis; no bias).
    """
    if "embedding" in layer_grads:
        return layer_grads["embedding"].T
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
