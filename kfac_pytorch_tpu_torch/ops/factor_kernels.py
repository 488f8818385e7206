"""Factor-statistics kernels: conv A without im2col, embedding token counts.

Port of ``kfac_pytorch_tpu/ops/factor_kernels.py`` (convs, grouped convs,
embeddings). Three kernel wrappers, each with its plain PyTorch version
beside it and a launch counter (``fn.launches``, CUDA calls only):

* :func:`compute_a_conv_fused` — a CUDA tensor launches
  ``csrc/patch_cov.cu`` (replacing the TPU kernel ``compute_a_conv_fused``
  → ``_patch_cov_pallas`` → ``_patch_cov_kernel``; the source says what
  bounds it and how its design answers that: 3xTF32 on the tensor cores,
  the input staged in shared memory, a tile per geometry that
  :func:`patch_cov_route` reports; bfloat16 activations, under ``--bf16``
  compute, take its bf16 route, one exact bf16 MMA per product), or
  raises — there is no fallback. A
  CPU tensor takes :func:`compute_a_conv_fused_plain`, the same
  function in plain PyTorch: raw ``PᵀP`` sums with the bias column folded
  in as a ones feature, scaled once by ``1/(spatial²·B)`` at the end — the
  kernel's arithmetic, not the oracle's divide-first order.
* :func:`compute_a_conv_grouped_fused` — a grouped conv's stacked
  per-group A factors ``[G, a, a]`` through the same source, launched once
  with a group axis on its grid (replacing ``compute_a_conv_grouped_fused``,
  which calls the TPU kernel once per group);
  :func:`compute_a_conv_grouped_fused_plain` is kernel 1's plain version per
  channel slice, stacked.
* :func:`compute_a_embed_fused` — the embedding's diagonal A (token counts
  / N) through ``csrc/token_count.cu`` (replacing
  ``compute_a_embed_fused`` → ``_token_count_kernel``): one launch of one
  thread block cluster per 98,304 ids of vocabulary, no host sync; ids
  outside ``[0, V)`` are tallied on the device and raised by
  :func:`check_token_ids`. The plain version
  :func:`compute_a_embed_fused_plain` counts in integers and divides once.
  Both equal the oracle ``ops/factors.py::compute_a_embed`` bit for bit.
  An MoE layer's expert fractions are the same function with ``vocab = E``
  (:func:`dispatch_compute_a_moe`), launched through the same wrapper and
  counted on its counter.

Routing (:func:`dispatch_compute_a_conv`,
:func:`dispatch_compute_a_conv_grouped`, :func:`dispatch_compute_a_embed`,
:func:`dispatch_compute_a_moe`):
``"dense"`` is the oracle (``ops/factors.py``), kept as the explicit option
the JAX package also has; ``"auto"`` (the default) always goes through the
kernel wrapper; ``"kernel"`` insists on the kernel and refuses a CPU
tensor. The JAX package routes through an ambient scope; here the kind is
an argument, held by the capture hooks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple, Union

import torch

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import factors, kernel_build
from kfac_pytorch_tpu_torch.ops.factors import resolve_padding as _resolve_padding

Padding = Union[str, Sequence[Tuple[int, int]]]

FACTOR_KERNELS = ("auto", "kernel", "dense")


def _kernel_gauge(kind: str, t: torch.Tensor) -> float:
    """The JAX package's ``kfac/*_kernel`` gauge value: 1 when the
    dispatch runs the hand kernel (a CUDA tensor, ``kind`` not
    ``"dense"``), else 0."""
    return 1.0 if kind != "dense" and t.is_cuda else 0.0


def resolve_factor_kernel(kind: str, device: torch.device) -> str:
    """Validate ``kind``; ``"kernel"`` needs a CUDA device."""
    if kind not in FACTOR_KERNELS:
        raise ValueError(
            f"Invalid factor_kernel: {kind!r} (choose from {FACTOR_KERNELS})"
        )
    if kind == "kernel" and torch.device(device).type != "cuda":
        raise ValueError(
            "factor_kernel='kernel' launches the CUDA factor kernels and "
            f"needs a CUDA device, got {device}; use 'auto' (their plain "
            "PyTorch versions on CPU tensors) or 'dense'"
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
    summation order. bfloat16 activations are upcast first, as the JAX
    package upcasts them.
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


_PATCH_COV_TILES = ("48x48", "64x64", "128x128")
_PATCH_COV_WINDOWS = ("rows", "flat", "slab")


def _patch_cov_geometry(a, groups, kernel_size, strides, padding, has_bias,
                        kernel_dilation, what):
    """Check the CUDA tensor ``a`` and return the geometry arguments of
    ``csrc/patch_cov.cu``'s C entries, ``oh`` and ``ow``."""
    if a.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or a.dim() != 4:
        raise ValueError(
            f"{what}: the CUDA kernel takes float32 or bfloat16 NCHW "
            f"activations, got {a.dtype} {tuple(a.shape)}"
        )
    b, c, h, w = a.shape
    if groups < 1 or c % groups:
        raise ValueError(f"{what}: {c} channels do not split into {groups} groups")
    kernel_size, strides = tuple(kernel_size), tuple(strides)
    kernel_dilation = tuple(kernel_dilation)
    pads, oh, ow = _resolve_padding(h, w, kernel_size, strides, padding, kernel_dilation)
    geometry = (
        b, c, h, w, kernel_size[0], kernel_size[1], strides[0], strides[1],
        pads[0][0], pads[1][0], kernel_dilation[0], kernel_dilation[1],
        oh, ow, int(has_bias), groups, int(a.dtype == torch.bfloat16),
    )
    return geometry, oh, ow


# kfac_patch_cov_plan's answers, by device, x's alignment and geometry (x's
# type included)
_PATCH_COV_PLANS: Dict[Tuple[int, ...], ctypes.Array] = {}


def _patch_cov_plan(lib, a, geometry, what) -> ctypes.Array:
    """``kfac_patch_cov_plan``, asked once per geometry and input type:
    int[7] (tile, copy bytes, stage layout, splits, output rows and columns
    per stage, partial side), which ``kfac_patch_cov`` takes back."""
    key = (a.device.index, a.data_ptr() % 16) + geometry
    plan = _PATCH_COV_PLANS.get(key)
    if plan is None:
        plan = (ctypes.c_int * 7)()
        err = lib.kfac_patch_cov_plan(a.data_ptr(), *geometry, ctypes.addressof(plan))
        if err != 0:
            raise ValueError(
                f"{what}: no stage of this conv fits in shared memory (x "
                f"{tuple(a.shape)}, kernel {geometry[4:6]}, stride "
                f"{geometry[6:8]}, dilation {geometry[10:12]}, groups {geometry[15]})"
            )
        _PATCH_COV_PLANS[key] = plan
    return plan


def patch_cov_route(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> dict:
    """The plan ``csrc/patch_cov.cu`` takes for this conv input (a CUDA
    tensor, float32 or bfloat16: its route): the output tile, the copy
    width in bytes and whether the
    stage's window is a window of input rows (``"rows"``), each channel's
    contiguous rows (``"flat"``, a 1x1 stride-1 conv) or, where a flat
    stage is a whole image, the tile's channels as one slab (``"slab"``),
    the row splits, and the output rows and columns per stage (fewer
    columns than a row has where a whole row's window does not fit)."""
    a = a.contiguous()
    geometry, _, _ = _patch_cov_geometry(
        a, groups, kernel_size, strides, padding, has_bias, kernel_dilation,
        "patch_cov_route",
    )
    tile, copy, mode, splits, rows, cols, _ = _patch_cov_plan(
        kernel_build.load("patch_cov"), a, geometry, "patch_cov_route"
    )
    return {
        "route": "bf16" if a.dtype == torch.bfloat16 else "3xtf32",
        "tile": _PATCH_COV_TILES[tile],
        "copy": copy,
        "window": _PATCH_COV_WINDOWS[mode],
        "splits": splits,
        "stage_rows": rows,
        "stage_columns": cols,
        "stage_positions": rows * cols,
    }


def _launch_patch_cov(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int],
    what: str,
) -> torch.Tensor:
    """One launch of ``csrc/patch_cov.cu`` over all ``groups`` channel
    groups of the CUDA tensor ``a``: ``[groups, F', F']`` float32."""
    a = a.contiguous()
    geometry, oh, ow = _patch_cov_geometry(
        a, groups, kernel_size, strides, padding, has_bias, kernel_dilation, what
    )
    lib = kernel_build.load("patch_cov")
    plan = _patch_cov_plan(lib, a, geometry, what)
    splits, side = plan[3], plan[6]
    b, c = a.shape[:2]
    fp = c // groups * kernel_size[0] * kernel_size[1] + int(has_bias)
    part = torch.empty((splits, groups, side, side), dtype=torch.float32, device=a.device)
    out = torch.empty((groups, fp, fp), dtype=torch.float32, device=a.device)
    scale = 1.0 / (float(oh * ow) ** 2 * float(b))
    err = lib.kfac_patch_cov(
        a.data_ptr(), part.data_ptr(), out.data_ptr(), *geometry,
        ctypes.addressof(plan), scale, kernel_build.current_stream_handle(a.device),
    )
    kernel_build.check(err, "patch_cov")
    return out


def compute_a_conv_fused(
    a: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Drop-in for ``factors.compute_a_conv`` minus the im2col temporary.

    ``a``: NCHW activations, float32 or bfloat16. CUDA tensors run
    ``csrc/patch_cov.cu`` (its bf16 route for bfloat16); CPU tensors the
    plain version. Returns ``[F(+1), F(+1)]`` float32.
    """
    if a.device.type == "cpu":
        return compute_a_conv_fused_plain(
            a, kernel_size, strides, padding, has_bias, kernel_dilation
        )
    out = _launch_patch_cov(
        a, 1, kernel_size, strides, padding, has_bias, kernel_dilation,
        "compute_a_conv_fused",
    )
    compute_a_conv_fused.launches += 1
    compute_a_conv_fused.launches_bf16 += a.dtype == torch.bfloat16
    return out[0]


# every CUDA launch, and those of them on the bf16 route
compute_a_conv_fused.launches = 0
compute_a_conv_fused.launches_bf16 = 0


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
    """Route one conv layer's A contribution: oracle or kernel wrapper.
    bfloat16 activations go to the kernel wrapper as they are (its bf16
    route) and to the oracle upcast."""
    resolve_factor_kernel(kind, a.device)
    a = a.detach()
    tel = get_telemetry()
    tel.set_gauge("kfac/factor_kernel", _kernel_gauge(kind, a))
    with tel.span("trace/kfac/factor_kernel"):
        if kind == "dense":
            return factors.compute_a_conv(
                a.float(), kernel_size, strides, padding, has_bias, kernel_dilation
            )
        return compute_a_conv_fused(
            a, kernel_size, strides, padding, has_bias, kernel_dilation
        )


# ---------------------------------------------------------------------------
# Grouped convs: one A factor per channel group, one launch per layer
# ---------------------------------------------------------------------------


def compute_a_conv_grouped_fused_plain(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel: kernel 1's plain version
    on each ``C/G`` channel slice, stacked to ``[G, a, a]``."""
    cg = a.shape[1] // groups
    return torch.stack([
        compute_a_conv_fused_plain(
            a[:, k * cg:(k + 1) * cg], kernel_size, strides, padding,
            has_bias, kernel_dilation,
        )
        for k in range(groups)
    ])


def compute_a_conv_grouped_fused(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Drop-in for ``factors.compute_a_conv_grouped``: stacked per-group A
    factors ``[G, a, a]``, ``a = (C/G)·kh·kw (+1)``.

    CUDA tensors run ``csrc/patch_cov.cu`` once, with a group axis on its
    grid (the JAX version calls its kernel once per group); CPU tensors the
    plain version.
    """
    if a.device.type == "cpu":
        return compute_a_conv_grouped_fused_plain(
            a, groups, kernel_size, strides, padding, has_bias, kernel_dilation
        )
    out = _launch_patch_cov(
        a, groups, kernel_size, strides, padding, has_bias, kernel_dilation,
        "compute_a_conv_grouped_fused",
    )
    compute_a_conv_grouped_fused.launches += 1
    compute_a_conv_grouped_fused.launches_bf16 += a.dtype == torch.bfloat16
    return out


compute_a_conv_grouped_fused.launches = 0
compute_a_conv_grouped_fused.launches_bf16 = 0


def dispatch_compute_a_conv_grouped(
    a: torch.Tensor,
    groups: int,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    padding: Padding,
    has_bias: bool,
    kernel_dilation: Tuple[int, int] = (1, 1),
    *,
    kind: str = "auto",
) -> torch.Tensor:
    """Grouped-conv twin of :func:`dispatch_compute_a_conv`."""
    resolve_factor_kernel(kind, a.device)
    a = a.detach()
    tel = get_telemetry()
    tel.set_gauge("kfac/factor_kernel", _kernel_gauge(kind, a))
    with tel.span("trace/kfac/factor_kernel"):
        if kind == "dense":
            return factors.compute_a_conv_grouped(
                a.float(), groups, kernel_size, strides, padding, has_bias, kernel_dilation
            )
        return compute_a_conv_grouped_fused(
            a, groups, kernel_size, strides, padding, has_bias, kernel_dilation
        )


# ---------------------------------------------------------------------------
# Token counts: the embedding's diagonal A factor
# ---------------------------------------------------------------------------

TOKEN_CLUSTER = 8  # blocks of a thread block cluster of csrc/token_count.cu
TOKEN_MAX_BINS = 12288  # uint32 bins in one block's shared memory (48 KB)


def token_count_plan(vocab: int) -> Tuple[int, int]:
    """``(bins per block, clusters)`` of ``csrc/token_count.cu`` for a
    vocabulary of ``vocab``: cluster ``c``'s block ``r`` owns the ids
    ``[(c·8 + r)·bins, (c·8 + r + 1)·bins) ∩ [0, vocab)``, at most
    :data:`TOKEN_MAX_BINS` of them; as few clusters as cover the vocabulary,
    its ids spread evenly over their blocks."""
    if vocab < 1:
        raise ValueError(f"compute_a_embed_fused: vocab must be positive, got {vocab}")
    per_cluster = TOKEN_CLUSTER * TOKEN_MAX_BINS
    clusters = -(-vocab // per_cluster)
    bins = -(-vocab // (clusters * TOKEN_CLUSTER))
    return bins, clusters


# per device: int64[4] {ids outside [0, V) counted, V, least, greatest such id}
_TOKEN_TALLIES: Dict[int, torch.Tensor] = {}
_TALLY_EMPTY = (0, 0, 2 ** 63 - 1, -(2 ** 63))


def _flat_ids(ids: torch.Tensor) -> torch.Tensor:
    """Flattened integer ids, checked (on the host, from the shape) to count
    exactly in float32 (``0 < N < 2²⁴``)."""
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"compute_a_embed_fused: ids must be int32 or int64, got {ids.dtype}")
    flat = ids.reshape(-1)
    n = flat.numel()
    if n == 0 or n >= 1 << 24:
        raise ValueError(
            f"compute_a_embed_fused: {n} ids; the counts are exact float32 "
            "integers only for 0 < N < 2^24"
        )
    return flat


def _range_error(vocab: int, got: str) -> ValueError:
    return ValueError(f"compute_a_embed_fused: ids must lie in [0, {vocab}), got {got}")


def compute_a_embed_fused_plain(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Plain PyTorch version of the token-count kernel: integer counts, then
    one float32 division by ``N`` (by a device tensor, as the oracle)."""
    flat = ids.reshape(-1)
    counts = torch.zeros(vocab, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, flat.long(), torch.ones_like(flat, dtype=torch.int64))
    n = torch.full((), float(flat.numel()), dtype=torch.float32, device=ids.device)
    return counts.float() / n


def compute_a_embed_fused(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Drop-in for ``factors.compute_a_embed``: ``[vocab]`` float32 token
    frequencies of the integer ``ids`` (any shape).

    CUDA tensors run ``csrc/token_count.cu``: one launch, nothing for the
    host to wait on. An id outside ``[0, vocab)`` is counted nowhere and
    tallied on the device; :func:`check_token_ids` raises for it later. CPU
    tensors take the plain version, after an eager range check that raises
    at once.
    """
    flat = _flat_ids(ids)
    if ids.device.type == "cpu":
        lo, hi = torch.stack(torch.aminmax(flat)).tolist()
        if lo < 0 or hi >= vocab:
            raise _range_error(vocab, f"[{lo}, {hi}]")
        return compute_a_embed_fused_plain(flat, vocab)
    if ids.device.type != "cuda":
        raise ValueError(f"compute_a_embed_fused: unsupported device {ids.device}")
    flat = flat.contiguous()
    bins, clusters = token_count_plan(vocab)
    tally = _TOKEN_TALLIES.get(ids.device.index)
    if tally is None:
        tally = torch.tensor(_TALLY_EMPTY, dtype=torch.int64).to(ids.device)
        _TOKEN_TALLIES[ids.device.index] = tally
    out = torch.empty(vocab, dtype=torch.float32, device=ids.device)
    err = kernel_build.load("token_count").kfac_token_count(
        flat.data_ptr(), int(flat.dtype == torch.int64), flat.numel(), vocab,
        bins, clusters, out.data_ptr(), tally.data_ptr(),
        kernel_build.current_stream_handle(ids.device),
    )
    kernel_build.check(err, "token_count")
    compute_a_embed_fused.launches += 1
    return out


compute_a_embed_fused.launches = 0


def check_token_ids(device) -> None:
    """Raise if a ``compute_a_embed_fused`` launch on ``device`` since the
    last check met an id outside ``[0, V)``: one host sync, at a point the
    caller chooses (the LM trainer: once per epoch). Resets the tally. A
    CPU device has nothing to check: its calls raise at once."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    tally = _TOKEN_TALLIES.get(index)
    if tally is None:
        return
    count, vocab, lo, hi = tally.tolist()
    if count:
        tally.copy_(torch.tensor(_TALLY_EMPTY, dtype=torch.int64))
        raise _range_error(vocab, f"{count} ids outside it, in [{lo}, {hi}]")


def _route_embed(ids: torch.Tensor, n: int, kind: str) -> torch.Tensor:
    """The token-count route of the embedding and MoE dispatchers: the
    scatter-add oracle (``"dense"``) or the kernel wrapper."""
    with get_telemetry().span("trace/kfac/factor_kernel"):
        if kind == "dense":
            return factors.compute_a_embed(ids, n)
        return compute_a_embed_fused(ids, n)


def dispatch_compute_a_embed(
    ids: torch.Tensor, vocab: int, *, kind: str = "auto"
) -> torch.Tensor:
    """Route an embedding layer's diagonal-A contribution: oracle or kernel
    wrapper. Token ids are integers: nothing here is differentiated."""
    resolve_factor_kernel(kind, ids.device)
    get_telemetry().set_gauge("kfac/embedding_capture_kernel", _kernel_gauge(kind, ids))
    return _route_embed(ids, vocab, kind)


def dispatch_compute_a_moe(
    expert_ids: torch.Tensor, num_experts: int, *, kind: str = "auto"
) -> torch.Tensor:
    """An MoE layer's expert token fractions ``counts_e / N`` (``[E]``
    float32): the ``[tokens, experts]`` dispatch one-hot is the embedding
    one-hot with ``vocab = E``, so the fractions ride the token-count
    kernel (``compute_a_embed_fused``, counted on its counter) exactly as
    :func:`dispatch_compute_a_embed` routes, on a gauge of their own;
    ``"dense"`` takes the scatter-add oracle. Integer ids: nothing here is
    differentiated."""
    resolve_factor_kernel(kind, expert_ids.device)
    get_telemetry().set_gauge("kfac/moe_dispatch_kernel", _kernel_gauge(kind, expert_ids))
    return _route_embed(expert_ids, num_experts, kind)
