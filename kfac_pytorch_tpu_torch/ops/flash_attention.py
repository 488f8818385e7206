"""Flash attention: forward, dQ and dK/dV as hand-written CUDA kernels.

Port of ``kfac_pytorch_tpu/ops/flash_attention.py``. The attention of the
transformer blocks (``models/transformer_lm.py``) on ``[B, T, H, D]``
tensors, differentiable, never materializing the ``[B, H, T, T]`` scores:

* :func:`flash_forward` — kernel 5 (``csrc/flash_attention.cu``
  ``kfac_flash_fwd``, replacing ``_flash_forward`` → ``_fwd_kernel``):
  online-softmax attention, returns ``(out, lse)`` with ``lse [B, H, T]``;
* :func:`flash_backward_dq` — kernel 6 (``kfac_flash_dq``, replacing
  ``_bwd_dq_kernel``);
* :func:`flash_backward_dkv` — kernel 7 (``kfac_flash_dkv``, replacing
  ``_bwd_dkv_kernel``).

Each wrapper launches its kernel on a CUDA tensor (or raises), takes the
plain PyTorch version on a CPU tensor, and counts its CUDA launches in
``fn.launches``. The plain versions, :func:`flash_forward_plain` and
:func:`flash_backward_plain`, use the kernels' formulas on whole score
matrices: ``q`` scaled before ``q·kᵀ``, masked logits at ``-1e30``,
``p = exp(s − lse)``, ``dS = p ⊙ (dP − Δ)``.

:func:`flash_attention` is a ``torch.autograd.Function``: its forward runs
kernel 5 and saves ``(q, k, v, out, lse)``; its backward forms
``Δ = rowsum(dO ⊙ out)`` in PyTorch, as the JAX version does outside
Pallas, then runs kernels 6 and 7. On CPU tensors it routes to the plain
versions. Unlike the JAX version there is no fallback by sequence length:
the kernels mask a ragged last tile, so every ``T`` runs them.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import Callable, Tuple

import torch

from kfac_pytorch_tpu_torch.ops import kernel_build
from kfac_pytorch_tpu_torch.parallel import context

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)  # instantiated in csrc/flash_attention.cu

logger = logging.getLogger(__name__)
_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    """Log a path-selection decision once per process."""
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``(q·scale)·kᵀ`` as ``[B, H, T, S]`` float32, masked to ``-1e30``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 5: ``(out [B, T, H, D], lse [B, H, T])``."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, v.float()) / den.transpose(1, 2)
    return out, (m + torch.log(den)).squeeze(-1)


def flash_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels 6 and 7: ``(dq, dk, dv)``, each
    ``[B, T, H, D]``, from the saved ``lse`` and ``delta = rowsum(dO ⊙ out)``
    (both ``[B, H, T]``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float() * scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    """``(B, T, H, D)`` of float32 ``[B, T, H, D]`` CUDA tensors of one shape
    whose last dimension is contiguous and whose rows are 16-byte aligned
    (the backward kernels copy rows with 16-byte ``cp.async``); raises on
    anything else."""
    first = tensors[0]
    if first.dim() != 4:
        raise ValueError(f"{what}: expected [B, T, H, D] tensors, got {tuple(first.shape)}")
    for t in tensors:
        if (
            t.device != first.device
            or t.dtype != torch.float32
            or t.shape != first.shape
            or t.stride(-1) != 1
        ):
            raise ValueError(
                f"{what}: every input must be a float32 {tuple(first.shape)} "
                f"tensor on {first.device} with a contiguous last dimension, "
                f"got {t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
            )
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(
                f"{what}: every row must start 16-byte aligned (data pointer "
                f"and [B, T, H] strides multiples of 4 floats), got storage "
                f"offset {t.storage_offset()} and strides {t.stride()}"
            )
    b, t, h, d = first.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{what}: the CUDA kernels take head dimensions {HEAD_DIMS}, got {d}"
        )
    if t < 1:
        raise ValueError(f"{what}: empty sequence")
    return b, t, h, d


def _check_stats(what: str, like: torch.Tensor, *stats: torch.Tensor) -> None:
    b, t, h, _ = like.shape
    for s in stats:
        if (
            s.device != like.device
            or s.dtype != torch.float32
            or tuple(s.shape) != (b, h, t)
            or not s.is_contiguous()
        ):
            raise ValueError(
                f"{what}: lse and delta must be contiguous float32 {(b, h, t)} "
                f"tensors on {like.device}, got {s.dtype} {tuple(s.shape)} on {s.device}"
            )


def _strides(*tensors: torch.Tensor):
    """The ``[B, T, H]`` strides of each tensor, as the C entries take them."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5: ``(out [B, T, H, D], lse [B, H, T])`` float32."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    b, t, h, d = _check("flash_forward", q, k, v)
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    lib = kernel_build.load("flash_attention")
    err = lib.kfac_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ctypes.addressof(strides),
        out.data_ptr(), lse.data_ptr(), b, t, h, d, int(causal),
        1.0 / math.sqrt(d), kernel_build.current_stream_handle(q.device),
    )
    kernel_build.check(err, "flash_attention forward")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_backward_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Kernel 6: ``dq [B, T, H, D]``."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, do, lse, delta, causal)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward_dq: unsupported device {q.device}")
    b, t, h, d = _check("flash_backward_dq", q, k, v, do)
    _check_stats("flash_backward_dq", q, lse, delta)
    dq = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do)
    lib = kernel_build.load("flash_attention")
    err = lib.kfac_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        ctypes.addressof(strides), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, t, h, d, int(causal), 1.0 / math.sqrt(d),
        kernel_build.current_stream_handle(q.device),
    )
    kernel_build.check(err, "flash_attention dq")
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


# query rows one flash_dkv launch sums on the tensor cores: a longer
# sequence's dK/dV sums are split into chunks of these, one launch each,
# added in order on the CUDA cores (csrc/flash_attention.cu, "Accuracy
# over long sums")
DKV_CHUNK_ROWS = 2048


def flash_backward_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: ``(dk, dv)``, each ``[B, T, H, D]``."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, do, lse, delta, causal)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward_dkv: unsupported device {q.device}")
    b, t, h, d = _check("flash_backward_dkv", q, k, v, do)
    _check_stats("flash_backward_dkv", q, lse, delta)
    dk = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do)
    lib = kernel_build.load("flash_attention")
    err = lib.kfac_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        ctypes.addressof(strides), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), DKV_CHUNK_ROWS, b, t, h, d, int(causal),
        1.0 / math.sqrt(d), kernel_build.current_stream_handle(q.device),
    )
    kernel_build.check(err, "flash_attention dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        # O(T·D) residuals: no [T, T] tensor is kept for the backward
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        # Δ_i = Σ_d dO_id · O_id, one elementwise pass, as in the JAX version
        delta = (do.float() * out).sum(dim=-1).transpose(1, 2).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_plain(q, k, v, do, lse, delta, ctx.causal)
        else:
            dq = flash_backward_dq(q, k, v, do, lse, delta, ctx.causal)
            dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Fused attention over ``[B, T, H, D]`` (the transformer blocks' layout),
    differentiable, ``full_attention``'s signature and float32 result."""
    return _FlashAttention.apply(q, k, v, causal)


def best_attention_fn(device) -> Callable[..., torch.Tensor]:
    """``full_attention``-compatible attention for ``device``: the CUDA flash
    kernels on a GPU, exact attention elsewhere. The choice is logged once."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _warn_once("path-flash", "best_attention_fn: using the CUDA flash attention kernels")
        return flash_attention
    _warn_once("path-exact", f"best_attention_fn: using exact attention (device={dev})")
    return context.full_attention
