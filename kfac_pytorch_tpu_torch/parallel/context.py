"""Exact softmax attention, the single-device path.

Port of ``kfac_pytorch_tpu/parallel/context.py::full_attention``: the
semantics the flash kernels (``ops/flash_attention.py``) and the
sequence-parallel tiers must reproduce, and the transformer's attention
when the caller asks for the oracle. Ring and Ulysses attention wait for
the sequence-parallel part of ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/max NaN-free


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Exact softmax attention, ``[B, T, H, D] → [B, T, H, D]``, in float32.

    Materializes the ``[B, H, T, S]`` logits, as the JAX version does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        t, s = q.shape[1], k.shape[1]
        pos = torch.arange(max(t, s), device=q.device)
        mask = pos[:t, None] >= pos[None, :s]
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
