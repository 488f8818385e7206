"""Symmetric eigendecomposition with K-FAC's numerical conventions.

Port of ``kfac_pytorch_tpu/ops/eigh.py`` (the single-block subset of the
main path). ``torch.linalg.eigh`` is a library call (cuSOLVER on the card),
as ``jnp.linalg.eigh`` was XLA's: not a hand-kernel debt. The JAX package's
−1-padded shape buckets existed only to bound XLA's per-shape eigh compile
cost; cuSOLVER has no such cost, so nothing here pads.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def symmetrize(factor: torch.Tensor) -> torch.Tensor:
    """``0.5 * (X + Xᵀ)`` over the last two axes."""
    return 0.5 * (factor + factor.transpose(-1, -2))


def eigh_with_floor(
    factor: torch.Tensor, eps: float = 1e-10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Q, d)`` with ``factor ≈ Q diag(d) Qᵀ``; eigenvalues ``<= eps`` zeroed.

    Works on one ``[n, n]`` matrix or a ``[k, n, n]`` stack.
    """
    d, q = torch.linalg.eigh(symmetrize(factor))
    d = d * (d > eps).to(d.dtype)
    return q, d


def get_block_boundary(
    index: int, block_count: int, shape: Sequence[int]
) -> Tuple[List[int], List[int]]:
    """Start/end coords of diagonal block ``index`` of ``block_count``.

    Floor-divided block sizing with the last block absorbing the remainder;
    raises ``ValueError`` for ``index >= block_count`` or more blocks than
    ``min(shape)``.
    """
    if index >= block_count:
        raise ValueError(
            f"block index {index} is out of range for a {block_count}-block "
            "partition"
        )
    if block_count > min(shape):
        raise ValueError(
            f"cannot carve {block_count} diagonal blocks out of shape "
            f"{tuple(shape)}; at most min(shape) blocks fit"
        )
    block_shape = [x // block_count for x in shape]
    block_start = [x * index for x in block_shape]
    block_end = [
        x * (index + 1) if (index + 1) < block_count else shape[i]
        for i, x in enumerate(block_shape)
    ]
    return block_start, block_end
