"""Randomized truncated eigensolve of K-FAC factors, from matmuls.

Port of ``kfac_pytorch_tpu/ops/rsvd.py``. A factor side of size ``n`` that
the preconditioner truncates keeps its top ``rank`` eigenpairs, found by a
Gaussian range finder, two rounds of subspace iteration and a
Rayleigh–Ritz projection (arxiv 2206.15397). Every ``n``-sized operation
is an IEEE float32 matmul (``Precision.HIGHEST`` in the JAX
package; the entry points turn TF32 off); the only eigendecompositions are
of ``(rank+p)×(rank+p)`` matrices. The truncated basis is consumed as

    F  ≈  Q_r diag(d_r) Q_rᵀ + rho · (I − Q_r Q_rᵀ)

with ``rho`` the residual trace mass (:func:`residual_rho`); the matching
Woodbury solves are in ``ops/precondition.py``. These are library matmuls
and small ``torch.linalg.eigh`` calls, as they were XLA's in the JAX
package: no Pallas kernel to port.

Padding: the JAX package zero-pads each block into its shape bucket
``m = bucket_size(n)`` (:func:`pad_for_rsvd`) and sketches with an
``[m, cols]`` Ω. The pad rows carry zero energy, so ``A_pad·Ω = [A·Ω[:n];
0]``: the port solves each block unpadded with ``Ω[:n]``, the same
computation without the pad. The refresh groups the blocks by exact size
and rank (``parallel/sharded_eigh.py``, the JAX package's
``bucketed_rsvd_eigh`` grouping).

The sketch: the JAX package draws Ω from threefry (``PRNGKey(20220630)``
folded with ``m``), which PyTorch cannot reproduce. The port draws its own
from a CPU ``torch.Generator`` seeded with the same seed and ``m``
(:func:`sketch_matrix`), the same on every rank and every run.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from kfac_pytorch_tpu_torch.ops.eigh import bucket_size, symmetrize

# range-finder oversampling p and subspace-iteration passes q
DEFAULT_OVERSAMPLE = 8
DEFAULT_PASSES = 2

# the JAX package's sketch seed (arxiv 2206.15397 v1 date), combined with
# the bucket size so each bucket draws its own sketch
_SKETCH_SEED = 20220630


def pad_for_rsvd(block: torch.Tensor, m: int) -> torch.Tensor:
    """Embed a symmetric ``n×n`` block into ``m×m`` with a ZERO pad (the
    JAX package's layout; the port's solves run unpadded)."""
    n = block.shape[0]
    if n == m:
        return block
    out = block.new_zeros((m, m))
    out[:n, :n] = block
    return out


@functools.lru_cache(maxsize=32)
def _draw(m: int, cols: int, device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed((_SKETCH_SEED << 32) + m)
    return torch.randn(m, cols, generator=gen, dtype=torch.float32).to(device)


def sketch_matrix(m: int, cols: int, device=None) -> torch.Tensor:
    """The deterministic ``[m, cols]`` Gaussian sketch of bucket size ``m``
    (drawn on the CPU, kept per device)."""
    return _draw(int(m), int(cols), str(torch.device(device or "cpu")))


def _orthonormalize(y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of an ``[n, cols]`` matrix without QR:
    ``Q = Y·(YᵀY)^{-1/2}`` through the Gram matrix's eigendecomposition,
    twice (one pass leaves ``O(eps·cond(Y)²)``). The eigenvalue floor is
    relative, ``1e-12·max(s)``: a rank-deficient direction gets a large but
    finite scale, and the next multiply re-enriches it."""
    for _ in range(2):
        s, u = torch.linalg.eigh(symmetrize(y.T @ y))
        inv_sqrt = torch.rsqrt(torch.clamp(torch.clamp(s, min=1e-12 * s.max()), min=1e-30))
        y = y @ ((u * inv_sqrt) @ u.T)
    return y


def _randomized_eigh(a: torch.Tensor, omega: torch.Tensor, rank: int, passes: int, eps: float):
    """One symmetric PSD ``[n, n]`` block's truncated solve on the sketch
    ``omega [n, cols]``: ``(Q [n, rank], d [rank])``."""
    # 0.5·(A + Aᵀ) with one temporary (A is 4.4 GB at a 33,278-word vocab)
    a = a.float()
    a = a + a.T
    a.mul_(0.5)
    y = _orthonormalize(a @ omega)
    for _ in range(passes):
        y = _orthonormalize(a @ y)
    # Rayleigh–Ritz; eigh is ascending, so the top pairs are the last columns
    t_eigs, v = torch.linalg.eigh(symmetrize(y.T @ (a @ y)))
    cols = omega.shape[1]
    d = t_eigs[cols - rank:]
    return y @ v[:, cols - rank:], d * (d > eps).to(d.dtype)


def batched_randomized_eigh(
    stack: torch.Tensor,
    rank: int,
    eps: float = 1e-10,
    oversample: int = DEFAULT_OVERSAMPLE,
    passes: int = DEFAULT_PASSES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated eigensolve of a ``[k, n, n]`` stack of symmetric PSD blocks:
    ``(Q [k, n, rank], d [k, rank])``, ``d`` ascending (the dense eigh's
    order) and floored at ``eps``.

    The sketch is ``sketch_matrix(bucket_size(n), cols)[:n]`` with ``cols =
    min(rank + oversample, bucket_size(n))``: the JAX package's padded
    computation, unpadded. Each block is solved with 2-D products and
    eighs of its own (the JAX package batches them): a block's result then
    does not depend on which blocks share its stack, so a sharded refresh,
    whose ranks stack subsets, is bitwise the replicated one, as the dense
    eigh's per-matrix ``syevd`` is."""
    k, n, _ = stack.shape
    m = bucket_size(n)
    cols = min(rank + max(0, int(oversample)), m)
    omega = sketch_matrix(m, cols, stack.device)[:n]
    qs, ds = zip(*(_randomized_eigh(stack[i], omega, rank, max(0, int(passes)), eps)
                   for i in range(k)))
    return torch.stack(qs), torch.stack(ds)


def residual_rho(trace: torch.Tensor, d: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """``(tr(F) − Σ d_r) / (n − r)`` clipped at 0: the mean eigenvalue of
    the spectrum the basis does not capture (the denominator floored at 1)."""
    denom = max(int(n) - int(rank), 1)
    return torch.clamp((trace.float() - d.float().sum(-1)) / denom, min=0.0)
