"""Symmetric eigendecomposition with K-FAC's numerical conventions.

Port of ``kfac_pytorch_tpu/ops/eigh.py``: the floored eigendecomposition
and the block boundaries. The block-diagonal approximation
(``diag_blocks > 1``) is the refresh's blocked slots
(``parallel/sharded_eigh.py::replicated_eigen_update``).
``torch.linalg.eigh`` is a library call (cuSOLVER on the card), as
``jnp.linalg.eigh`` was XLA's: not a hand-kernel debt. The JAX package's
−1-padded shape buckets existed only to bound XLA's per-shape eigh compile
cost; cuSOLVER has no such cost, so nothing here pads. The bucket size
itself (:func:`bucket_size`) is kept: the chunk planner's cost and the
randomized solver's sketch are defined on it, so the port's plans and
sketches are the JAX package's.

cuSOLVER's ``syevd`` sizes its workspace (~3n² values) in a 32-bit count
and refuses a matrix wider than ``SYEVD_MAX_N`` = 26,733 (measured on an
H100 with CUDA 12.8, float32 and float64 alike; a WikiText-2 decoder's G
factor is 33,278 wide). :func:`eigh_symmetric` decomposes a wider matrix
by spectral divide and conquer, from library calls (the JAX package's TPU
eigh is a spectral divide and conquer too): a shift ``σ`` at the
estimated median eigenvalue (Lanczos quadrature), the matrix sign of
``A − σI`` by the scaled Newton iteration in float64 (``torch.linalg.inv``),
an orthonormal basis of the projector ``(sign + I)/2``'s range and its
complement (``geqrf``/``ormqr``), and ``torch.linalg.eigh`` of ``A``
projected on each part, recursing on a part still too wide.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# the widest matrix cuSOLVER's syevd takes: its ~3n² workspace values
# must count in 32 bits
SYEVD_MAX_N = 26733
# the widest part of a spectral split that takes a float64 eigh (cuSOLVER's
# float32 syevd loses orthogonality at these widths); a wider part, up to
# the syevd limit, is split again, which bounds the float64 working set
SPLIT_LEAF_N = 20000
# the matrix-sign iteration: relative change that ends it, and its cap
SIGN_RTOL = 1e-12
SIGN_MAX_ITERS = 60
# Lanczos quadrature for the median eigenvalue: probes and steps each
MEDIAN_PROBES = 4
MEDIAN_STEPS = 48


def bucket_size(n: int, granularity: int = 512, minimum: int = 128) -> int:
    """Smallest padded size ≥ n: ``minimum`` or a multiple of ``granularity``
    (the JAX package's shape bucket)."""
    if n <= minimum:
        return minimum
    return ((n + granularity - 1) // granularity) * granularity


def symmetrize(factor: torch.Tensor) -> torch.Tensor:
    """``0.5 * (X + Xᵀ)`` over the last two axes."""
    return 0.5 * (factor + factor.transpose(-1, -2))


def eigh_with_floor(
    factor: torch.Tensor, eps: float = 1e-10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Q, d)`` with ``factor ≈ Q diag(d) Qᵀ``; eigenvalues ``<= eps`` zeroed.

    Works on one ``[n, n]`` matrix or a ``[k, n, n]`` stack.
    """
    d, q = eigh_symmetric(symmetrize(factor))
    d = d * (d > eps).to(d.dtype)
    return q, d


def eigh_symmetric(
    a: torch.Tensor, limit: int = SYEVD_MAX_N
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of a symmetric ``[n, n]`` matrix or ``[k, n,
    n]`` stack: ``(d ascending, Q)``. Wider than ``limit``, each matrix
    takes :func:`_eigh_split`."""
    n = a.shape[-1]
    if n <= limit:
        return torch.linalg.eigh(a)
    if a.dim() == 2:
        return _eigh_split(a, limit)
    if a.shape[0] == 1:  # no stacking copy of a wide result
        d, q = _eigh_split(a[0], limit)
        return d[None], q[None]
    parts = [_eigh_split(x, limit) for x in a]
    return torch.stack([d for d, _ in parts]), torch.stack([q for _, q in parts])


def _orth(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(x)[0]


def _median_eigenvalue(a: torch.Tensor, gen: torch.Generator) -> float:
    """The median of the float64 matrix ``a``'s eigenvalues, estimated by
    Lanczos quadrature: ``MEDIAN_PROBES`` random probes of ``MEDIAN_STEPS``
    Lanczos steps (full reorthogonalization), their Ritz values weighted by
    the squared first components of the Ritz vectors, pooled. In float64,
    a cluster's Ritz value lands inside the cluster's own rounding spread
    (a K-FAC factor's identity part: many equal eigenvalues), so the sign
    splits the cluster too."""
    n = a.shape[0]
    steps = min(MEDIAN_STEPS, n)
    thetas, weights = [], []
    for _ in range(MEDIAN_PROBES):
        basis = torch.empty(steps, n, dtype=torch.float64, device=a.device)
        q = torch.randn(n, generator=gen, device=a.device, dtype=torch.float64)
        basis[0] = q / q.norm()
        diag, off = [], []
        for j in range(steps):
            w = a @ basis[j]
            diag.append(float(basis[j] @ w))
            for _ in range(2):  # full reorthogonalization, twice
                w = w - basis[:j + 1].T @ (basis[:j + 1] @ w)
            beta = float(w.norm())
            if j + 1 == steps or beta <= 1e-12 * max(abs(d) for d in diag):
                break
            off.append(beta)
            basis[j + 1] = w / beta
        t = torch.diag(torch.tensor(diag, dtype=torch.float64))
        if off:
            e = torch.tensor(off, dtype=torch.float64)
            t += torch.diag(e, 1) + torch.diag(e, -1)
        theta, u = torch.linalg.eigh(t)
        thetas.append(theta)
        weights.append(u[0] ** 2)
    theta, weight = torch.cat(thetas), torch.cat(weights)
    order = torch.argsort(theta)
    cum = torch.cumsum(weight[order], 0) / weight.sum()
    return float(theta[order][int(torch.searchsorted(cum, torch.tensor(0.5, dtype=cum.dtype)))])


def _matrix_sign(x: torch.Tensor, size: float, gen: torch.Generator) -> torch.Tensor:
    """``sign(x)`` of a symmetric float64 matrix, in place of ``x``, by the
    scaled Newton iteration ``X ← (ζX + (ζX)⁻¹)/2`` (Frobenius scaling ζ
    while the iterate moves by more than 1e-2, then ζ = 1), until it moves
    by less than ``SIGN_RTOL``. A random diagonal of 1e-12 of ``size`` (the
    matrix's scale) first makes ``x`` nonsingular where the shift sits
    exactly on an eigenvalue (a float32 factor's own rounding is ~1e-7 of
    its scale, so this moves nothing that float32 resolves)."""
    n = x.shape[0]
    x.diagonal().add_(torch.randn(n, generator=gen, device=x.device, dtype=x.dtype),
                      alpha=1e-12 * size)
    scaled, last = True, float("inf")
    xi = torch.empty_like(x)  # the inverse, written in place each iteration
    for _ in range(SIGN_MAX_ITERS):
        torch.linalg.inv(x, out=xi)
        zeta = (float(xi.norm()) / float(x.norm())) ** 0.5 if scaled else 1.0
        a, b = zeta / 2, 1.0 / (2 * zeta)
        # X' = aX + b·xi in place, and |X' − X|, a row block at a time (a
        # whole-matrix temporary would be another n² float64 values)
        change = 0.0
        for lo in range(0, n, 4096):
            new = x[lo:lo + 4096] * a + xi[lo:lo + 4096] * b
            change += float(torch.sum((new - x[lo:lo + 4096]) ** 2))
            x[lo:lo + 4096] = new
        del new
        moved = change ** 0.5 / max(float(x.norm()), 1e-300)
        if moved < 1e-2:
            scaled = False
        # converged, or at float64's floor (the change stops shrinking)
        if moved < SIGN_RTOL or (not scaled and moved < 1e-8 and moved > 0.5 * last):
            break
        last = moved
    return x


def _eigh_split(a: torch.Tensor, limit: int, depth: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral divide and conquer of a symmetric ``[n, n]`` matrix wider
    than ``limit``: the sign of ``A − σI`` at the median eigenvalue splits
    the space into two invariant subspaces; a part up to ``SPLIT_LEAF_N``
    (and ``limit``) wide takes a float64 ``torch.linalg.eigh``, a wider one
    is split again. The sign, the bases and the parts' projections are
    computed in float64, the bases kept in ``a``'s dtype. Returns ``(d
    ascending, Q)`` in ``a``'s dtype."""
    n = a.shape[0]
    if depth > 4:
        raise RuntimeError(f"eigh of a {n}-wide matrix: the spectral split did not balance")
    gen = torch.Generator(device=a.device).manual_seed(depth)
    x = a.to(torch.float64, copy=True)
    x.diagonal().sub_(_median_eigenvalue(x, gen))
    p = _matrix_sign(x, float(a.norm()) / n ** 0.5, gen)
    # the projector on the eigenvalues above σ
    p.diagonal().add_(1.0)
    p.mul_(0.5)
    k = min(max(int(round(float(p.diagonal().sum()))), 1), n - 1)
    omega = torch.randn(n, k, generator=gen, device=a.device, dtype=torch.float64)
    q_hi = _orth(p @ _orth(p @ omega))
    del p, omega
    refl, tau = torch.geqrf(q_hi)
    pick = torch.zeros(n, n - k, device=a.device, dtype=torch.float64)
    pick[k:].fill_diagonal_(1.0)
    qs = [torch.ormqr(refl, tau, pick).to(a.dtype), q_hi.to(a.dtype)]
    del refl, tau, pick, q_hi
    leaf = min(limit, SPLIT_LEAF_N)
    ds = []
    for i, q in enumerate(qs):
        # the part's projection in float64 (a's rows cast a block at a
        # time), whose sums run n long; eigh reads one triangle of it
        q64 = q.double()
        b = q64.T @ torch.cat([a[lo:lo + 4096].double() @ q64 for lo in range(0, n, 4096)])
        if b.shape[0] <= leaf:
            d, u = torch.linalg.eigh(b)
            del b
            qs[i] = (q64 @ u).to(a.dtype)
        else:
            del q64
            d, u = _eigh_split(b.to(a.dtype), limit, depth + 1)
            del b
            qs[i] = q @ u
        ds.append(d.to(a.dtype))
        del q, u
    d = torch.cat(ds)
    order = torch.argsort(d)
    return d[order], torch.cat(qs, dim=1)[:, order]


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

