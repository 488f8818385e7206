"""Streaming low-rank curvature: the per-capture-step fold.

Port of ``kfac_pytorch_tpu/ops/streaming.py``. ``KFAC(solver="streaming")``
keeps the truncated bases ``Q`` of the last re-orthonormalization and, on
every capture step, folds the freshly averaged factor through them:
``d = diag(Qᵀ F Q)`` (a Rayleigh quotient per kept direction, floored at
``eps``) and ``rho = (tr F − Σ d)₊ / (n − r)`` (the ``residual_rho``
convention of ``ops/rsvd.py``). The fold is a pure function of ``(Q, F)``:
two thin matmuls per side, no eigendecomposition, so nothing accumulates
between re-orthonormalizations. Those are plain refreshes that
``scheduler.EigenRefreshCadence`` schedules when the drift gauge trips.

The gauge, :func:`fold_replicated`'s third result, is ``Σ (tr F − Σ d)₊ /
Σ tr F`` over the truncated sides: the share of curvature mass the kept
bases no longer explain (0 when no side is truncated). Library matmuls and
elementwise work, as they were XLA's in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kfac_pytorch_tpu_torch.ops.precondition import shape_groups


def fold_diag(d: torch.Tensor, fac_diag: torch.Tensor, eps: float) -> torch.Tensor:
    """Diagonal-A (embedding) side: the basis is the coordinate basis, so
    the fold is the refresh's floor ``f·(f > eps)``."""
    f = fac_diag.float()
    return f * (f > eps)


def fold_side(q: torch.Tensor, fac: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one factor (or a stack) through its kept basis: ``q [..., n,
    r]`` (any dtype, computed in float32), ``fac [..., n, n]``. Returns
    ``(d [..., r], trace [...])``, ``d`` floored at ``eps``. The quadratic
    form ``qᵀFq`` equals ``qᵀ·sym(F)·q``, so ``F`` is not symmetrized (the
    JAX package's copy of it, 4.4 GB at a 33,278-word vocab, is skipped)."""
    qf = q.float()
    ff = fac.float()
    d = ((ff @ qf) * qf).sum(-2)
    d = d * (d > eps)
    return d, torch.diagonal(ff, dim1=-2, dim2=-1).sum(-1)


def fold_rho(trace: torch.Tensor, d: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """The residual eigenvalue after a fold: ``(trace − Σ d)₊ / max(n − r,
    1)``."""
    return torch.clamp(trace - d.sum(-1), min=0.0) / float(max(n - rank, 1))


def fold_replicated(
    facs: Dict[str, Dict[str, torch.Tensor]],
    singles: Dict[str, Dict[str, torch.Tensor]],
    stacked: Dict[str, Dict[str, torch.Tensor]],
    eps: float,
) -> Tuple[Dict, Dict, torch.Tensor]:
    """Fold every layer's factors through the current bases, on the split
    eigen layout (per-layer ``singles``, same-shape ``stacked`` groups in
    :func:`shape_groups` row order). ``Q`` passes through; ``d`` and
    ``rho`` are rebuilt. Returns ``(singles', stacked', residual)``."""
    first = next(iter(facs.values()))["G"]
    num = first.new_zeros((), dtype=torch.float32)
    den = first.new_zeros((), dtype=torch.float32)

    def side(entry, prefix, fac):
        nonlocal num, den
        q = entry["Q" + prefix]
        d, trace = fold_side(q, fac, eps)
        out = {"d" + prefix: d}
        if "rho" + prefix in entry:
            out["rho" + prefix] = fold_rho(trace, d, q.shape[-2], q.shape[-1])
            num = num + torch.clamp(trace - d.sum(-1), min=0.0).sum()
            den = den + trace.sum()
        return out

    new_singles = {}
    for name, entry in singles.items():
        e = dict(entry)
        if "QA" not in entry:  # diagonal-A (embedding) layer
            e["dA"] = fold_diag(entry["dA"], facs[name]["A_diag"], eps)
        else:
            e.update(side(entry, "A", facs[name]["A"]))
        e.update(side(entry, "G", facs[name]["G"]))
        new_singles[name] = e
    # the stacks' rows: shape_groups order over the square layers that are
    # not singles, the order split_eigen_state stacked them in
    shapes = {
        name: (f["G"].shape[0], f["A"].shape[0])
        for name, f in facs.items()
        if "A" in f and name not in singles
    }
    new_stacked = {}
    for (g_n, a_n), names in shape_groups(shapes).items():
        key = f"{g_n}x{a_n}"
        e = dict(stacked[key])
        e.update(side(stacked[key], "A", torch.stack([facs[n]["A"] for n in names])))
        e.update(side(stacked[key], "G", torch.stack([facs[n]["G"] for n in names])))
        new_stacked[key] = e
    return new_singles, new_stacked, num / torch.clamp(den, min=1e-30)
