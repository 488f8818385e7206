"""Natural-gradient preconditioning (eigenbasis or inverse) + KL clipping.

Port of ``kfac_pytorch_tpu/ops/precondition.py`` for the ported paths: the
eigen method with full-eigen dense entries, diagonal-A (embedding) entries
and the low-rank-plus-diagonal (Woodbury) entries of the truncated solvers
(``solver="rsvd"``/``"streaming"``), and the inverse method
(``precond_method="inverse"``), replicated or with the rotations sharded
over the ranks (:func:`precondition_all_distributed`,
:func:`precondition_all_inv_distributed`), and the owner-sharded solve of
``factor_sharding="owner"`` (:func:`precondition_all_owner`). Same-shape layers are stacked and
preconditioned together. Diagonal-A layers stay out of the shape groups
and are preconditioned first, in sorted order; then the groups follow in
:func:`shape_groups`' insertion order. That emission order is also the
KL-clip summation order, as in the reference.

Eigenvectors and matrix inverses may be stored in bfloat16
(``KFAC(eigen_dtype=torch.bfloat16)``): the dense products upcast them to
float32, as JAX promotes a bf16 × f32 matmul, and the fused apply kernel
reads them as they are. ``precision`` (``precond_precision``) sets the
dense products' matmul precision through ``device.rotation_precision``;
the fused kernel ignores it, as the JAX package's fused branch does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch.device import rotation_precision
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import apply_kernels
from kfac_pytorch_tpu_torch.parallel.mesh import World


def precondition_mat(
    grad_mat: torch.Tensor,
    q_a: torch.Tensor,
    q_g: torch.Tensor,
    d_a: torch.Tensor,
    d_g: torch.Tensor,
    damping,
) -> torch.Tensor:
    """Apply ``(G ⊗ A + damping·I)⁻¹`` to a ``[out, in]`` gradient matrix:
    ``v = QG · [(QGᵀ · grad · QA) / (dG dAᵀ + damping)] · QAᵀ``."""
    q_a, q_g = q_a.float(), q_g.float()
    v1 = (q_g.T @ grad_mat) @ q_a
    v2 = v1 / (d_g[:, None] * d_a[None, :] + damping)
    return (q_g @ v2) @ q_a.T


def diag_a_names(eigen: Dict[str, Dict[str, torch.Tensor]]) -> set:
    """Layers whose A factor is a stored diagonal (embeddings): their state
    entry carries A-side eigenvalues ``dA`` (eigen method) or an inverse
    diagonal ``iA_diag`` (inverse method) but no A-side matrix."""
    return {
        n
        for n, e in eigen.items()
        if ("QA" not in e and "iA" not in e) and ("dA" in e or "iA_diag" in e)
    }


def precondition_mat_embed(
    grad_mat: torch.Tensor,
    q_g: torch.Tensor,
    d_g: torch.Tensor,
    d_a: torch.Tensor,
    damping,
) -> torch.Tensor:
    """Eigenbasis solve for a diagonal-A (embedding) layer's ``[d, vocab]``
    gradient: the A eigenvectors are the identity, so
    ``v = QG · [(QGᵀ·g) / (dG dAᵀ + damping)]`` — two G-side products
    (library matmuls, as the JAX package leaves them to XLA) and elementwise
    work on the vocab axis."""
    q_g = q_g.float()
    v1 = q_g.T @ grad_mat
    v2 = v1 / (d_g[:, None] * d_a[None, :] + damping)
    return q_g @ v2


# ---------------------------------------------------------------------------
# Low-rank-plus-diagonal (Woodbury) solves — solver="rsvd"/"streaming"
#
# A truncated side stores (Q_r [n, r], d_r [r], rho), modelling the factor as
# F ≈ Q_r diag(d_r) Q_rᵀ + rho·(I − Q_r Q_rᵀ). Q_r's columns are orthonormal,
# so (G ⊗ A + λI)⁻¹ splits exactly over the captured/complement sectors of
# each side: project onto each sector, divide by its damped eigenvalue
# product (a complement side contributes rho), re-expand. Thin [n, r]
# matmuls and elementwise work, as in the JAX package (outside its Pallas
# kernel, so library matmuls here; kernel 3 takes only dense entries). Every
# function takes one [out, in] matrix or a [k, out, in] stack with stacked
# state (``rho`` then [k]). Key presence is the dispatch signal
# (:func:`solve_eigen_entry`).
# ---------------------------------------------------------------------------


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _outer_damped(d_g: torch.Tensor, d_a: torch.Tensor, damping) -> torch.Tensor:
    return d_g[..., :, None] * d_a[..., None, :] + damping


def precondition_mat_lowrank(
    grad_mat, q_a, q_g, d_a, d_g, rho_a, rho_g, damping
) -> torch.Tensor:
    """Woodbury solve with BOTH sides truncated (``q_a [in, rA]``, ``q_g
    [out, rG]``, scalar ``rho_a``/``rho_g``): the captured×captured sector
    divides by ``d_g d_aᵀ + λ``, the mixed ones by ``d_g·rho_a + λ`` and
    ``rho_g·d_a + λ``, the complement×complement one by ``rho_g·rho_a +
    λ``; the full-gradient term carries the last and the thin projections
    correct the others."""
    q_a, q_g, lam = q_a.float(), q_g.float(), damping
    t1 = _t(q_g) @ grad_mat  # [rG, in]
    t2 = grad_mat @ q_a  # [out, rA]
    t3 = t1 @ q_a  # [rG, rA]
    ra, rg = rho_a[..., None], rho_g[..., None]
    c4 = 1.0 / (rg * ra + lam)  # [..., 1]
    d2 = 1.0 / (d_g * ra + lam)  # [..., rG]
    d3 = 1.0 / (rg * d_a + lam)  # [..., rA]
    c4m = c4[..., None]
    z = (
        t3 / _outer_damped(d_g, d_a, lam)
        - d2[..., :, None] * t3
        - t3 * d3[..., None, :]
        + c4m * t3
    )
    x = (d2 - c4)[..., :, None] * t1 + z @ _t(q_a)
    y = t2 * (d3 - c4)[..., None, :]
    return c4m * grad_mat + q_g @ x + y @ _t(q_a)


def precondition_mat_lr_g(grad_mat, q_a, q_g, d_a, d_g, rho_g, damping) -> torch.Tensor:
    """Woodbury solve with only the G side truncated (``q_g [out, rG]``);
    the A side keeps its full eigenbasis ``q_a [in, in]``."""
    q_a, q_g, lam = q_a.float(), q_g.float(), damping
    g_a = grad_mat @ q_a  # [out, in]
    t1 = _t(q_g) @ g_a  # [rG, in]
    cap = t1 / _outer_damped(d_g, d_a, lam)
    res = (g_a - q_g @ t1) / (rho_g[..., None, None] * d_a[..., None, :] + lam)
    return (q_g @ cap + res) @ _t(q_a)


def precondition_mat_lr_a(grad_mat, q_a, q_g, d_a, d_g, rho_a, damping) -> torch.Tensor:
    """Woodbury solve with only the A side truncated (``q_a [in, rA]``);
    the G side keeps its full eigenbasis."""
    q_a, q_g, lam = q_a.float(), q_g.float(), damping
    g_g = _t(q_g) @ grad_mat  # [out, in]
    t = g_g @ q_a  # [out, rA]
    cap = t / _outer_damped(d_g, d_a, lam)
    res = (g_g - t @ _t(q_a)) / (d_g[..., :, None] * rho_a[..., None, None] + lam)
    return q_g @ (cap @ _t(q_a) + res)


def precondition_mat_embed_lr_g(grad_mat, q_g, d_g, rho_g, d_a, damping) -> torch.Tensor:
    """Diagonal-A (embedding) layer with a truncated G side: the A rotations
    are the identity; the G side splits captured/complement."""
    q_g, lam = q_g.float(), damping
    t1 = _t(q_g) @ grad_mat  # [rG, vocab]
    cap = q_g @ (t1 / _outer_damped(d_g, d_a, lam))
    res = (grad_mat - q_g @ t1) / (rho_g[..., None, None] * d_a[..., None, :] + lam)
    return cap + res


def entry_is_lowrank(e: Dict[str, torch.Tensor]) -> bool:
    """Whether an eigen-state entry carries a truncated (Woodbury) side."""
    return "rhoA" in e or "rhoG" in e


def solve_eigen_entry(g: torch.Tensor, e: Dict[str, torch.Tensor], damping) -> torch.Tensor:
    """One entry's eigenbasis solve, dispatched on its keys: dense entries
    take the functions they always took (an ``[out, in]`` matrix, or a
    ``[k, out, in]`` stack for the oracle chain), low-rank ones the matching
    Woodbury form."""
    if "QA" not in e:  # diagonal-A (embedding) layer
        if "rhoG" in e:
            return precondition_mat_embed_lr_g(g, e["QG"], e["dG"], e["rhoG"], e["dA"], damping)
        return precondition_mat_embed(g, e["QG"], e["dG"], e["dA"], damping)
    lr_a, lr_g = "rhoA" in e, "rhoG" in e
    if lr_a and lr_g:
        return precondition_mat_lowrank(
            g, e["QA"], e["QG"], e["dA"], e["dG"], e["rhoA"], e["rhoG"], damping
        )
    if lr_g:
        return precondition_mat_lr_g(g, e["QA"], e["QG"], e["dA"], e["dG"], e["rhoG"], damping)
    if lr_a:
        return precondition_mat_lr_a(g, e["QA"], e["QG"], e["dA"], e["dG"], e["rhoA"], damping)
    if g.dim() == 3:
        return _precondition_stack(g, e, damping)
    return precondition_mat(g, e["QA"], e["QG"], e["dA"], e["dG"], damping)


def shape_groups(
    shapes: Dict[str, Tuple[int, int]]
) -> Dict[Tuple[int, int], list]:
    """Group layer names by exact ``[out, in]`` shape, insertion-ordered."""
    groups: Dict[Tuple[int, int], list] = {}
    for name, shape in shapes.items():
        groups.setdefault(tuple(shape), []).append(name)
    return groups


def _split_state(
    state: Dict[str, Dict[str, torch.Tensor]], g_key: str, a_key: str
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """Singles/stacked split: same-shape groups are stacked under
    ``"{g}x{a}"`` keys in :func:`shape_groups` order; singleton shapes stay
    per-layer."""
    singles: Dict[str, Dict[str, torch.Tensor]] = {}
    square = {}
    for n, e in state.items():
        if a_key not in e:
            singles[n] = e
        else:
            square[n] = e
    shapes = {n: (e[g_key].shape[0], e[a_key].shape[0]) for n, e in square.items()}
    stacked: Dict[str, Dict[str, torch.Tensor]] = {}
    for (g, a), names in shape_groups(shapes).items():
        if len(names) < 2:
            singles[names[0]] = square[names[0]]
            continue
        keys = square[names[0]].keys()
        stacked[f"{g}x{a}"] = {
            k: torch.stack([square[n][k] for n in names]) for k in keys
        }
    return singles, stacked


def split_eigen_state(
    eigen: Dict[str, Dict[str, torch.Tensor]],
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """Split a full per-layer eigen dict into ``(singles, stacked)``: the
    stacked form is built once per refresh, not once per step."""
    return _split_state(eigen, g_key="QG", a_key="QA")


def _group_eigen(names, key, eigen, stacked):
    if len(names) == 1:
        e = eigen[names[0]]
        return {k: v[None] for k, v in e.items()}
    if stacked is not None and key in stacked:
        return stacked[key]
    keys = eigen[names[0]].keys()
    return {k: torch.stack([eigen[n][k] for n in names]) for k in keys}


def precondition_all(
    grad_mats: Dict[str, torch.Tensor],
    eigen: Dict[str, Dict[str, torch.Tensor]],
    damping,
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    precision: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Precondition every layer's gradient matrix, batching same-shape layers
    (the oracle chain: four batched matmuls and the damped divide);
    diagonal-A layers first, in sorted order. Low-rank entries take their
    Woodbury solves (:func:`solve_eigen_entry`)."""
    with rotation_precision(precision):
        return _precondition_all(grad_mats, eigen, damping, stacked)


def _precondition_all(grad_mats, eigen, damping, stacked):
    diag_a = diag_a_names(eigen)
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(diag_a):
        out[name] = solve_eigen_entry(grad_mats[name], eigen[name], damping)
    shapes = {
        name: tuple(g.shape) for name, g in grad_mats.items() if name not in diag_a
    }
    for (go, ai), names in shape_groups(shapes).items():
        if len(names) == 1:
            out[names[0]] = solve_eigen_entry(grad_mats[names[0]], eigen[names[0]], damping)
            continue
        gm = torch.stack([grad_mats[n] for n in names])
        v = solve_eigen_entry(gm, _group_eigen(names, f"{go}x{ai}", eigen, stacked), damping)
        for row, name in enumerate(names):
            out[name] = v[row]
    return out


def _precondition_stack(gm: torch.Tensor, s: Dict[str, torch.Tensor], damping) -> torch.Tensor:
    """The oracle chain over one shape group's stack ``gm [k, g, a]`` and
    its stacked eigen state ``s``."""
    qa, qg, da, dg = s["QA"].float(), s["QG"].float(), s["dA"], s["dG"]
    v1 = (qg.transpose(1, 2) @ gm) @ qa
    v2 = v1 / (dg[:, :, None] * da[:, None, :] + damping)
    return (qg @ v2) @ qa.transpose(1, 2)


def precondition_all_with_vg(
    grad_mats: Dict[str, torch.Tensor],
    eigen: Dict[str, Dict[str, torch.Tensor]],
    damping,
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    *,
    kind: str = "auto",
    precision: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[List[torch.Tensor]]]:
    """:func:`precondition_all` + per-layer KL-clip partials, kernel-routed.

    ``kind="dense"`` delegates to the oracle :func:`precondition_all` and
    returns ``vg_terms=None`` (the caller then reduces ``Σ v·g`` with
    :func:`kl_clip_coefficient`). Otherwise every shape group of dense
    entries — singletons as ``k=1`` stacks — goes through the fused apply
    wrapper, which also emits each layer's ``Σ v·g``; diagonal-A layers and
    low-rank groups (a truncated side: the kernel computes only the full
    eigenbasis solve) take :func:`solve_eigen_entry` (at ``precision``) with
    their partials reduced in PyTorch, as the JAX package keeps them out of
    its kernel.
    ``vg_terms`` is in emission order, the order :func:`kl_clip_coefficient`
    would sum in.
    """
    if kind == "dense":
        return precondition_all(grad_mats, eigen, damping, stacked, precision), None
    diag_a = diag_a_names(eigen)
    out: Dict[str, torch.Tensor] = {}
    vg_terms: List[torch.Tensor] = []

    def plain(name, g, e):
        with rotation_precision(precision):
            v = solve_eigen_entry(g, e, damping)
        out[name] = v
        vg_terms.append((v.float() * g.float()).sum())

    for name in sorted(diag_a):
        plain(name, grad_mats[name], eigen[name])
    shapes = {
        name: tuple(g.shape) for name, g in grad_mats.items() if name not in diag_a
    }
    for (go, ai), names in shape_groups(shapes).items():
        if len(names) == 1 and entry_is_lowrank(eigen[names[0]]):
            plain(names[0], grad_mats[names[0]], eigen[names[0]])
            continue
        s = _group_eigen(names, f"{go}x{ai}", eigen, stacked)
        gm = torch.stack([grad_mats[n] for n in names])
        if entry_is_lowrank(s):
            with rotation_precision(precision):
                v = solve_eigen_entry(gm, s, damping)
            for row, name in enumerate(names):
                out[name] = v[row]
                vg_terms.append((v[row].float() * gm[row].float()).sum())
            continue
        v, vg = apply_kernels.dispatch_precondition_stack(
            gm, s["QA"], s["dA"], s["QG"], s["dG"], damping
        )
        for row, name in enumerate(names):
            out[name] = v[row]
            vg_terms.append(vg[row])
    return out, vg_terms


# ---------------------------------------------------------------------------
# Inverse method: π-corrected factored Tikhonov damping, explicit inverses
#
#     π  = sqrt( (tr(A)/dim A) / (tr(G)/dim G) )
#     iA = (A + π·√λ·I)⁻¹ ,  iG = (G + (√λ/π)·I)⁻¹
#     v  = iG · grad · iA                       (2 matmuls per step)
#
# The refresh is a batched Cholesky solve instead of an eigendecomposition;
# the damping takes effect at the next refresh. Cholesky and the triangular
# solves are library calls (cuSOLVER, cuBLAS), as they were XLA's in JAX.
# ---------------------------------------------------------------------------


def _spd_inverse_stack(stack: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse via Cholesky: ``[k, n, n] -> [k, n, n]``,
    symmetrized. ``cholesky_ex`` does not check the factorization, so the
    refresh does not wait for the device (a non-SPD input gives a wrong
    inverse, as ``lax.linalg.cholesky``'s NaNs do in JAX)."""
    k, n, _ = stack.shape
    eye = torch.eye(n, dtype=stack.dtype, device=stack.device).expand(k, n, n)
    chol, _ = torch.linalg.cholesky_ex(stack)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    inv = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    return 0.5 * (inv + inv.transpose(-1, -2))


def factored_inverse_all(
    factors: Dict[str, Dict[str, torch.Tensor]],
    damping,
    eps: float = 1e-10,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {'A', 'G'}} -> {layer: {'iA', 'iG'}}`` with π-corrected
    factored damping (above); a diagonal A (embedding) inverts elementwise
    into ``iA_diag``. Same-side factors batch into one Cholesky inverse per
    side length."""
    names = list(factors)
    first = factors[names[0]]["G"]
    sqrt_l = torch.sqrt(torch.as_tensor(damping, dtype=torch.float32, device=first.device))
    pis = {}
    for n in names:
        f = factors[n]
        if "A_diag" in f:
            tr_a = torch.clamp(torch.mean(f["A_diag"]), min=eps)
        else:
            tr_a = torch.clamp(torch.trace(f["A"]) / f["A"].shape[0], min=eps)
        tr_g = torch.clamp(torch.trace(f["G"]) / f["G"].shape[0], min=eps)
        pis[n] = torch.sqrt(tr_a / tr_g)

    jobs: Dict[int, list] = {}
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in names}
    for n in names:
        if "A_diag" in factors[n]:
            out[n]["iA_diag"] = 1.0 / (factors[n]["A_diag"].float() + pis[n] * sqrt_l)
        else:
            jobs.setdefault(factors[n]["A"].shape[0], []).append((n, "A"))
        jobs.setdefault(factors[n]["G"].shape[0], []).append((n, "G"))
    for side, batch in sorted(jobs.items()):
        stack = torch.stack([factors[n][f].float() for n, f in batch])
        damps = torch.stack(
            [pis[n] * sqrt_l if f == "A" else sqrt_l / pis[n] for n, f in batch]
        )
        eye = torch.eye(side, dtype=torch.float32, device=stack.device)
        inv = _spd_inverse_stack(stack + damps[:, None, None] * eye)
        for row, (n, f) in enumerate(batch):
            out[n]["iA" if f == "A" else "iG"] = inv[row]
    return out


def split_inv_state(
    inv: Dict[str, Dict[str, torch.Tensor]],
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """Inverse-method analog of :func:`split_eigen_state`: same-shape layers
    live only as stacked ``{'iA': [k,a,a], 'iG': [k,g,g]}`` groups."""
    return _split_state(inv, g_key="iG", a_key="iA")


def precondition_mat_inv(
    grad_mat: torch.Tensor, i_a: torch.Tensor, i_g: torch.Tensor
) -> torch.Tensor:
    """``v = iG · grad · iA`` — the 2-matmul inverse-method solve."""
    return (i_g.float() @ grad_mat) @ i_a.float()


def precondition_mat_inv_embed(
    grad_mat: torch.Tensor, i_a_diag: torch.Tensor, i_g: torch.Tensor
) -> torch.Tensor:
    """Inverse-method solve for a diagonal-A (embedding) layer:
    ``v = (iG · grad) ⊙ iA_diag``."""
    return (i_g.float() @ grad_mat) * i_a_diag[None, :]


def precondition_all_inv(
    grad_mats: Dict[str, torch.Tensor],
    inv: Dict[str, Dict[str, torch.Tensor]],
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    precision: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Inverse-method twin of :func:`precondition_all`: diagonal-A layers
    first in sorted order, then same-shape layers batched in
    :func:`shape_groups` order (the KL-clip summation order)."""
    with rotation_precision(precision):
        return _precondition_all_inv(grad_mats, inv, stacked)


def _precondition_all_inv(grad_mats, inv, stacked):
    diag_a = diag_a_names(inv)
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(diag_a):
        e = inv[name]
        out[name] = precondition_mat_inv_embed(grad_mats[name], e["iA_diag"], e["iG"])
    shapes = {
        name: tuple(g.shape) for name, g in grad_mats.items() if name not in diag_a
    }
    for (go, ai), names in shape_groups(shapes).items():
        if len(names) == 1:
            e = inv[names[0]]
            out[names[0]] = precondition_mat_inv(grad_mats[names[0]], e["iA"], e["iG"])
            continue
        gm = torch.stack([grad_mats[n] for n in names])
        key = f"{go}x{ai}"
        if stacked is not None and key in stacked:
            ia, ig = stacked[key]["iA"], stacked[key]["iG"]
        else:
            ia = torch.stack([inv[n]["iA"] for n in names])
            ig = torch.stack([inv[n]["iG"] for n in names])
        v = (ig.float() @ gm) @ ia.float()
        for row, name in enumerate(names):
            out[name] = v[row]
    return out


# ---------------------------------------------------------------------------
# Distributed preconditioning: each layer's solve on its owner rank
#
# ``owners`` (parallel.assignment.precondition_assignment) gives every layer
# one rank. A rank solves only the layers it owns, stacked by shape group as
# the replicated path stacks them, writes them into a zeroed flat buffer of
# every layer's update, and one all_reduce (sum of zeros) reassembles the
# buffer on every rank: exact up to the downcast when ``comm_dtype`` is set,
# since each element has one owner. Updates come back in the replicated
# path's emission order, the KL clip's summation order.
# ---------------------------------------------------------------------------


def _emission_order(grad_mats: Dict[str, torch.Tensor], diag_a: set) -> List[str]:
    """Diagonal-A layers in sorted order, then :func:`shape_groups`' order."""
    shapes = {n: tuple(g.shape) for n, g in grad_mats.items() if n not in diag_a}
    return sorted(diag_a) + [n for names in shape_groups(shapes).values() for n in names]


def _owned_rows(names, rows, key, state, stacked):
    """Rows ``rows`` of one shape group's stacked state: the ``stacked``
    group sliced (only the owner pays the copy), or the per-layer entries
    stacked."""
    if len(names) > 1 and stacked is not None and key in stacked:
        group = stacked[key]
        if len(rows) == len(names):
            return group
        idx = torch.tensor(rows, device=next(iter(group.values())).device)
        return {k: v.index_select(0, idx) for k, v in group.items()}
    return {k: torch.stack([state[names[r]][k] for r in rows]) for k in state[names[0]]}


def _apply_distributed(
    grad_mats: Dict[str, torch.Tensor],
    state: Dict[str, Dict[str, torch.Tensor]],
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]],
    world: World,
    owners: Dict[str, int],
    solve_diag,
    solve_group,
    comm_dtype: Optional[torch.dtype],
) -> Dict[str, torch.Tensor]:
    """The owner-sharded skeleton. ``solve_diag(g, entry)`` solves one
    diagonal-A layer; ``solve_group(gm [k, g, a], group state) -> [k, g, a]``
    one shape group's owned rows."""
    diag_a = diag_a_names(state)
    order = _emission_order(grad_mats, diag_a)
    local: Dict[str, torch.Tensor] = {}
    for name in sorted(diag_a):
        if owners[name] == world.rank:
            local[name] = solve_diag(grad_mats[name], state[name])
    shapes = {n: tuple(g.shape) for n, g in grad_mats.items() if n not in diag_a}
    for (go, ai), names in shape_groups(shapes).items():
        rows = [r for r, n in enumerate(names) if owners[n] == world.rank]
        if not rows:
            continue
        gm = torch.stack([grad_mats[names[r]] for r in rows])
        v = solve_group(gm, _owned_rows(names, rows, f"{go}x{ai}", state, stacked))
        for j, r in enumerate(rows):
            local[names[r]] = v[j]
    sizes = [grad_mats[n].numel() for n in order]
    first = grad_mats[order[0]]
    flat = first.new_zeros(sum(sizes), dtype=comm_dtype or torch.float32)
    for n, part in zip(order, flat.split(sizes)):
        if n in local:
            part.copy_(local[n].reshape(-1))
    world.all_reduce_sum_(flat)
    flat = flat.float()
    return {n: part.view(grad_mats[n].shape) for n, part in zip(order, flat.split(sizes))}


def precondition_all_distributed(
    grad_mats: Dict[str, torch.Tensor],
    eigen: Dict[str, Dict[str, torch.Tensor]],
    damping,
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    precision: Optional[str] = None,
    *,
    world: World,
    owners: Dict[str, int],
    comm_dtype: Optional[torch.dtype] = None,
    kind: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Eigenbasis preconditioning with the rotations sharded over the ranks
    (the JAX package's ``precondition_all_distributed``; the reference
    rotates every layer on every rank, kfac_preconditioner.py:401-404).

    The owned rows of a shape group of dense entries go through the fused
    apply wrapper (kernel 3 on CUDA tensors, its plain version on CPU ones;
    the JAX package's ``solve_eigen_entry_maybe_fused``) unless
    ``kind="dense"``, which takes the oracle chain at ``precision``;
    diagonal-A layers and low-rank groups take :func:`solve_eigen_entry`.
    The kernel's KL-clip partials cover the owned layers only and are
    dropped: the caller reduces ν from the reassembled updates, as the JAX
    package does.
    ``comm_dtype`` (``torch.bfloat16``) is the exchange's wire type.
    """

    def solve_diag(g, e):
        with rotation_precision(precision):
            return solve_eigen_entry(g, e, damping)

    def solve_group(gm, s):
        if kind != "dense" and not entry_is_lowrank(s):
            v, _ = apply_kernels.dispatch_precondition_stack(
                gm, s["QA"], s["dA"], s["QG"], s["dG"], damping
            )
            return v
        with rotation_precision(precision):
            return solve_eigen_entry(gm, s, damping)

    return _apply_distributed(
        grad_mats, eigen, stacked, world, owners, solve_diag, solve_group, comm_dtype
    )


def precondition_all_inv_distributed(
    grad_mats: Dict[str, torch.Tensor],
    inv: Dict[str, Dict[str, torch.Tensor]],
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    precision: Optional[str] = None,
    *,
    world: World,
    owners: Dict[str, int],
    comm_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The inverse method's owner-sharded solve (:func:`precondition_all_inv`
    per owned layer, one exchange)."""

    def solve_diag(g, e):
        with rotation_precision(precision):
            return precondition_mat_inv_embed(g, e["iA_diag"], e["iG"])

    def solve_group(gm, s):
        with rotation_precision(precision):
            return (s["iG"].float() @ gm) @ s["iA"].float()

    return _apply_distributed(
        grad_mats, inv, stacked, world, owners, solve_diag, solve_group, comm_dtype
    )


# ---------------------------------------------------------------------------
# Owner-sharded preconditioning (factor_sharding="owner", DP-KFAC)
#
# Each layer's eigenbasis lives only in its owner's rows of the eigen shard
# stacks. The owner solves it, packs the flat result into its slice of a
# uniform float32 buffer, and ONE all_gather replicates every rank's buffer.
# A layer whose compact truncated tables (Q/d/rho) are smaller than its
# update ships the tables instead, and every rank solves it after the
# gather.
# ---------------------------------------------------------------------------


def _elems(shape: Tuple[int, ...]) -> int:
    size = 1
    for d in shape:
        size *= int(d)
    return size


def _owner_gather_layout(
    shapes: Dict[str, Tuple[int, int]],
    owners: Dict[str, int],
    world: int,
    rank_fn,
    diag_a: set = frozenset(),
) -> Tuple[List[str], Dict[str, Dict[str, Any]], int]:
    """The gather buffer's layout: ``(order, segments, width)``. ``order``
    is :func:`precondition_all`'s emission order (the KL clip's summation
    order); ``segments[name]`` holds the payload's ``mode`` (``"update"``,
    the ``[g, a]`` update, or ``"tables"``, the fields of the entry when a
    diagonal-A or truncated side makes them fewer elements), its ``offset``
    in the owner's slice, its ``elems`` and the table ``fields``; ``width``
    is the widest rank's payload (at least 1)."""
    order = sorted(diag_a) + [
        n for names in shape_groups(
            {k: v for k, v in shapes.items() if k not in diag_a}).values() for n in names
    ]
    segments: Dict[str, Dict[str, Any]] = {}
    cursor = [0] * world
    for name in order:
        g, a = int(shapes[name][0]), int(shapes[name][1])
        diag = name in diag_a
        ra = rank_fn(a) if rank_fn is not None and not diag else None
        rg = rank_fn(g) if rank_fn is not None else None
        if diag:
            fields = [("dA", (a,))]
        else:
            fields = [("QA", (a, ra) if ra is not None else (a, a)),
                      ("dA", (ra,) if ra is not None else (a,))]
            if ra is not None:
                fields.append(("rhoA", ()))
        fields += [("QG", (g, rg) if rg is not None else (g, g)),
                   ("dG", (rg,) if rg is not None else (g,))]
        if rg is not None:
            fields.append(("rhoG", ()))
        table_elems = sum(_elems(shp) for _, shp in fields)
        mode = (
            "tables" if (diag or ra is not None or rg is not None) and table_elems < g * a
            else "update"
        )
        elems = table_elems if mode == "tables" else g * a
        owner = owners[name]
        segments[name] = {"mode": mode, "offset": cursor[owner], "elems": elems,
                          "fields": tuple(fields)}
        cursor[owner] += elems
    return order, segments, max(1, max(cursor))


def _owner_entry(eigen_shard, plan, name: str, shape: Tuple[int, int]):
    """A layer's eigen entry from this rank's shard rows (its owner's)."""
    g_n, a_n = shape
    out = {}
    for fac, n in (("A", a_n), ("G", g_n)):
        slot = plan.slot(name, fac)
        if slot.diag:
            out[f"d{fac}"] = eigen_shard[f"v{n}"]["d"][slot.row]
            continue
        grp = eigen_shard[f"n{n}"]
        out[f"Q{fac}"] = grp["Q"][slot.row]
        out[f"d{fac}"] = grp["d"][slot.row]
        if "rho" in grp:
            out[f"rho{fac}"] = grp["rho"][slot.row]
    return out


def _owner_group_entry(eigen_shard, plan, names, shape):
    """The stacked eigen entry of owned layers of one shape: each field's
    rows picked from the shard stacks by one ``index_select``."""
    g_n, a_n = shape
    out = {}
    for fac, n in (("A", a_n), ("G", g_n)):
        grp = eigen_shard[f"n{n}"]
        idx = torch.tensor([plan.slot(name, fac).row for name in names],
                           device=grp["d"].device)
        for key, v in grp.items():  # Q, d, rho → QA, dA, rhoA (or G)
            out[key + fac] = v.index_select(0, idx)
    return out


def precondition_all_owner(
    grad_mats: Dict[str, torch.Tensor],
    eigen_shard: Dict[str, Dict[str, torch.Tensor]],
    damping,
    precision: Optional[str] = None,
    *,
    world: World,
    plan,
    rank_fn=None,
    eigen_dtype: torch.dtype = torch.float32,
    kind: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Owner-sharded preconditioning: each rank solves the layers it owns,
    from its rows of ``eigen_shard``, and one ``all_gather`` replicates the
    results (the JAX package's ``precondition_all_owner``).

    The owned layers of one shape whose entries are dense go through the
    fused apply wrapper together, one stack per shape group (kernel 3 on
    CUDA tensors, its plain version on CPU ones; ``kind="dense"`` takes the
    oracle chain at ``precision``); the rest take :func:`solve_eigen_entry`.
    A ``"tables"`` layer (:func:`_owner_gather_layout`) ships its Q/d/rho,
    and every rank solves it after the gather with ``Q`` cast back to
    ``eigen_dtype``, the bits its owner holds. The kernel's KL-clip
    partials cover the owned layers only and are dropped: the caller
    reduces ν from the gathered updates, which come back in emission order.
    """
    if world.size != plan.world:
        raise ValueError(f"shard plan world {plan.world} != the world's {world.size} ranks")
    shapes = {n: (g.shape[0], g.shape[1]) for n, g in grad_mats.items()}
    diag_a = {s.name for s in plan.slots if s.factor == "A" and s.diag}
    order, segments, width = _owner_gather_layout(shapes, plan.owners, plan.world, rank_fn,
                                                  diag_a)
    get_telemetry().set_gauge("kfac/precond_allgather_bytes", plan.world * width * 4)
    first = grad_mats[order[0]]
    buf = first.new_zeros(width, dtype=torch.float32)

    def put(name, flat):
        seg = segments[name]
        buf[seg["offset"]:seg["offset"] + seg["elems"]] = flat

    def solve(g, e):
        with rotation_precision(precision):
            return solve_eigen_entry(g, e, damping)

    mine = [n for n in order if plan.owners[n] == world.rank]
    updates = []
    for name in mine:
        seg = segments[name]
        if seg["mode"] == "tables":
            entry = _owner_entry(eigen_shard, plan, name, shapes[name])
            put(name, torch.cat([entry[k].float().reshape(-1) for k, _ in seg["fields"]]))
        elif name in diag_a:
            put(name, solve(grad_mats[name], _owner_entry(eigen_shard, plan, name,
                                                          shapes[name])).reshape(-1))
        else:
            updates.append(name)
    for shape, names in shape_groups({n: shapes[n] for n in updates}).items():
        gm = torch.stack([grad_mats[n] for n in names])
        s = _owner_group_entry(eigen_shard, plan, names, shape)
        if kind != "dense" and not entry_is_lowrank(s):
            v, _ = apply_kernels.dispatch_precondition_stack(
                gm, s["QA"], s["dA"], s["QG"], s["dG"], damping
            )
        else:
            v = solve(gm, s)
        for row, name in enumerate(names):
            put(name, v[row].reshape(-1))
    # the owner mode's one collective of the apply
    gathered = world.all_gather_flat(buf)
    out: Dict[str, torch.Tensor] = {}
    for name in order:
        seg = segments[name]
        payload = gathered[plan.owners[name], seg["offset"]:seg["offset"] + seg["elems"]]
        if seg["mode"] == "update":
            out[name] = payload.view(shapes[name])
            continue
        entry, off = {}, 0
        for k, shp in seg["fields"]:
            val = payload[off:off + _elems(shp)].reshape(shp)
            off += _elems(shp)
            entry[k] = val.to(eigen_dtype) if k.startswith("Q") else val
        out[name] = solve(grad_mats[name], entry)
    return out


def _lr_squared(lr):
    """``lr²`` rounded as the reference computes it: in float32. A 0-d
    tensor ``lr`` gives a float32 product on its device (the same bits as
    the float's, with no host read); a float gives a float."""
    if isinstance(lr, torch.Tensor):
        lr32 = lr.to(torch.float32)
        return lr32 * lr32
    lr32 = np.float32(lr)
    return float(lr32 * lr32)


def _nu(vg_sum: torch.Tensor, kl_clip: float) -> torch.Tensor:
    denom = torch.clamp(vg_sum.abs(), min=1e-30)
    return torch.clamp(torch.sqrt(kl_clip / denom), max=1.0)


def kl_clip_from_vg(
    vg_terms: List[torch.Tensor], lr, kl_clip: float
) -> torch.Tensor:
    """:func:`kl_clip_coefficient` from the per-layer partials the fused apply
    emitted: same left-to-right float32 sum, ``lr²`` per term, 1e-30 floor."""
    lr2 = _lr_squared(lr)
    vg_sum = torch.zeros((), dtype=torch.float32, device=vg_terms[0].device)
    for t in vg_terms:
        vg_sum = vg_sum + t.float() * lr2
    return _nu(vg_sum, kl_clip)


def kl_clip_coefficient(
    updates: Dict[str, torch.Tensor],
    grad_mats: Dict[str, torch.Tensor],
    lr,
    kl_clip: float,
) -> torch.Tensor:
    """Global trust-region scale ``ν = min(1, sqrt(kl_clip / |Σ v·g·lr²|))``."""
    lr2 = _lr_squared(lr)
    first = next(iter(updates.values()))
    vg_sum = torch.zeros((), dtype=torch.float32, device=first.device)
    for name, v in updates.items():
        vg_sum = vg_sum + (v.float() * grad_mats[name].float()).sum() * lr2
    return _nu(vg_sum, kl_clip)
