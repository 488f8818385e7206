"""Natural-gradient preconditioning in the Kronecker eigenbasis + KL clipping.

Port of the eigen half of ``kfac_pytorch_tpu/ops/precondition.py`` for the
main path (full-eigen dense entries; no diagonal-A, low-rank or
distributed forms). Same-shape layers are stacked and preconditioned
together; the stack row order and the KL-clip summation order both follow
:func:`shape_groups`' insertion order, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch.ops import apply_kernels


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
    v1 = (q_g.T @ grad_mat) @ q_a
    v2 = v1 / (d_g[:, None] * d_a[None, :] + damping)
    return (q_g @ v2) @ q_a.T


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
        return {k: e[k][None] for k in ("QA", "QG", "dA", "dG")}
    if stacked is not None and key in stacked:
        return stacked[key]
    keys = eigen[names[0]].keys()
    return {k: torch.stack([eigen[n][k] for n in names]) for k in keys}


def precondition_all(
    grad_mats: Dict[str, torch.Tensor],
    eigen: Dict[str, Dict[str, torch.Tensor]],
    damping,
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Dict[str, torch.Tensor]:
    """Precondition every layer's gradient matrix, batching same-shape layers
    (the oracle chain: four batched matmuls and the damped divide)."""
    out: Dict[str, torch.Tensor] = {}
    shapes = {name: tuple(g.shape) for name, g in grad_mats.items()}
    for (go, ai), names in shape_groups(shapes).items():
        if len(names) == 1:
            name = names[0]
            e = eigen[name]
            out[name] = precondition_mat(
                grad_mats[name], e["QA"], e["QG"], e["dA"], e["dG"], damping
            )
            continue
        gm = torch.stack([grad_mats[n] for n in names])
        s = _group_eigen(names, f"{go}x{ai}", eigen, stacked)
        qa, qg, da, dg = s["QA"], s["QG"], s["dA"], s["dG"]
        v1 = (qg.transpose(1, 2) @ gm) @ qa
        v2 = v1 / (dg[:, :, None] * da[:, None, :] + damping)
        v = (qg @ v2) @ qa.transpose(1, 2)
        for row, name in enumerate(names):
            out[name] = v[row]
    return out


def precondition_all_with_vg(
    grad_mats: Dict[str, torch.Tensor],
    eigen: Dict[str, Dict[str, torch.Tensor]],
    damping,
    stacked: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    *,
    kind: str = "auto",
) -> Tuple[Dict[str, torch.Tensor], Optional[List[torch.Tensor]]]:
    """:func:`precondition_all` + per-layer KL-clip partials, kernel-routed.

    ``kind="dense"`` delegates to the oracle :func:`precondition_all` and
    returns ``vg_terms=None`` (the caller then reduces ``Σ v·g`` with
    :func:`kl_clip_coefficient`). Otherwise every shape group — singletons
    as ``k=1`` stacks — goes through the fused apply wrapper, which also
    emits each layer's ``Σ v·g``; ``vg_terms`` is in emission order, the
    order :func:`kl_clip_coefficient` would sum in.
    """
    if kind == "dense":
        return precondition_all(grad_mats, eigen, damping, stacked), None
    out: Dict[str, torch.Tensor] = {}
    vg_terms: List[torch.Tensor] = []
    shapes = {name: tuple(g.shape) for name, g in grad_mats.items()}
    for (go, ai), names in shape_groups(shapes).items():
        s = _group_eigen(names, f"{go}x{ai}", eigen, stacked)
        gm = torch.stack([grad_mats[n] for n in names])
        v, vg = apply_kernels.dispatch_precondition_stack(
            gm, s["QA"], s["dA"], s["QG"], s["dG"], damping
        )
        for row, name in enumerate(names):
            out[name] = v[row]
            vg_terms.append(vg[row])
    return out, vg_terms


def _lr_squared(lr) -> float:
    """``lr²`` rounded as the reference computes it: in float32."""
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
