"""Shard lens algebra: K-FAC for sharded-parameter (tensor-parallel, MoE)
kernels.

Port of ``kfac_pytorch_tpu/shardwise/lenses.py`` (the state layouts, the
EMAs, the refresh, the solves, and the placement rules of the 3-D
data×fsdp×tensor world: :func:`factor_leaf_spec`,
:func:`lm_param_shardings`, :func:`state_bytes_local`). The
subsystem behind the ``#c{T}``/``#r{T}``/``#e{E}`` layer names
(``capture.split_shard_name``), after *KFAC for Modern Neural Network
Architectures* (arxiv 2311.00636) generalized to sharded kernels:

* **column-sharded** (``#cT``, the ``[m, a]`` weight split along m): every
  shard reads the whole input, so ONE A ``[a(+1), a(+1)]``; the shards'
  outputs are disjoint, so G is exactly block-diagonal, a
  ``[T, m/T, m/T]`` stack, each block solved against the shared A basis;
* **row-sharded** (``#rT``, the weight split along a): each shard reads its
  own input slice, so an A stack ``[T, a/T, a/T]``; the output gradient is
  the same on every shard, so ONE G ``[m, m]``;
* **MoE expert bank** (``#eE``, the ``[E, a, m]`` bank): per-expert A and G
  stacks with token-count-weighted EMAs (:func:`moe_ema`).

Factors keep the ``{"A", "G"}`` keys at stacked shapes; eigen entries take
FORM-PREFIXED keys (``cQA``/``cdA``/…, ``rQA``/…, ``eQA``/…), so the
singles/stacked split, the diagonal-A detection and the fused apply's
shape groups (``ops/precondition.py``) leave them alone. They always
refresh densely, in float32 (a batched ``torch.linalg.eigh`` over the
stack), on every rank, and they solve with a batched ``torch.matmul``
chain: in the JAX package too these solves are a ``vmap`` of the plain
eigenbasis solve, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.ops import factors as factor_ops
from kfac_pytorch_tpu_torch.ops.eigh import symmetrize

# Form-prefixed eigen keys: {form: (QA, dA, QG, dG)}.
EIGEN_KEYS = {
    "c": ("cQA", "cdA", "cQG", "cdG"),
    "r": ("rQA", "rdA", "rQG", "rdG"),
    "e": ("eQA", "edA", "eQG", "edG"),
}

# the dense refresh's eigenvalue floor
_EIG_EPS = 1e-10

# Token-fraction floor of the expert normalization: an expert with f_e = 0
# gets a zero batch statistic and the EMA weight alpha**0 = 1 (its history
# untouched); the floor only guards the 0/0.
_MOE_TINY = 1e-12


def shard_entries(names: List[str]) -> Dict[str, Tuple[str, str, int]]:
    """``{name: (base, form, count)}`` for every shard-lens name in ``names``."""
    from kfac_pytorch_tpu_torch import capture

    out = {}
    for n in names:
        base, form, count = capture.split_shard_name(n)
        if form is not None:
            out[n] = (base, form, count)
    return out


def has_shard_lens(names: List[str]) -> bool:
    """Any column- or row-sharded (``#c``/``#r``) layer present?"""
    return any(f in ("c", "r") for _, f, _ in shard_entries(names).values())


def has_moe(names: List[str]) -> bool:
    """Any MoE expert bank (``#e``) present?"""
    return any(f == "e" for _, f, _ in shard_entries(names).values())


# ---------------------------------------------------------------------------
# State initialization
# ---------------------------------------------------------------------------


def _eye_stack(count: int, n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).expand(count, n, n).clone()


def identity_factors(form: str, count: int, weight_shape: Tuple[int, ...], has_bias: bool,
                     device=None) -> Dict[str, torch.Tensor]:
    """Identity factor stacks of one shard-lens layer (the dense layers'
    ``eye`` init). ``weight_shape`` is PyTorch's: ``[m, a]`` for column and
    row layers, the bank's ``[E, a, m]`` for MoE."""
    if form == "c":
        m, a_in = weight_shape
        return {"A": torch.eye(a_in + int(has_bias), dtype=torch.float32, device=device),
                "G": _eye_stack(count, m // count, device)}
    if form == "r":
        m, a_in = weight_shape
        return {"A": _eye_stack(count, a_in // count, device),
                "G": torch.eye(m, dtype=torch.float32, device=device)}
    if form == "e":
        _, a_in, m = weight_shape
        return {"A": _eye_stack(count, a_in, device), "G": _eye_stack(count, m, device)}
    raise ValueError(f"unknown shard form {form!r}")


def identity_eigen(form: str, facs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Identity eigenbases matching :func:`identity_factors` (Q = I, d = 1)."""
    qa_k, da_k, qg_k, dg_k = EIGEN_KEYS[form]
    a_f, g_f = facs["A"], facs["G"]

    def eye_like(f):
        n = f.shape[-1]
        return torch.eye(n, dtype=torch.float32, device=f.device).expand(f.shape).clone()

    return {
        qa_k: eye_like(a_f),
        da_k: torch.ones(a_f.shape[:-1], dtype=torch.float32, device=a_f.device),
        qg_k: eye_like(g_f),
        dg_k: torch.ones(g_f.shape[:-1], dtype=torch.float32, device=g_f.device),
    }


def is_shard_eigen_entry(entry: Dict[str, torch.Tensor]) -> bool:
    """Whether an eigen-state entry carries form-prefixed shardwise keys."""
    return any(keys[0] in entry for keys in EIGEN_KEYS.values())


# ---------------------------------------------------------------------------
# Factor EMA
# ---------------------------------------------------------------------------


def ema_update(form: str, current: Dict[str, torch.Tensor], a_new: Any,
               g_new: torch.Tensor, alpha: float) -> Dict[str, torch.Tensor]:
    """One factor-EMA step of a shard-lens layer: column and row stacks
    elementwise (``update_running_avg`` broadcasts over the stack; linear,
    so the deferred flush stays exact), MoE through :func:`moe_ema`."""
    if form == "e":
        return moe_ema(current, a_new, g_new, alpha)
    return {
        "A": factor_ops.update_running_avg(a_new, current["A"], alpha),
        "G": factor_ops.update_running_avg(g_new, current["G"], alpha),
    }


def moe_ema(current: Dict[str, torch.Tensor], a_new: Dict[str, torch.Tensor],
            g_new: torch.Tensor, alpha: float) -> Dict[str, torch.Tensor]:
    """Token-count-weighted per-expert EMA.

    ``a_new`` is the capture pair ``{"S": [E, a, a], "f": [E]}``: the
    unnormalized covariance sums (global ``1/N``) and the token fractions,
    both linear in per-token contributions, so the ranks' mean of the pair
    commutes with this normalization::

        A_batch_e = S_e / max(f_e, tiny)
        α_e       = α ** (f_e · E)          (float32; α at uniform routing)
        A'_e      = α_e · A_e + (1 − α_e) · A_batch_e

    and the same for G. An expert that saw no tokens has ``α_e = 1``: its
    history is kept bit for bit."""
    s, f = a_new["S"], a_new["f"]
    e = f.shape[0]
    denom = torch.clamp(f, min=_MOE_TINY)[:, None, None]
    a_batch = s / denom
    g_batch = g_new / denom
    # filled on the device: a host-to-device copy would stop a CUDA-graph
    # capture of the step
    alpha_e = torch.pow(torch.full((), alpha, dtype=torch.float32, device=f.device), f * e)
    ae = alpha_e[:, None, None]
    return {
        "A": ae * current["A"] + (1.0 - ae) * a_batch,
        "G": ae * current["G"] + (1.0 - ae) * g_batch,
    }


# ---------------------------------------------------------------------------
# Eigen refresh
# ---------------------------------------------------------------------------


def _eigh_floored(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Batched) symmetric eigh with the dense refresh's eigenvalue floor."""
    d, q = torch.linalg.eigh(symmetrize(x.float()))
    return q, d * (d > _EIG_EPS).to(d.dtype)


def eigen_refresh(form: str, facs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One shard-lens layer's eigen entry from its factor stacks: always
    the dense decomposition, batched over the stack, in float32. The blocks
    are ``1/T``-sized or per expert, so there is no whole-factor eigh spike
    to chunk, truncate or stream, which is why those levers refuse
    shard-lens layers (the shard-lens rows of ``planner.RULES``)."""
    qa_k, da_k, qg_k, dg_k = EIGEN_KEYS[form]
    qa, da = _eigh_floored(facs["A"])
    qg, dg = _eigh_floored(facs["G"])
    return {qa_k: qa, da_k: da, qg_k: qg, dg_k: dg}


# ---------------------------------------------------------------------------
# Preconditioning
# ---------------------------------------------------------------------------


def _solve(g, qa, qg, da, dg, damping):
    """``QG·[(QGᵀ·g·QA)/(dG dAᵀ + λ)]·QAᵀ``, batched over the leading dims
    (``ops.precondition.precondition_mat``'s arithmetic)."""
    v1 = (qg.transpose(-1, -2) @ g) @ qa
    v2 = v1 / (dg[..., :, None] * da[..., None, :] + damping)
    return (qg @ v2) @ qa.transpose(-1, -2)


def precondition(form: str, count: int, grad_mat: torch.Tensor,
                 entry: Dict[str, torch.Tensor], damping) -> torch.Tensor:
    """Apply the shard-lens ``(G ⊗ A + λI)⁻¹`` to one layer's grad mat.

    Shapes in and out are ``capture.grad_mats``': ``[m, a(+1)]`` for column
    and row layers (the shard blocks split and merged here, in factor
    space), ``[E, m, a]`` for MoE (one solve per expert)."""
    qa_k, da_k, qg_k, dg_k = EIGEN_KEYS[form]
    qa, da, qg, dg = entry[qa_k], entry[da_k], entry[qg_k], entry[dg_k]
    if form == "c":
        m, sa = grad_mat.shape
        gm = grad_mat.reshape(count, m // count, sa)
        return _solve(gm, qa, qg, da, dg, damping).reshape(m, sa)
    if form == "r":
        m, a_in = grad_mat.shape
        gm = grad_mat.reshape(m, count, a_in // count).transpose(0, 1)  # [T, m, a/T]
        v = _solve(gm, qa, qg, da, dg, damping)
        return v.transpose(0, 1).reshape(m, a_in)
    if form == "e":
        return _solve(grad_mat, qa, qg, da, dg, damping)
    raise ValueError(f"unknown shard form {form!r}")


# ---------------------------------------------------------------------------
# Placement on the data×fsdp×tensor world
# ---------------------------------------------------------------------------

# A placement is where one tensor of the one-process layout lives on the 3-D
# world: ``None`` (replicated), ``("tensor", d)`` (dim ``d`` split over the
# tensor slots, in slot order) or ``FSDP`` (the flattened tensor split into
# ``F`` contiguous equal parts over the fsdp slots: the JAX rule splits the
# flax leaf's leading dim, which may be another dim of the port's tensor,
# and the flat split stores the same bytes per rank).
FSDP = ("fsdp", None)

# the factor/eigen keys a genuine tensor axis splits, by form: a column
# layer's G side, a row layer's A side
TENSOR_SPLIT_KEYS = {"c": ("G", "cQG", "cdG"), "r": ("A", "rQA", "rdA"), "e": ()}


def factor_leaf_spec(name: str, key: str, leaf_shape: Tuple[int, ...],
                     tensor_size: int) -> Optional[Tuple[str, int]]:
    """Placement of one shardwise factor/eigen leaf of the one-process
    layout (``leaf_shape`` the whole stack's) on a world with
    ``tensor_size`` tensor slots (the JAX ``factor_leaf_spec``): column
    layers split the G-side stacks over the tensor axis (each slot holds the
    blocks of its kernel shard), row layers the A-side stacks; replicated
    otherwise, and whenever the stack dim does not divide by the tensor
    axis."""
    from kfac_pytorch_tpu_torch import capture

    _, form, count = capture.split_shard_name(name)
    if form is None or tensor_size <= 1:
        return None
    if not leaf_shape or leaf_shape[0] != count or count % tensor_size:
        return None
    return ("tensor", 0) if key in TENSOR_SPLIT_KEYS[form] else None


def lm_param_shardings(shapes: Dict[str, Tuple[int, ...]], names: List[str],
                       tensor_size: int, fsdp_size: int) -> Dict[str, Any]:
    """``{parameter: placement}`` of the transformer LM's one-process
    parameters (``shapes``, by ``named_parameters`` name) on the 3-D world
    (the JAX ``lm_param_shardings``), decided by the JAX rule on the flax
    leaf's shape (``interop.lm_jax_leaf_shape``): a column kernel splits
    its output features over the tensor axis (the port's ``[m, a]`` weight
    along dim 0, and its bias), a row kernel its input features (dim 1),
    each only where the split dim divides; every other parameter (MoE banks
    included) splits over the fsdp axis where its flax leading dim divides
    and it holds at least ``2·F`` values (:data:`FSDP`); the rest
    replicate. Flax hands a layer the whole gathered value, so capture sees
    whole parameters (capture at the allgather point)."""
    from kfac_pytorch_tpu_torch.interop import lm_jax_leaf_shape

    tensor_dims = {}
    if tensor_size > 1:
        for base, form, _ in shard_entries(names).values():
            if form == "c":
                tensor_dims[f"{base}.weight"] = tensor_dims[f"{base}.bias"] = 0
            elif form == "r":
                tensor_dims[f"{base}.weight"] = 1
    out: Dict[str, Any] = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if name in tensor_dims:
            d = tensor_dims[name]
            out[name] = ("tensor", d) if len(shape) > d and shape[d] % tensor_size == 0 else None
            continue
        jshape = lm_jax_leaf_shape(name, shape)
        if (fsdp_size > 1 and jshape and jshape[0] % fsdp_size == 0
                and math.prod(jshape) >= 2 * fsdp_size):
            out[name] = FSDP
        else:
            out[name] = None
    return out


def _placement_divisor(placement, tensor_size: int, fsdp_size: int) -> int:
    """How many ranks share one copy of a tensor under ``placement``."""
    if placement is None:
        return 1
    return tensor_size if placement[0] == "tensor" else fsdp_size


def state_bytes_local(tensors: Dict[str, Any], placements: Dict[str, Any],
                      tensor_size: int, fsdp_size: int) -> int:
    """Per-rank bytes of one-process ``tensors`` (``{name: tensor}``)
    under ``placements`` (the JAX ``state_bytes_local``): each tensor's
    bytes divided by the ranks its placement splits it over."""
    return sum(
        t.numel() * t.element_size()
        // _placement_divisor(placements.get(n), tensor_size, fsdp_size)
        for n, t in tensors.items()
    )


def local_part(t: torch.Tensor, placement, world) -> torch.Tensor:
    """``world``'s rank's part of the one-process tensor ``t`` under
    ``placement`` (a view where it can be)."""
    if placement is None:
        return t
    if placement[0] == "tensor":
        return t.chunk(world.tensor_size, dim=placement[1])[world.tensor_rank]
    return t.reshape(-1).chunk(world.fsdp_size)[world.fsdp_rank]


def global_part(t: torch.Tensor, placement, world, shape=None) -> torch.Tensor:
    """The one-process tensor from every rank's ``t`` under ``placement``
    (the inverse of :func:`local_part`; ``shape`` the whole tensor's, for
    :data:`FSDP`): one gather on the placement's subgroup, which every rank
    of it must enter."""
    if placement is None:
        return t
    if placement[0] == "tensor":
        return world.tensor_all_gather(t, placement[1])
    return world.fsdp_all_gather_flat(t).view(shape)
