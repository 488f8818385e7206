"""The eigen refresh: replicated on one device, or sharded over the ranks.

Port of ``kfac_pytorch_tpu/parallel/sharded_eigh.py`` (``build_slots``,
``_owner_tables``, ``_assemble``, ``replicated_eigen_update``,
``sharded_eigen_update``). Each (layer, factor, block) job is a slot;
slots of equal size are stacked and decomposed by ONE batched
``torch.linalg.eigh`` call at their own size (no −1 padding to shared
buckets: that existed to bound XLA compile cost).

Over ``world`` ranks (:func:`sharded_eigen_update`) each rank decomposes
only the slots the round-robin table (``parallel/assignment.py``) gives
it, and one ``all_reduce`` per slot size reassembles every slot on every
rank: the reference's "allgather via sum of zeros"
(kfac_preconditioner.py:196-255, 421-437) and the JAX package's ``psum``.
Each element has one owner, so the sum adds only zeros to it and is
exact. One collective per size group, where per-owner broadcasts would
move about half the bytes (a ring ``all_reduce`` sends each element
twice) in ``world`` collectives: the refresh runs once per
``kfac_update_freq`` steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.ops.eigh import eigh_with_floor, get_block_boundary
from kfac_pytorch_tpu_torch.parallel.mesh import World

Assignment = Dict[str, Dict[str, Tuple[int, ...]]]


@dataclasses.dataclass(frozen=True)
class EighSlot:
    """One eigendecomposition job: a diagonal block of one layer's factor."""

    name: str
    factor: str  # "A" or "G"
    start: int  # block row range within the factor
    stop: int
    owner: int = 0  # owning rank (always 0 on one device)

    @property
    def size(self) -> int:
        return self.stop - self.start


def build_slots(
    factors: Dict[str, Dict[str, torch.Tensor]],
    assignment: Optional[Assignment] = None,
    blocks_per_layer: Optional[Dict[str, int]] = None,
) -> List[EighSlot]:
    """Expand factors into per-block jobs (block count capped at the side).

    With an ``assignment`` table the block counts and owners come from its
    rank tuples; without one ``blocks_per_layer`` gives the counts and rank
    0 owns everything."""
    slots: List[EighSlot] = []
    for name in factors:
        for fac in ("A", "G"):
            if fac not in factors[name]:
                continue  # a diagonal-A (embedding) layer has no A matrix
            n = factors[name][fac].shape[0]
            if assignment is not None:
                owners = assignment[name][fac]
            else:
                owners = (0,) * (blocks_per_layer or {}).get(name, 1)
            nb = min(len(owners), n)
            for b in range(nb):
                (r0, _), (r1, _) = get_block_boundary(b, nb, (n, n))
                slots.append(EighSlot(name, fac, r0, r1, owners[b]))
    return slots


def _size_groups(slots: List[EighSlot]) -> Dict[int, List[int]]:
    """Slot indices by block size, sizes ascending."""
    by_size: Dict[int, List[int]] = {}
    for i, s in enumerate(slots):
        by_size.setdefault(s.size, []).append(i)
    return dict(sorted(by_size.items()))


def _block(factors, s: EighSlot) -> torch.Tensor:
    return factors[s.name][s.factor][s.start : s.stop, s.start : s.stop].float()


def _owner_tables(slots: List[EighSlot], idxs: List[int], world: int) -> List[List[int]]:
    """Per rank, the rows of one size group's stack (positions in ``idxs``)
    that it owns."""
    return [[r for r, i in enumerate(idxs) if slots[i].owner == dev] for dev in range(world)]


def _assemble(
    factors: Dict[str, Dict[str, torch.Tensor]],
    slots: List[EighSlot],
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
    q_dtype: torch.dtype = torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Scatter per-slot ``(Q, d)`` into per-layer ``{QA, dA, QG, dG}``,
    ``Q`` written in ``q_dtype``.

    A factor decomposed as one block takes its result as is; blocked factors
    scatter into zeroed block-diagonal buffers.
    """
    eigen: Dict[str, Dict[str, torch.Tensor]] = {}
    whole = {
        (s.name, s.factor): i
        for i, s in enumerate(slots)
        if s.start == 0 and s.stop == factors[s.name][s.factor].shape[0]
    }
    for name, f in factors.items():
        eigen[name] = {}
        for fac, qk, dk in (("A", "QA", "dA"), ("G", "QG", "dG")):
            if fac not in f:
                continue
            i = whole.get((name, fac))
            if i is not None:
                q, d = results[i]
                eigen[name][qk], eigen[name][dk] = q.to(q_dtype), d
                continue
            n = f[fac].shape[0]
            eigen[name][qk] = f[fac].new_zeros((n, n), dtype=q_dtype)
            eigen[name][dk] = f[fac].new_zeros((n,))
    for i, s in enumerate(slots):
        if (s.name, s.factor) in whole:
            continue
        q, d = results[i]
        qk, dk = ("QA", "dA") if s.factor == "A" else ("QG", "dG")
        eigen[s.name][qk][s.start : s.stop, s.start : s.stop] = q
        eigen[s.name][dk][s.start : s.stop] = d
    return eigen


def replicated_eigen_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    diag_blocks_per_layer: Dict[str, int],
    eps: float = 1e-10,
    q_dtype: torch.dtype = torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Recompute every layer's eigendecomposition on this device.

    Same-size slots are decomposed together in one batched float32 eigh;
    results come back per layer as ``{QA, dA, QG, dG}`` with the eigenvalue
    floor, the eigenvectors cast to ``q_dtype`` (the preconditioner's
    ``eigen_dtype``) as they are written, blocked slots included.
    """
    slots = build_slots(factors, blocks_per_layer=diag_blocks_per_layer)
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for idxs in _size_groups(slots).values():
        mats = [_block(factors, slots[i]) for i in idxs]
        # a lone slot goes as a view: a WikiText-2 decoder's G factor is
        # 4.4 GB, and its decomposition needs the memory
        stack = mats[0][None] if len(mats) == 1 else torch.stack(mats)
        del mats
        q, d = eigh_with_floor(stack, eps)
        for row, i in enumerate(idxs):
            results[i] = (q[row], d[row])
    return _assemble(factors, slots, results, q_dtype)


def sharded_eigen_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    assignment: Assignment,
    world: World,
    eps: float = 1e-10,
    q_dtype: torch.dtype = torch.float32,
    rank_fn=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every layer's eigendecomposition, the work sharded over ``world``.

    ``factors`` is the replicated ``{layer: {A, G}}`` dict and
    ``assignment`` the table of ``parallel.assignment.layer_assignment``;
    returns the replicated ``{layer: {QA, dA, QG, dG}}`` of
    :func:`replicated_eigen_update`. Per slot size, each rank stacks the
    slots it owns and decomposes them in one batched float32 eigh (the
    eigenvalue floor included), writes its rows into a zeroed
    ``[k, n, n]``/``[k, n]`` pair (Q in ``q_dtype``) and one ``all_reduce``
    sums the ranks' pairs. ``rank_fn`` (the randomized solver) is ROADMAP
    queue 1 item 7 and is refused.
    """
    if rank_fn is not None:
        raise NotImplementedError(
            "sharded_eigen_update(rank_fn=...) (the randomized solver) is not "
            "ported to kfac_pytorch_tpu_torch yet (ROADMAP queue 1 item 7)"
        )
    slots = build_slots(factors, assignment)
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for n, idxs in _size_groups(slots).items():
        first = factors[slots[idxs[0]].name][slots[idxs[0]].factor]
        mine = _owner_tables(slots, idxs, world.size)[world.rank]
        kq = first.new_zeros((len(idxs), n, n), dtype=q_dtype)
        kd = first.new_zeros((len(idxs), n))
        if mine:
            mats = [_block(factors, slots[idxs[r]]) for r in mine]
            stack = mats[0][None] if len(mats) == 1 else torch.stack(mats)
            del mats
            q, d = eigh_with_floor(stack, eps)
            rows = torch.tensor(mine, device=kq.device)
            kq[rows] = q.to(q_dtype)
            kd[rows] = d
            del q, d, stack
        world.all_reduce_sum_(kq)
        world.all_reduce_sum_(kd)
        for row, i in enumerate(idxs):
            results[i] = (kq[row], kd[row])
    return _assemble(factors, slots, results, q_dtype)
