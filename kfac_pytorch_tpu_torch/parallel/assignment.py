"""Deterministic layer → rank work assignment, and the factor wire's buckets.

A copy of ``kfac_pytorch_tpu/parallel/assignment.py``'s ``RoundRobin``,
``precondition_assignment``, ``layer_assignment``, the pipelined
refresh's planners ``plan_eigh_chunks`` and ``eigh_chunk_owners`` with
their slot cost ``_slot_cost``, the factor comm plane's bucket layout
(``FactorBucketEntry``, ``FactorBucket``, ``plan_factor_buckets``) and the
owner-sharded factor layout (``plan_factor_shards``, ``FactorShardSlot``,
``FactorShardPlan``, ``shard_plan_bytes``, ``plan_fingerprint``,
``plan_owner_chunks``) (importing the JAX module would import JAX through
its package). The eigendecomposition table
mirrors the reference's ``cycle`` iterator and its per-update ``reset()``
(kfac/utils.py:12-39, kfac_preconditioner.py:383-396): it is recomputed
from (world, layers, diag_blocks, distribute_layer_factors) alone, so every
rank derives the same table and keeps the same layers across refreshes,
and nothing is communicated to agree on it. The chunk planners are LPT
over the JAX package's padded cost (``bucket_size³``, or the randomized
solver's matmul cost) with its tie-breaks, so they return its plans. The
bucket plan is the JAX package's first-fit over a list of leaf shapes.
The owner-sharded plan puts both factors of a layer on the rank that
preconditions it (``precondition_assignment``), in stacks of one exact side
size with a uniform row count per rank (pad rows on the lighter ranks), so
that one ``reduce_scatter`` per wire bucket lands each layer's statistics
on its owner.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kfac_pytorch_tpu_torch.ops.eigh import bucket_size
from kfac_pytorch_tpu_torch.ops.rsvd import DEFAULT_OVERSAMPLE

# matmul passes an rsvd slot pays over its bucket (ops/rsvd.py): the range
# finder's multiply, two subspace-iteration multiplies and Rayleigh–Ritz's
# A·Q, each ~m²·cols multiply-adds; it only shapes the load balance
_RSVD_MULTIPLIES = 4

RankFn = Optional[Callable[[int], Optional[int]]]


def _slot_cost(size: int, granularity: int, minimum: int, rank_fn: RankFn) -> int:
    """LPT cost of one eigh slot: ``bucket_size(size)³`` for the dense eigh,
    ``m²·min(r + p, m)·4`` for a slot ``rank_fn`` truncates to rank ``r``."""
    m = bucket_size(size, granularity, minimum)
    rank = rank_fn(size) if rank_fn is not None else None
    if rank is None:
        return m**3
    return m * m * min(rank + DEFAULT_OVERSAMPLE, m) * _RSVD_MULTIPLIES


def _lpt(slots, bins: int, granularity: int, minimum: int, rank_fn: RankFn) -> List[int]:
    """Greedy longest-processing-time: each slot, heaviest first (ties on
    name, factor, start), to the least loaded bin (ties on the bin index);
    returns each slot's bin."""
    cost = [_slot_cost(s.size, granularity, minimum, rank_fn) for s in slots]
    order = sorted(
        range(len(slots)),
        key=lambda i: (-cost[i], slots[i].name, slots[i].factor, slots[i].start),
    )
    load = [0] * bins
    where = [0] * len(slots)
    for i in order:
        b = min(range(bins), key=lambda c: (load[c], c))
        where[i] = b
        load[b] += cost[i]
    return where


class RoundRobin:
    """Infinite cycle over ``range(world)`` yielding n-tuples
    (``kfac.utils.cycle``)."""

    def __init__(self, world: int):
        self.world = world
        self.reset()

    def reset(self) -> None:
        self._it = itertools.cycle(range(self.world))

    def next(self, size: int) -> Tuple[int, ...]:
        return tuple(next(self._it) for _ in range(size))


def precondition_assignment(
    shapes: Dict[str, Tuple[int, int]],
    world: int,
    diag_a: Optional[set] = None,
) -> Dict[str, int]:
    """Assign each layer's every-step gradient rotation to one rank.

    Greedy longest-processing-time over ``g²·a + g·a²`` multiply-adds for a
    ``[g, a]`` gradient (``g²·a`` for a ``diag_a`` embedding, whose A side is
    elementwise): each layer, heaviest first, goes to the least loaded rank.
    Ties break on the layer name, then the rank index, so every rank derives
    the same table.
    """
    diag_a = diag_a or set()

    def cost(name, g, a):
        return g * g * a if name in diag_a else g * g * a + g * a * a

    jobs = sorted(
        shapes.items(),
        key=lambda kv: (-cost(kv[0], kv[1][0], kv[1][1]), kv[0]),
    )
    load = [0] * world
    owners: Dict[str, int] = {}
    for name, (g, a) in jobs:
        dev = min(range(world), key=lambda d: (load[d], d))
        owners[name] = dev
        load[dev] += cost(name, g, a)
    return owners


def layer_assignment(
    names: List[str],
    is_conv: Dict[str, bool],
    world: int,
    distribute_layer_factors: Optional[bool] = None,
    diag_blocks: int = 1,
) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{layer: {'A': ranks, 'G': ranks}}``: the owners of each factor's
    eigendecomposition, one per diagonal block.

    * ``distribute_layer_factors=None`` is the reference's auto rule: A and
      G of one layer go to different ranks iff ``world > len(names)``
      (kfac_preconditioner.py:126-130).
    * Conv layers get ``diag_blocks`` owners (one per block), dense layers
      one (kfac_preconditioner.py:257-268).
    """
    if distribute_layer_factors is None:
        distribute_layer_factors = world > len(names)
    rr = RoundRobin(world)
    table: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for name in names:
        n = diag_blocks if is_conv[name] else 1
        ranks_a = rr.next(n)
        ranks_g = rr.next(n) if distribute_layer_factors else ranks_a
        table[name] = {"A": ranks_a, "G": ranks_g}
    return table


def plan_eigh_chunks(
    slots, chunks: int, granularity: int = 512, minimum: int = 128, rank_fn: RankFn = None
) -> List[List[int]]:
    """Partition eigh slots into ``chunks`` balanced pieces of the pipelined
    refresh (one per step after a boundary), each piece's slot indices
    ascending. A chunk may be empty when there are fewer slots than chunks:
    its step is a plain step."""
    plan: List[List[int]] = [[] for _ in range(chunks)]
    for i, c in enumerate(_lpt(slots, chunks, granularity, minimum, rank_fn)):
        plan[c].append(i)
    return plan


def eigh_chunk_owners(
    slots, world: int, granularity: int = 512, minimum: int = 128, rank_fn: RankFn = None
) -> List[int]:
    """Per-slot owner ranks for ONE chunk's slots, rebalanced over the world
    with the chunk planner's cost: the full refresh's round-robin table
    balances the whole slot set, not a chunk of it."""
    return _lpt(slots, world, granularity, minimum, rank_fn)


# ---------------------------------------------------------------------------
# Factor-communication wire buckets (parallel/comm.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactorBucketEntry:
    """One stat leaf's slice of a wire bucket: ``index`` is the leaf's
    position in the flattened stat tree (the same on every rank),
    ``offset``/``size`` locate its flat payload in the bucket and ``shape``
    restores it."""

    index: int
    offset: int
    size: int
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FactorBucket:
    """One flat wire buffer: a static slice layout over stat leaves."""

    entries: Tuple[FactorBucketEntry, ...]
    size: int


def plan_factor_buckets(
    shapes: Sequence[Tuple[int, ...]], max_bucket_elems: int = 1 << 20
) -> Tuple[FactorBucket, ...]:
    """Pack factor-stat leaves into a small static set of flat wire buckets:
    one collective moves each bucket instead of one per leaf (SPD-KFAC's
    tensor fusion). Greedy first-fit in leaf order, never reordered: a
    bucket closes when the next leaf would push it past
    ``max_bucket_elems`` (1 Mi elements, 4 MiB at float32), and a single
    oversized leaf gets a bucket of its own rather than splitting. A pure
    function of the shapes, so every rank derives the same layout."""
    if max_bucket_elems < 1:
        raise ValueError(f"Invalid max_bucket_elems: {max_bucket_elems}")
    buckets: List[FactorBucket] = []
    entries: List[FactorBucketEntry] = []
    offset = 0
    for index, shape in enumerate(shapes):
        size = 1
        for d in shape:
            size *= int(d)
        if entries and offset + size > max_bucket_elems:
            buckets.append(FactorBucket(entries=tuple(entries), size=offset))
            entries, offset = [], 0
        entries.append(FactorBucketEntry(
            index=index, offset=offset, size=size, shape=tuple(int(d) for d in shape)
        ))
        offset += size
    if entries:
        buckets.append(FactorBucket(entries=tuple(entries), size=offset))
    return tuple(buckets)


# ---------------------------------------------------------------------------
# Owner-sharded factor state (factor_sharding="owner", DP-KFAC)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactorShardSlot:
    """One (layer, factor) side's home in the owner-sharded state: ``row``
    is its row in its owner's ``[rows_n, n, n]`` stack of the size-``n``
    group (global row ``owner·rows_n + row``); ``diag`` marks the A side of
    a diagonal-A (embedding) layer, a ``[n]`` vector of the ``v<n>`` group."""

    name: str
    factor: str  # "A" or "G"
    size: int
    owner: int
    row: int
    diag: bool = False


@dataclasses.dataclass(frozen=True)
class FactorShardPlan:
    """The static owner-sharded layout: who holds what, and the wire
    buckets of the reduce-scatter."""

    world: int
    owners: Dict[str, int]
    slots: Tuple[FactorShardSlot, ...]
    group_rows: Dict[int, int]
    group_sizes: Tuple[int, ...]
    wire_buckets: Tuple[FactorBucket, ...]
    # diagonal-A vector groups ("v<size>" state keys)
    diag_group_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    diag_group_sizes: Tuple[int, ...] = ()

    def slot(self, name: str, factor: str) -> FactorShardSlot:
        for s in self.slots:
            if s.name == name and s.factor == factor:
                return s
        raise KeyError((name, factor))

    def group_slots(self, size: int, diag: bool = False) -> Tuple[FactorShardSlot, ...]:
        return tuple(s for s in self.slots if s.size == size and s.diag == diag)

    def valid_rows(self, size: int, diag: bool = False) -> List[List[bool]]:
        """``[world][rows]``: True where a real slot lives, False on the pad
        rows of the lighter ranks."""
        rows = (self.diag_group_rows if diag else self.group_rows)[size]
        mask = [[False] * rows for _ in range(self.world)]
        for s in self.group_slots(size, diag):
            mask[s.owner][s.row] = True
        return mask

    def wire_groups(self) -> List[Tuple[str, int, int, int]]:
        """``(state key, size, rows, elements per slot)`` of the matrix
        groups, then the vector groups: the list ``FactorBucketEntry.index``
        indexes."""
        out = [(f"n{n}", n, self.group_rows[n], n * n) for n in self.group_sizes]
        out += [(f"v{n}", n, self.diag_group_rows[n], n) for n in self.diag_group_sizes]
        return out

    def owner_count(self) -> int:
        return len({s.owner for s in self.slots})


def plan_factor_shards(
    shapes: Dict[str, Tuple[int, int]],
    world: int,
    max_bucket_elems: int = 1 << 20,
    diag_a: Optional[set] = None,
) -> FactorShardPlan:
    """The owner-sharded factor layout (DP-KFAC, arxiv 2206.15143) of layers
    with ``[g, a]`` gradients over ``world`` ranks.

    Owners are :func:`precondition_assignment`'s (the rank that solves a
    layer keeps its factors and bases, both of them). Slots group by exact
    side size ``n`` into ``[world·rows_n, n, n]`` stacks, ``rows_n`` the
    most size-``n`` slots any rank owns; rows go in sorted-name order, A
    then G. The A side of a ``diag_a`` layer is a ``[n]`` vector in the
    ``v<n>`` groups. Each group's per-rank payload is one leaf of
    :func:`plan_factor_buckets`, so the reduce-scatter fuses groups into the
    replicated plane's buckets."""
    diag_a = diag_a or set()
    owners = precondition_assignment(shapes, world, diag_a=diag_a)
    slots: List[FactorShardSlot] = []
    counts: Dict[Tuple[int, int], int] = {}  # (size, owner) -> next row
    vcounts: Dict[Tuple[int, int], int] = {}
    for name in sorted(shapes):
        g, a = shapes[name]
        for factor, size in (("A", int(a)), ("G", int(g))):
            owner = owners[name]
            diag = factor == "A" and name in diag_a
            table = vcounts if diag else counts
            row = table.get((size, owner), 0)
            table[(size, owner)] = row + 1
            slots.append(FactorShardSlot(name, factor, size, owner, row, diag))
    group_rows = {n: max(c for (s, _), c in counts.items() if s == n) for n in {s for s, _ in counts}}
    diag_group_rows = {
        n: max(c for (s, _), c in vcounts.items() if s == n) for n in {s for s, _ in vcounts}
    }
    sizes = tuple(sorted(group_rows))
    vsizes = tuple(sorted(diag_group_rows))
    wire_buckets = plan_factor_buckets(
        [(group_rows[n] * n * n,) for n in sizes] + [(diag_group_rows[n] * n,) for n in vsizes],
        max_bucket_elems,
    )
    return FactorShardPlan(
        world=world, owners=owners, slots=tuple(slots), group_rows=group_rows,
        group_sizes=sizes, wire_buckets=wire_buckets, diag_group_rows=diag_group_rows,
        diag_group_sizes=vsizes,
    )


def shard_plan_bytes(
    plan: FactorShardPlan, rank_fn: RankFn = None, eigen_itemsize: int = 4
) -> Dict[str, object]:
    """Planned bytes of the owner-sharded layout: ``*_buffer_local`` is what
    one rank allocates (its padded stacks: float32 factors, ``Q`` at
    ``eigen_itemsize``, float32 eigenvalues and residual masses),
    ``per_owner`` each rank's unpadded payload, ``replicated_total`` what
    every rank holds in the replicated mode, ``scatter_wire_bytes`` the
    float32 reduce-scatter payload over all ranks."""

    def eigen_elems(n: int) -> Tuple[int, int, int]:
        rank = rank_fn(n) if rank_fn is not None else None
        if rank is None:
            return n * n, n, 0
        return n * rank, rank, 1

    factor_local = eigen_local = 0
    for n in plan.group_sizes:
        rows = plan.group_rows[n]
        q, d, rho = eigen_elems(n)
        factor_local += rows * n * n * 4
        eigen_local += rows * (q * eigen_itemsize + d * 4 + rho * 4)
    for n in plan.diag_group_sizes:
        rows = plan.diag_group_rows[n]
        factor_local += rows * n * 4
        eigen_local += rows * n * 4
    per_owner = [0] * plan.world
    replicated_total = 0
    for s in plan.slots:
        if s.diag:
            slot_bytes = s.size * 4 * 2  # the vector factor and its floored copy
        else:
            q, d, rho = eigen_elems(s.size)
            slot_bytes = s.size * s.size * 4 + q * eigen_itemsize + d * 4 + rho * 4
        per_owner[s.owner] += slot_bytes
        replicated_total += slot_bytes
    return {
        "factor_buffer_local": factor_local,
        "eigen_buffer_local": eigen_local,
        "total_buffer_local": factor_local + eigen_local,
        "per_owner": per_owner,
        "replicated_total": replicated_total,
        "owner_count": plan.owner_count(),
        "wire_bucket_count": len(plan.wire_buckets),
        "scatter_wire_bytes": sum(b.size for b in plan.wire_buckets) * plan.world * 4,
    }


def plan_fingerprint(plan: FactorShardPlan) -> str:
    """A short digest of an owner-shard layout: the world size and every
    slot's ``(name, factor, size, owner, row, diag)``; two plans with the
    same digest place every row alike."""
    import hashlib

    h = hashlib.sha256()
    h.update(str(plan.world).encode())
    for s in sorted(plan.slots, key=lambda s: (s.name, s.factor)):
        h.update(f"|{s.name}:{s.factor}:{s.size}:{s.owner}:{s.row}:{int(s.diag)}".encode())
    return h.hexdigest()[:16]


def plan_owner_chunks(
    plan: FactorShardPlan, chunks: int, granularity: int = 512, minimum: int = 128,
    rank_fn: RankFn = None,
) -> List[List[Tuple[int, int]]]:
    """The owner-local refresh in ``chunks`` sets of ``(size, row)`` jobs:
    the same local row of every rank's stack in one chunk, LPT over
    :func:`_slot_cost` with ``(cost, size, row)`` tie-breaks; a chunk may be
    empty."""
    jobs = [(n, r) for n in plan.group_sizes for r in range(plan.group_rows[n])]
    cost = {j: _slot_cost(j[0], granularity, minimum, rank_fn) for j in jobs}
    order = sorted(jobs, key=lambda j: (-cost[j], j[0], j[1]))
    load = [0] * chunks
    out: List[List[Tuple[int, int]]] = [[] for _ in range(chunks)]
    for j in order:
        c = min(range(chunks), key=lambda c: (load[c], c))
        out[c].append(j)
        load[c] += cost[j]
    return [sorted(p) for p in out]
