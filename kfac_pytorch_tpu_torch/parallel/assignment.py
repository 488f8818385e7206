"""Deterministic layer → rank work assignment, and the factor wire's buckets.

A copy of ``kfac_pytorch_tpu/parallel/assignment.py``'s ``RoundRobin``,
``precondition_assignment``, ``layer_assignment``, the pipelined
refresh's planners ``plan_eigh_chunks`` and ``eigh_chunk_owners`` with
their slot cost ``_slot_cost``, and the factor comm plane's bucket layout
(``FactorBucketEntry``, ``FactorBucket``, ``plan_factor_buckets``)
(importing the JAX module would import JAX through its package). The eigendecomposition table
mirrors the reference's ``cycle`` iterator and its per-update ``reset()``
(kfac/utils.py:12-39, kfac_preconditioner.py:383-396): it is recomputed
from (world, layers, diag_blocks, distribute_layer_factors) alone, so every
rank derives the same table and keeps the same layers across refreshes,
and nothing is communicated to agree on it. The chunk planners are LPT
over the JAX package's padded cost (``bucket_size³``, or the randomized
solver's matmul cost) with its tie-breaks, so they return its plans. The
bucket plan is the JAX package's first-fit over a list of leaf shapes; the
owner-sharded factor plan waits for ROADMAP queue 1 item 7 (7b).
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
