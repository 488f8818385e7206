"""Deterministic layer → rank work assignment.

A copy of ``kfac_pytorch_tpu/parallel/assignment.py``'s ``RoundRobin``,
``precondition_assignment`` and ``layer_assignment`` (importing the JAX
module would import JAX through its package). The eigendecomposition table
mirrors the reference's ``cycle`` iterator and its per-update ``reset()``
(kfac/utils.py:12-39, kfac_preconditioner.py:383-396): it is recomputed
from (world, layers, diag_blocks, distribute_layer_factors) alone, so every
rank derives the same table and keeps the same layers across refreshes,
and nothing is communicated to agree on it. The factor-bucket and shard
plans wait for ROADMAP queue 1 items 6b and 7b.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple


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
