"""The single-device eigen refresh (``replicated_eigen_update``).

Port of the replicated path of ``kfac_pytorch_tpu/parallel/sharded_eigh.py``
(``build_slots``, ``_assemble``, ``replicated_eigen_update``) — the one
``KFAC.update`` calls on one device. The sharded (multi-device) variants
are ROADMAP queue 1 item 6.

Each (layer, factor, block) job is a slot; slots of equal size are stacked
and decomposed by ONE batched ``torch.linalg.eigh`` call at their own size
(no −1 padding to shared buckets: that existed to bound XLA compile cost).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.ops.eigh import eigh_with_floor, get_block_boundary


@dataclasses.dataclass(frozen=True)
class EighSlot:
    """One eigendecomposition job: a diagonal block of one layer's factor."""

    name: str
    factor: str  # "A" or "G"
    start: int  # block row range within the factor
    stop: int
    owner: int = 0  # owning device (always 0 on one device)

    @property
    def size(self) -> int:
        return self.stop - self.start


def build_slots(
    factors: Dict[str, Dict[str, torch.Tensor]],
    blocks_per_layer: Optional[Dict[str, int]] = None,
) -> List[EighSlot]:
    """Expand factors into per-block jobs (block count capped at the side)."""
    slots: List[EighSlot] = []
    for name in factors:
        for fac in ("A", "G"):
            if fac not in factors[name]:
                continue
            n = factors[name][fac].shape[0]
            nb = min((blocks_per_layer or {}).get(name, 1), n)
            for b in range(nb):
                (r0, _), (r1, _) = get_block_boundary(b, nb, (n, n))
                slots.append(EighSlot(name, fac, r0, r1))
    return slots


def _assemble(
    factors: Dict[str, Dict[str, torch.Tensor]],
    slots: List[EighSlot],
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Scatter per-slot ``(Q, d)`` into per-layer ``{QA, dA, QG, dG}``.

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
                eigen[name][qk], eigen[name][dk] = results[i]
                continue
            n = f[fac].shape[0]
            eigen[name][qk] = f[fac].new_zeros((n, n))
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
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Recompute every layer's eigendecomposition on this device.

    Same-size slots are decomposed together in one batched eigh; results
    come back per layer as ``{QA, dA, QG, dG}`` with the eigenvalue floor.
    """
    slots = build_slots(factors, diag_blocks_per_layer)
    by_size: Dict[int, List[int]] = {}
    for i, s in enumerate(slots):
        by_size.setdefault(s.size, []).append(i)
    results: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for _, idxs in sorted(by_size.items()):
        stack = torch.stack(
            [
                factors[slots[i].name][slots[i].factor][
                    slots[i].start : slots[i].stop, slots[i].start : slots[i].stop
                ].float()
                for i in idxs
            ]
        )
        q, d = eigh_with_floor(stack, eps)
        for row, i in enumerate(idxs):
            results[i] = (q[row], d[row])
    return _assemble(factors, slots, results)
