"""The eigen refresh: replicated on one device, or sharded over the ranks.

Port of ``kfac_pytorch_tpu/parallel/sharded_eigh.py`` (``build_slots``,
``_split_by_rank``, ``_owner_tables``, ``_assemble``, ``_scatter_into``,
``replicated_eigen_update``, ``sharded_eigen_update``, the pipelined
refresh's ``replicated_eigen_chunk_update`` and
``sharded_eigen_chunk_update``, and the owner-sharded mode's
``_owner_group_solve``, ``owner_eigen_update``,
``owner_eigen_chunk_update``, ``owner_spectrum_mass`` and
``owner_stream_fold``). Each (layer, factor, block) job is a
slot; slots of equal size are stacked and decomposed by ONE batched
``torch.linalg.eigh`` call at their own size (no −1 padding to shared
buckets: that existed to bound XLA compile cost). With ``rank_fn`` (the
preconditioner's size → rank policy of the truncated solvers) a slot whose
size maps to a rank takes the randomized solve of ``ops/rsvd.py`` instead,
grouped by ``(size, rank)``, and yields a rectangular ``(Q_r [n, r], d_r
[r], rho)`` entry; ``rank_fn=None`` leaves every path as it was.
Shard-lens layers (``#cT``/``#rT``/``#eE``) never reach this module: they
refresh densely on every rank (``shardwise.eigen_refresh``), outside the
slot tables.

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

Owner-sharded (``factor_sharding="owner"``), each rank's rows of the
``{"n<size>": [rows, n, n]}`` factor stacks are the slots it owns
(``parallel.assignment.plan_factor_shards``), so the refresh is local and
issues no collective: the rank decomposes its valid rows, dense sides by
``ops/eigh.py`` at their own size and truncated ones by ``ops/rsvd.py``,
and writes its rows of the eigen stacks. The JAX package decomposes every
row, pad rows included, because its program is the same on every device;
here a pad row is never decomposed and keeps zeros (it is never read).
The spectrum mass and the streaming fold's drift gauge sum over the valid
rows and take one ``all_reduce`` of the (captured, total) pair.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops.eigh import eigh_with_floor, get_block_boundary
from kfac_pytorch_tpu_torch.ops.rsvd import batched_randomized_eigh, residual_rho
from kfac_pytorch_tpu_torch.ops.streaming import fold_rho, fold_side
from kfac_pytorch_tpu_torch.parallel.assignment import eigh_chunk_owners
from kfac_pytorch_tpu_torch.parallel.mesh import World

Assignment = Dict[str, Dict[str, Tuple[int, ...]]]
RankFn = Optional[Callable[[int], Optional[int]]]
# a slot's result: (Q [n, n], d [n]) from the dense eigh, or (Q_r [n, r],
# d_r [r], rho) from the randomized solve; the arity tells them apart
SlotResult = Tuple[torch.Tensor, ...]


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


def _split_by_rank(slots: List[EighSlot], rank_fn: RankFn) -> Tuple[List[int], Dict[int, List[int]]]:
    """Slot indices split into ``(dense, {rank: [indices]})`` by ``rank_fn``
    (``None`` for a size: the dense eigh keeps it), shared by every update
    so all of them truncate the same slots."""
    dense: List[int] = []
    by_rank: Dict[int, List[int]] = {}
    for i, s in enumerate(slots):
        r = rank_fn(s.size) if rank_fn is not None else None
        if r is None:
            dense.append(i)
        else:
            by_rank.setdefault(int(r), []).append(i)
    return dense, by_rank


def _groups(slots: List[EighSlot], rank_fn: RankFn) -> List[Tuple[int, Optional[int], List[int]]]:
    """``(size, rank or None, slot indices)`` per solve: the dense groups by
    size ascending, then the ``(size, rank)`` groups of the truncated
    slots, sorted."""
    dense, by_rank = _split_by_rank(slots, rank_fn)
    by_size: Dict[int, List[int]] = {}
    for i in dense:
        by_size.setdefault(slots[i].size, []).append(i)
    lr: Dict[Tuple[int, int], List[int]] = {}
    for r, idxs in by_rank.items():
        for i in idxs:
            lr.setdefault((slots[i].size, r), []).append(i)
    return [(n, None, idxs) for n, idxs in sorted(by_size.items())] + [
        (n, r, idxs) for (n, r), idxs in sorted(lr.items())
    ]


def _block(factors, s: EighSlot) -> torch.Tensor:
    return factors[s.name][s.factor][s.start : s.stop, s.start : s.stop].float()


def _owner_tables(slots: List[EighSlot], idxs: List[int], world: int) -> List[List[int]]:
    """Per rank, the rows of one group's stack (positions in ``idxs``) that
    it owns."""
    return [[r for r, i in enumerate(idxs) if slots[i].owner == dev] for dev in range(world)]


def _decompose(factors, slots, idxs, rank, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched solve of the slots ``idxs``: the floored eigh, or the
    randomized solve at ``rank``."""
    mats = [_block(factors, slots[i]) for i in idxs]
    # a lone slot goes as a view: a WikiText-2 decoder's G factor is
    # 4.4 GB, and its decomposition needs the memory
    stack = mats[0][None] if len(mats) == 1 else torch.stack(mats)
    del mats
    if rank is None:
        return eigh_with_floor(stack, eps)
    return batched_randomized_eigh(stack, rank, eps)


def _solve(
    factors, slots: List[EighSlot], world: Optional[World], eps: float,
    q_dtype: torch.dtype, rank_fn: RankFn,
) -> Dict[int, SlotResult]:
    """Every slot's result. With a ``world`` of more than one rank each
    rank solves the slots it owns, writes their rows into a zeroed stack
    per group (Q in ``q_dtype``) and one ``all_reduce`` per stack sums the
    ranks' stacks: every element has one owner, so the sum is exact. A
    truncated slot's ``rho`` comes from the reassembled ``d`` and the
    replicated factor, on every rank."""
    results: Dict[int, SlotResult] = {}
    tel = get_telemetry()
    for n, rank, idxs in _groups(slots, rank_fn):
        if world is None or world.size == 1:
            with tel.span("trace/eigh/compute"):
                q, d = _decompose(factors, slots, idxs, rank, eps)
        else:
            first = factors[slots[idxs[0]].name][slots[idxs[0]].factor]
            mine = _owner_tables(slots, idxs, world.size)[world.rank]
            cols = n if rank is None else rank
            q = first.new_zeros((len(idxs), n, cols), dtype=q_dtype)
            d = first.new_zeros((len(idxs), cols))
            if mine:
                with tel.span("trace/eigh/compute"):
                    q_m, d_m = _decompose(factors, slots, [idxs[r] for r in mine], rank, eps)
                rows = torch.tensor(mine, device=q.device)
                q[rows] = q_m.to(q_dtype)
                d[rows] = d_m
                del q_m, d_m
            with tel.span("trace/eigh/exchange"):
                world.all_reduce_sum_(q)
                world.all_reduce_sum_(d)
        for row, i in enumerate(idxs):
            if rank is None:
                results[i] = (q[row], d[row])
            else:
                s = slots[i]
                trace = torch.trace(factors[s.name][s.factor][s.start : s.stop, s.start : s.stop])
                results[i] = (q[row], d[row], residual_rho(trace, d[row], n, rank))
    return results


def _assemble(
    factors: Dict[str, Dict[str, torch.Tensor]],
    slots: List[EighSlot],
    results: Dict[int, SlotResult],
    q_dtype: torch.dtype = torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Scatter per-slot results into per-layer ``{QA, dA, QG, dG}`` (plus
    ``rhoA``/``rhoG`` for a truncated side), ``Q`` written in ``q_dtype``.

    A factor decomposed as one block takes its result as is; blocked factors
    scatter into zeroed block-diagonal buffers. A truncated result is its
    factor's whole entry (the truncated solvers exclude ``diag_blocks >
    1``), rectangular, with its scalar residual mass.
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
                res = results[i]
                eigen[name][qk], eigen[name][dk] = res[0].to(q_dtype), res[1]
                if len(res) == 3:
                    eigen[name]["rho" + fac] = res[2]
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


def _scatter_into(
    pending: Dict[str, Dict[str, torch.Tensor]],
    slots: List[EighSlot],
    results: Dict[int, SlotResult],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-slot results into the pipelined refresh's EXISTING buffers: each
    chunk writes only its own slots' regions and leaves the other chunks'
    results in place. ``Q`` is cast to the buffer's dtype (``eigen_dtype``)
    as it is written, elementwise, so the swapped basis is the monolithic
    refresh's. A whole-factor result replaces its entries; a block is
    written into the buffer, which the interval's chunk 0 allocated afresh
    (``KFAC.update``), so no write reaches a tensor the active basis holds."""
    out = {name: dict(e) for name, e in pending.items()}
    for i, s in enumerate(slots):
        res = results[i]
        qk, dk = ("QA", "dA") if s.factor == "A" else ("QG", "dG")
        buf = out[s.name][qk]
        n = buf.shape[0]
        if s.start == 0 and s.stop == n:
            out[s.name][qk], out[s.name][dk] = res[0].to(buf.dtype), res[1]
            if len(res) == 3:
                out[s.name]["rho" + s.factor] = res[2]
            continue
        buf[s.start : s.stop, s.start : s.stop] = res[0].to(buf.dtype)
        out[s.name][dk][s.start : s.stop] = res[1]
    return out


def replicated_eigen_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    diag_blocks_per_layer: Dict[str, int],
    eps: float = 1e-10,
    q_dtype: torch.dtype = torch.float32,
    rank_fn: RankFn = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Recompute every layer's eigendecomposition on this device.

    Same-size slots are decomposed together in one batched float32 eigh
    (or, for the sizes ``rank_fn`` truncates, one batched randomized solve
    per ``(size, rank)``); results come back per layer as ``{QA, dA, QG,
    dG}`` (plus ``rho*``) with the eigenvalue floor, the eigenvectors cast
    to ``q_dtype`` (the preconditioner's ``eigen_dtype``) as they are
    written, blocked slots included.
    """
    slots = build_slots(factors, blocks_per_layer=diag_blocks_per_layer)
    return _assemble(factors, slots, _solve(factors, slots, None, eps, q_dtype, rank_fn), q_dtype)


def sharded_eigen_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    assignment: Assignment,
    world: World,
    eps: float = 1e-10,
    q_dtype: torch.dtype = torch.float32,
    rank_fn: RankFn = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every layer's eigendecomposition, the work sharded over ``world``.

    ``factors`` is the replicated ``{layer: {A, G}}`` dict and
    ``assignment`` the table of ``parallel.assignment.layer_assignment``;
    returns the replicated result of :func:`replicated_eigen_update`. Per
    group (slot size, and rank for the truncated slots), each rank stacks
    the slots it owns and solves them in one batched call, writes its rows
    into a zeroed stack (Q in ``q_dtype``) and one ``all_reduce`` sums the
    ranks' stacks.
    """
    slots = build_slots(factors, assignment)
    return _assemble(factors, slots, _solve(factors, slots, world, eps, q_dtype, rank_fn), q_dtype)


def replicated_eigen_chunk_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    pending: Dict[str, Dict[str, torch.Tensor]],
    chunk_slots: List[EighSlot],
    eps: float = 1e-10,
    rank_fn: RankFn = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """One chunk of the pipelined refresh on this device: the chunk's slots
    solved as :func:`replicated_eigen_update` solves them, written into
    ``pending``."""
    return _scatter_into(
        pending, chunk_slots, _solve(factors, chunk_slots, None, eps, torch.float32, rank_fn)
    )


def sharded_eigen_chunk_update(
    factors: Dict[str, Dict[str, torch.Tensor]],
    pending: Dict[str, Dict[str, torch.Tensor]],
    chunk_slots: List[EighSlot],
    world: World,
    eps: float = 1e-10,
    rank_fn: RankFn = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """One chunk of the pipelined refresh, sharded over ``world``: owners
    rebalanced within the chunk (``eigh_chunk_owners``, rank-aware with
    ``rank_fn``) so every step spreads its share of the work over all
    ranks, one ``all_reduce`` per group, results written into ``pending``.
    The stacks cross the wire in float32; ``Q`` takes the buffers' dtype as
    it is written."""
    owners = eigh_chunk_owners(chunk_slots, world.size, rank_fn=rank_fn)
    slots = [dataclasses.replace(s, owner=o) for s, o in zip(chunk_slots, owners)]
    return _scatter_into(pending, slots, _solve(factors, slots, world, eps, torch.float32, rank_fn))


# ---------------------------------------------------------------------------
# Owner-sharded refresh (factor_sharding="owner")
# ---------------------------------------------------------------------------


def _valid_rows(plan, n: int, rank: int) -> List[int]:
    """This rank's rows of the size-``n`` matrix group that hold a slot."""
    return [i for i, ok in enumerate(plan.valid_rows(n)[rank]) if ok]


def _owner_group_solve(
    local: torch.Tensor, n: int, rank: Optional[int], eps: float, eigen_dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Decompose a ``[k, n, n]`` stack of one size group's rows: dense ``{"Q"
    [k, n, n], "d" [k, n]}``, or truncated at ``rank`` ``{"Q" [k, n, r], "d"
    [k, r], "rho" [k]}``, ``Q`` in ``eigen_dtype``."""
    if rank is None:
        q, d = eigh_with_floor(local.float(), eps)
        return {"Q": q.to(eigen_dtype), "d": d}
    q, d = batched_randomized_eigh(local, rank, eps)
    traces = torch.diagonal(local.float(), dim1=-2, dim2=-1).sum(-1)
    return {"Q": q.to(eigen_dtype), "d": d, "rho": residual_rho(traces, d, n, rank)}


def _solve_rows_into(entry, stack, rows, n, rank, eps, eigen_dtype) -> None:
    """Solve ``stack``'s ``rows`` and write them into ``entry``'s stacks."""
    if not rows:
        return
    whole = rows == list(range(stack.shape[0]))
    idx = torch.tensor(rows, device=stack.device)
    res = _owner_group_solve(stack if whole else stack.index_select(0, idx), n, rank, eps,
                             eigen_dtype)
    for field, val in res.items():
        entry[field][idx] = val.to(entry[field].dtype)


def owner_eigen_entry_init(plan, n: int, rank: Optional[int], eigen_dtype, device
                           ) -> Dict[str, torch.Tensor]:
    """Zero eigen stacks of one size group, this rank's ``rows_n`` rows."""
    rows = plan.group_rows[n]
    cols = n if rank is None else rank
    e = {
        "Q": torch.zeros((rows, n, cols), dtype=eigen_dtype, device=device),
        "d": torch.zeros((rows, cols), dtype=torch.float32, device=device),
    }
    if rank is not None:
        e["rho"] = torch.zeros((rows,), dtype=torch.float32, device=device)
    return e


def owner_eigen_update(
    factor_shard: Dict[str, torch.Tensor],
    plan,
    rank: int,
    eps: float = 1e-10,
    rank_fn: RankFn = None,
    eigen_dtype: torch.dtype = torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The owner-local refresh of this rank's rows of every matrix group:
    ``{"n<size>": {"Q", "d"[, "rho"]}}``, this rank's rows (pad rows
    zero). No collective."""
    out = {}
    with get_telemetry().span("trace/eigh/compute"):
        for n in plan.group_sizes:
            r = rank_fn(n) if rank_fn is not None else None
            stack = factor_shard[f"n{n}"]
            entry = owner_eigen_entry_init(plan, n, r, eigen_dtype, stack.device)
            _solve_rows_into(entry, stack, _valid_rows(plan, n, rank), n, r, eps, eigen_dtype)
            out[f"n{n}"] = entry
    return out


def owner_eigen_chunk_update(
    factor_shard: Dict[str, torch.Tensor],
    pending_shard: Dict[str, Dict[str, torch.Tensor]],
    jobs: List[Tuple[int, int]],
    plan,
    rank: int,
    eps: float = 1e-10,
    rank_fn: RankFn = None,
    eigen_dtype: torch.dtype = torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """One chunk of the pipelined owner refresh: the chunk's ``(size, row)``
    jobs (``parallel.assignment.plan_owner_chunks``, the same local rows on
    every rank) solved where this rank holds a slot and written into
    ``pending_shard``'s stacks, which the interval's chunk 0 allocated
    afresh (``KFAC.update``). No collective."""
    by_group: Dict[int, List[int]] = {}
    for n, row in jobs:
        by_group.setdefault(n, []).append(row)
    out = {k: dict(v) for k, v in pending_shard.items()}
    with get_telemetry().span("trace/eigh/compute"):
        for n in sorted(by_group):
            r = rank_fn(n) if rank_fn is not None else None
            valid = set(_valid_rows(plan, n, rank))
            rows = sorted(row for row in by_group[n] if row in valid)
            _solve_rows_into(out[f"n{n}"], factor_shard[f"n{n}"], rows, n, r, eps, eigen_dtype)
    return out


def _sum_over_ranks(parts: List[torch.Tensor], world: World) -> List[torch.Tensor]:
    """The ranks' sums of a few scalars, one ``all_reduce``."""
    flat = torch.stack(parts)
    world.all_reduce_sum_(flat)
    return list(flat.unbind())


def _row_mask(plan, n: int, rank: int, device) -> torch.Tensor:
    return torch.tensor(plan.valid_rows(n)[rank], dtype=torch.float32, device=device)


def owner_spectrum_mass(
    factor_shard: Dict[str, torch.Tensor],
    eigen_shard: Dict[str, Dict[str, torch.Tensor]],
    plan,
    world: World,
    rank_fn: RankFn = None,
) -> torch.Tensor:
    """``Σ d_r / Σ tr(F)`` over every truncated slot (the replicated
    spectrum mass, up to summation order): each rank sums its valid rows,
    one ``all_reduce`` merges the pair. 1 when nothing is truncated."""
    truncated = [n for n in plan.group_sizes if rank_fn is not None and rank_fn(n) is not None]
    device = next(iter(factor_shard.values())).device
    if not truncated:
        return torch.ones((), dtype=torch.float32, device=device)
    cap = tot = torch.zeros((), dtype=torch.float32, device=device)
    for n in truncated:
        mask = _row_mask(plan, n, world.rank, device)
        traces = torch.diagonal(factor_shard[f"n{n}"].float(), dim1=-2, dim2=-1).sum(-1)
        cap = cap + (eigen_shard[f"n{n}"]["d"] * mask[:, None]).sum()
        tot = tot + (traces * mask).sum()
    cap, tot = _sum_over_ranks([cap, tot], world)
    return cap / torch.clamp(tot, min=1e-30)


def owner_stream_fold(
    factor_shard: Dict[str, torch.Tensor],
    eigen_shard: Dict[str, Dict[str, torch.Tensor]],
    plan,
    world: World,
    eps: float = 1e-10,
    rank_fn: RankFn = None,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], torch.Tensor]:
    """The streaming fold (``ops/streaming.py``) over this rank's rows: ``d
    = diag(Qᵀ F Q)`` per row, ``rho`` from the leftover trace, ``Q`` passed
    through, the diagonal-A groups' floored diagonals; the drift gauge
    ``Σ leftover / Σ tr F`` over the valid truncated rows, one
    ``all_reduce`` for the pair. Returns ``(eigen_shard', residual)``."""
    device = next(iter(factor_shard.values())).device
    num = den = torch.zeros((), dtype=torch.float32, device=device)
    out = {}
    for n in plan.group_sizes:
        key = f"n{n}"
        rank = rank_fn(n) if rank_fn is not None else None
        d, traces = fold_side(eigen_shard[key]["Q"], factor_shard[key], eps)
        entry = {"Q": eigen_shard[key]["Q"], "d": d}
        if rank is not None:
            entry["rho"] = fold_rho(traces, d, n, rank)
            mask = _row_mask(plan, n, world.rank, device)
            num = num + (torch.clamp(traces - d.sum(-1), min=0.0) * mask).sum()
            den = den + (traces * mask).sum()
        out[key] = entry
    for n in plan.diag_group_sizes:
        diag = factor_shard[f"v{n}"].float()
        out[f"v{n}"] = {"d": diag * (diag > eps)}
    num, den = _sum_over_ranks([num, den], world)
    return out, num / torch.clamp(den, min=1e-30)
