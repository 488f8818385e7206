"""Deterministic re-planning of owner-sharded K-FAC state on a resized world.

Port of ``kfac_pytorch_tpu/elastic/replan.py``. Owner sharding places
every factor by the LPT assignment of ``parallel/assignment.py``, so state
placement is a function of the world, and surviving a resize means
re-deriving that placement for the new world and moving every slot's rows.
The assignment is a pure function of (layer shapes, world): every rank
re-derives the same plans from the model alone (``KFAC.factor_shapes``),
which is what makes the replan deterministic.

The re-scatter is a direct row remap between the global-form stacks a
snapshot holds (``[world·rows, …]``, rank ``r``'s rows at ``r·rows``): for
each slot of the NEW plan, copy its row out of the OLD plan's stack at
``old_owner·old_rows + old_row`` (:func:`remap_owner_stacks`, a host
function of the stacks, the shapes and the two worlds). Each rank then
keeps its own rows of the new stacks; nothing is gathered.

What survives a resize, and what is deliberately dropped:

* factor EMAs and ACTIVE eigen bases (the truncated solvers' tables
  included): carried bitwise (rows move, values do not), and so is
  ``spectrum_mass`` (and streaming's drift gauge and fold count);
* a half-filled ``eigen_pending_shard`` pass: abandoned (zeroed), since
  the old world's chunk plan means nothing on the new one. The active
  basis is at most ONE refresh interval stale after a resize;
* unflushed deferred accumulators (``factor_local``,
  ``factor_sync_age``): zeroed, per-rank quantities of a rank set that no
  longer exists;
* ``eigen_swap_slip``: reset, since the slipped swap's pending basis did
  not survive.

On a world of one rank the owner mode runs replicated (``KFAC`` degrades
it), so a resize onto one rank gathers the stacks back into per-layer
factors and bases by the old plan (:func:`replicated_state_from_owner`),
under the same contract. The JAX package's replan refuses that case.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.observability.trace import get_trace
from kfac_pytorch_tpu_torch.ops import precondition as precond_ops
from kfac_pytorch_tpu_torch.parallel.assignment import (
    FactorShardPlan,
    plan_factor_shards,
    plan_fingerprint,
)
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

_REPLANS = {"count": 0}
# the levers' scalars a resize carries (eigen_swap_slip is reset)
_CARRIED = ("spectrum_mass", "stream_residual", "stream_fold_steps")


def _remap_rows(old: torch.Tensor, new: torch.Tensor, old_plan: FactorShardPlan,
                new_plan: FactorShardPlan, size: int, diag: bool) -> torch.Tensor:
    """Copy every slot's row(s) from the old stack layout into the new."""
    old_rows = (old_plan.diag_group_rows if diag else old_plan.group_rows)[size]
    new_rows = (new_plan.diag_group_rows if diag else new_plan.group_rows)[size]
    for s_new in new_plan.group_slots(size, diag):
        s_old = old_plan.slot(s_new.name, s_new.factor)
        new[s_new.owner * new_rows + s_new.row] = old[s_old.owner * old_rows + s_old.row]
    return new


def _plans(shapes, diag_a, old_world: int, new_world: int, max_bucket_elems: int,
           expect_fingerprint: Optional[str] = None) -> Tuple[FactorShardPlan, FactorShardPlan]:
    diag_a = set(diag_a)
    old_plan = plan_factor_shards(shapes, int(old_world), max_bucket_elems, diag_a=diag_a)
    if expect_fingerprint is not None:
        derived = plan_fingerprint(old_plan)
        if derived != expect_fingerprint:
            raise ValueError(
                f"re-derived owner-shard plan for world={old_world} has "
                f"fingerprint {derived}, but the snapshot was laid out as "
                f"{expect_fingerprint} — shapes or the LPT policy changed "
                f"since it was written"
            )
    new_plan = plan_factor_shards(shapes, int(new_world), max_bucket_elems, diag_a=diag_a)
    return old_plan, new_plan


def remap_owner_stacks(
    factor_shard: Dict[str, torch.Tensor],
    eigen_shard: Dict[str, Dict[str, torch.Tensor]],
    shapes: Dict[str, Tuple[int, int]],
    diag_a,
    old_world: int,
    new_world: int,
    max_bucket_elems: int,
    expect_fingerprint: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict[str, torch.Tensor]]]:
    """The global-form owner stacks of ``old_world`` ranks re-laid for
    ``new_world`` ranks: ``(factor_shard, eigen_shard)`` with every slot's
    row where the new plan puts it, zero pad rows, the same dtypes.

    The plans are ``plan_factor_shards(shapes, world, max_bucket_elems,
    diag_a)``; a given ``expect_fingerprint`` (the manifest's) must be the
    old plan's, else ``ValueError``. A host function of its inputs: any
    world, no process group."""
    old_plan, new_plan = _plans(shapes, diag_a, old_world, new_world, max_bucket_elems,
                                expect_fingerprint)

    def remap(old: torch.Tensor, n: int, diag: bool) -> torch.Tensor:
        rows = (new_plan.diag_group_rows if diag else new_plan.group_rows)[n]
        new = old.new_zeros((new_plan.world * rows, *old.shape[1:]))
        return _remap_rows(old, new, old_plan, new_plan, n, diag)

    new_factor = {f"n{n}": remap(factor_shard[f"n{n}"], n, False) for n in new_plan.group_sizes}
    new_factor.update({f"v{n}": remap(factor_shard[f"v{n}"], n, True)
                       for n in new_plan.diag_group_sizes})
    new_eigen = {}
    for key, grp in eigen_shard.items():
        n, diag = int(key[1:]), key.startswith("v")
        new_eigen[key] = {leaf: remap(t, n, diag) for leaf, t in grp.items()}
    return new_factor, new_eigen


def _rows_of(stacks: Any, plan: FactorShardPlan, rank: int) -> Any:
    """Rank ``rank``'s rows of global-form stacks."""
    return ckpt._map(stacks, lambda t: t.reshape(plan.world, -1, *t.shape[1:])[rank].contiguous())


def replicated_state_from_owner(kfac: Any, state: Dict[str, Any], template: Dict[str, Any],
                                plan: FactorShardPlan) -> Dict[str, Any]:
    """A replicated state from a global-form owner one laid out by ``plan``:
    every layer's factors and eigen entries from its slots' rows, in
    ``template``'s layout (a replicated ``kfac.init``), the carried
    scalars from ``state``, everything else ``template``'s."""
    shard, eigen_shard = state["factor_shard"], state["eigen_shard"]
    factors: Dict[str, Dict[str, torch.Tensor]] = {}
    eigen: Dict[str, Dict[str, torch.Tensor]] = {}
    for s in plan.slots:
        if s.diag:
            rows = plan.diag_group_rows[s.size]
            r = s.owner * rows + s.row
            factors.setdefault(s.name, {})["A_diag"] = shard[f"v{s.size}"][r]
            eigen.setdefault(s.name, {})["dA"] = eigen_shard[f"v{s.size}"]["d"][r]
            continue
        r = s.owner * plan.group_rows[s.size] + s.row
        factors.setdefault(s.name, {})[s.factor] = shard[f"n{s.size}"][r]
        for field, t in eigen_shard[f"n{s.size}"].items():
            eigen.setdefault(s.name, {})[f"{field}{s.factor}"] = t[r]
    # the template's layer order: a same-shape group stacks its layers' rows
    # in it
    singles, stacked = precond_ops.split_eigen_state({n: eigen[n] for n in template["factors"]})
    out = dict(template)
    out.update(step=state["step"], factors=factors, eigen=singles, eigen_stacked=stacked)
    out.update({k: state[k] for k in _CARRIED if k in state and k in template})
    return out


def resize_owner_state(
    kfac: Any,
    state: Dict[str, Any],
    params: Any,
    old_world: int,
    expect_fingerprint: Optional[str] = None,
) -> Dict[str, Any]:
    """This rank's K-FAC state from a global-form owner state saved on
    ``old_world`` ranks, for ``kfac``'s (differently sized) world.

    ``kfac`` is the preconditioner built for the NEW world
    (``factor_sharding="owner"``; on one rank it runs replicated and gets
    the gathered-back replicated state); ``state`` the snapshot's K-FAC
    state; ``params`` the model, the shape oracle both plans derive from.
    The manifest's ``shard_plan_fingerprint`` as ``expect_fingerprint``
    verifies the re-derived old plan against the layout that wrote the
    stacks, refusing drift instead of reading rows from the wrong owners.
    """
    if getattr(kfac, "requested_factor_sharding", None) != "owner":
        raise ValueError(
            "resize_owner_state() needs the target preconditioner in "
            "factor_sharding='owner'"
        )
    if not ckpt.owner_form(state):
        raise ValueError(
            "resize_owner_state() takes an owner-form state (has "
            "'factor_shard'); replicated states are mesh-independent — "
            "rehome them via training.checkpoint.rehome_kfac_state"
        )
    shapes, diag_a = kfac.factor_shapes(params)
    bucket = kfac.factor_comm.max_bucket_elems
    if not kfac.owner_sharded:
        old_plan, _ = _plans(shapes, diag_a, old_world, 1, bucket, expect_fingerprint)
        new_state = replicated_state_from_owner(kfac, state, kfac.init(params), old_plan)
        new_world, fingerprint = 1, None
    else:
        factor_shard, eigen_shard = remap_owner_stacks(
            state["factor_shard"], state["eigen_shard"], shapes, diag_a, old_world,
            kfac.world.size, bucket, expect_fingerprint)
        new_plan = kfac._shard_plan(shapes, frozenset(diag_a))
        factor_shard = _rows_of(factor_shard, new_plan, kfac.world.rank)
        eigen_shard = _rows_of(eigen_shard, new_plan, kfac.world.rank)
        new_state = {
            "step": state["step"],
            "factors": state["factors"],
            "eigen": {},
            "eigen_stacked": {},
            "factor_shard": factor_shard,
            "eigen_shard": eigen_shard,
        }
        # pending pass zeroed, deferred accumulators zeroed, slip reset
        kfac._owner_optional_entries(new_state, shapes, diag_a, eigen_shard,
                                     old={k: state[k] for k in _CARRIED if k in state})
        new_world, fingerprint = new_plan.world, plan_fingerprint(new_plan)

    _REPLANS["count"] += 1
    get_telemetry().set_gauge("kfac/replan_count", _REPLANS["count"])
    tr = get_trace()
    if tr.enabled:
        tr.event("replan", plan_fingerprint=fingerprint, old_world=int(old_world),
                 new_world=int(new_world))
    return new_state


def replan_state(
    kfac: Any,
    state: Any,
    params: Any,
    old_world: int,
    expect_fingerprint: Optional[str] = None,
) -> Any:
    """This rank's K-FAC state from a snapshot's global-form one, for every
    restore case the elastic runtime meets:

    * no owner form, or a target that never asked for the owner mode: the
      checkpoint's re-home (``rehome_kfac_state``: a replicated state is
      world-independent, or re-homed into owner rows; an owner state into
      a replicated preconditioner is refused);
    * owner target, same world: this rank's rows, bitwise;
    * owner target, another world: the :func:`resize_owner_state` remap.
    """
    if kfac is None or state is None:
        return state
    if not ckpt.owner_form(state) or getattr(kfac, "requested_factor_sharding", None) != "owner":
        return ckpt.rehome_kfac_state(kfac, state)
    if int(old_world) == int(kfac.world.size):
        return ckpt.local_kfac_state(state, kfac.world, int(old_world))
    return resize_owner_state(kfac, state, params, old_world,
                              expect_fingerprint=expect_fingerprint)
