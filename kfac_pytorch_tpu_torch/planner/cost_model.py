"""Analytic per-lever cost/benefit model → concrete :class:`Plan`.

Port of ``kfac_pytorch_tpu/planner/cost_model.py`` with its decision
constants unchanged: they are dimensionless thresholds, and the port's
tests hold its resolved plans to the JAX package's golden plans
(``scripts/plan_snapshots/``, ``"pallas"`` read as ``"kernel"``). Whether
an H100 wants other thresholds is for a benchmark to judge; the drift
gauges (``planner/drift.py``) measure their premises on the card.

The planner does not invent new cost tables: it reuses the exact host-side
primitives the runtime already schedules with, so the plan it picks and
the program that runs cannot disagree about what is expensive:

* refresh cost per (layer, side) — ``parallel.assignment._slot_cost``,
  the same padded-eigh / rank-aware matmul cost the chunk planners
  balance with (dense ``bucket³``, truncated ``m²·(r+p)·passes``);
* every-step precondition cost — the ``g²a + ga²`` MAC count
  ``precondition_assignment`` LPT-balances (``g²a`` for diagonal-A);
* bytes on the wire — ``plan_factor_buckets`` over the stat-leaf shapes
  (the comm plane's own bucketing) and ``plan_factor_shards`` /
  ``shard_plan_bytes`` for the owner-sharded layout.

Every decision below is a deterministic integer comparison, so every host
resolves the same plan from the same (shapes, env), whatever the order of
the layers — the same discipline as the assignment tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Optional, Tuple, Union

from kfac_pytorch_tpu_torch.parallel.assignment import (
    _slot_cost,
    plan_factor_buckets,
    plan_factor_shards,
    shard_plan_bytes,
)
from kfac_pytorch_tpu_torch.planner.profiles import (
    PROFILES,
    Plan,
    PlanEnv,
    fit_plan,
)

# Decision thresholds, the JAX package's values. Plain module constants
# (not config): they are the cost model, and changing them shows up as a
# diff against scripts/plan_snapshots/.

#: rsvd engages only when the dense refresh costs at least this multiple
#: of the truncated refresh — below that the Woodbury apply path's extra
#: rotations are not worth the refresh savings.
RSVD_MIN_SPEEDUP = 2.0
#: ... and only when some factor side actually crosses the solver's
#: default threshold (a model with all sides < 512 truncates nothing).
RSVD_SIDE_THRESHOLD = 512
RSVD_RANK = 128
#: drift gauge trip point for the streaming solver the production profile
#: engages in place of periodic rsvd: re-orthonormalize when the retained
#: bases stop explaining 95% of the curvature mass.
STREAM_DRIFT_THRESHOLD = 0.05
#: chunk the refresh until the per-boundary eigh spike is no more than
#: this multiple of one step's precondition work.
CHUNK_SPIKE_BUDGET = 32
MAX_CHUNKS = 8
#: bf16 wire compression engages when one f32 factor exchange moves at
#: least this many bytes per replica (below it, latency dominates and
#: halving payload buys nothing).
COMM_BF16_MIN_BYTES = 256 * 1024
#: ... and the int8 wire (block-scaled quantization with error feedback,
#: parallel/comm.py) engages at twice that bar: quartering the payload
#: only beats bf16 when the exchange is deeply payload-bound, and the
#: quantize/dequantize passes plus the error-feedback state are pure
#: overhead below it. Requires the deferred path (comm_freq > 1) for the
#: residual accumulators and is incompatible with owner sharding
#: (psum_scatter would widen the codes on-wire) — _resolve_production
#: checks both before engaging.
COMM_INT8_MIN_BYTES = 2 * COMM_BF16_MIN_BYTES
#: deferred reduction engages when there are ≥ this many capture steps
#: per eigen refresh to amortize over (and then defers every
#: ``COMM_DEFER_FREQ``-th capture step).
COMM_DEFER_MIN_RATIO = 10
COMM_DEFER_FREQ = 10
#: owner sharding engages at this world size — below it the reduce-
#: scatter/allgather restructuring saves too little memory to pay for
#: losing replicated-state simplicity.
OWNER_MIN_WORLD = 8
#: the curvature service engages — given an operator-offered carve
#: (``env.service_devices > 0``, devices already removed from the training
#: mesh) — when one interval's DENSE refresh work exceeds this multiple of
#: the training capacity the carved devices give up over the same interval
#: (``service_devices/world · kfac_update_freq · precondition_cost``).
#: Below the bar, the carve loses more capture throughput than the
#: refresh spike it removes; an offered-but-unprofitable carve resolves
#: with the service unengaged.
SERVICE_MIN_REFRESH_RATIO = 3.0

# eigh slot padding defaults (the JAX package's ops/eigh.py bucket_size
# defaults, as used by the chunk planners in parallel/assignment.py)
_GRANULARITY = 512
_MINIMUM = 128


@dataclasses.dataclass(frozen=True)
class ModelFacts:
    """What the cost model needs to know about a captured model.

    ``shapes`` maps layer name → ``(g_side, a_side)`` exactly as
    ``KFAC.init`` derives them (conv: ``a = cin·kh·kw + bias``, ``g =
    cout``; dense: ``a = cin + bias``, ``g = cout``; embedding: ``a =
    vocab`` but flagged in ``diag_a`` — its A factor is a diagonal
    vector, not a matrix). Build from live params via
    :func:`model_facts`, or literally for fixtures.
    """

    shapes: Dict[str, Tuple[int, int]]
    diag_a: FrozenSet[str] = frozenset()
    has_conv: bool = False
    # Sharded-parameter layers (kfac_pytorch_tpu/shardwise/): layer name →
    # (form, block count) for "#c"/"#r"/"#e" entries. Their ``shapes``
    # entry holds the PER-BLOCK (g, a) sides; the cost functions below
    # multiply out the stack. Empty for pre-shardwise models.
    shard_counts: Dict[str, Tuple[str, int]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def has_diag_a(self) -> bool:
        return bool(self.diag_a)

    @property
    def has_shard_lens(self) -> bool:
        return any(f in ("c", "r") for f, _ in self.shard_counts.values())

    @property
    def has_moe(self) -> bool:
        return any(f == "e" for f, _ in self.shard_counts.values())


def model_facts(model, layers=None) -> ModelFacts:
    """Derive :class:`ModelFacts` from a live ``nn.Module``.

    Mirrors ``KFAC.init``'s factor-side derivation (preconditioner.py's
    ``_identity_factors``): ``layers`` are the K-FAC layer names
    (``capture.discover_layers(model)`` by default), grouped-conv and
    lens-split pseudo-layers included; a shard-lens or MoE entry gets its
    per-block sides, from the module's own (possibly split) weight.
    """
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACEmbed

    names = list(layers) if layers is not None else capture.discover_layers(model)
    shapes: Dict[str, Tuple[int, int]] = {}
    diag_a = set()
    has_conv = False
    shard_counts: Dict[str, Tuple[str, int]] = {}
    for name in names:
        base = capture.layer_base(name)
        m = model.get_submodule(base)
        _, form, count = capture.split_shard_name(name)
        if form is not None:
            local = getattr(m, "local_shards", count)
            if form == "e":
                # MoE expert bank: [E, a, m] weight, per-expert (m, a)
                _, a_in, m_out = m.weight.shape
                shapes[name] = (int(m_out), int(a_in))
            elif form == "c":
                # column: shared A side, per-shard G side
                m_out, a_in = m.weight.shape
                has_bias = getattr(m, "bias", None) is not None
                shapes[name] = (int(m_out) // local, int(a_in) + int(has_bias))
            else:
                # row: per-shard A side (bias-free), shared G side
                m_out, a_in = m.weight.shape
                shapes[name] = (int(m_out), int(a_in) // local)
            shard_counts[name] = (form, count)
            continue
        if isinstance(m, KFACEmbed):
            vocab, feats = m.weight.shape
            shapes[name] = (int(feats), int(vocab))
            diag_a.add(name)
            continue
        has_bias = m.bias is not None
        if isinstance(m, KFACConv):
            cout, cin, kh, kw = m.weight.shape  # cin: in/G already
            a_side = cin * kh * kw + int(has_bias)
            has_conv = True
        else:
            cout, cin = m.weight.shape
            a_side = cin + int(has_bias)
        # a group's or a lens split's output slice
        shapes[name] = (int(cout) // len(capture.pseudo_layers(base, m)), int(a_side))
    return ModelFacts(
        shapes=shapes, diag_a=frozenset(diag_a), has_conv=has_conv,
        shard_counts=shard_counts,
    )


def _rank_fn_for(plan: Plan):
    """The size→rank policy a plan implies — same rule as
    ``KFAC._rank_for`` so planner costs match runtime layouts."""
    if plan.solver not in ("rsvd", "streaming"):
        return None

    def rank_for(n: int) -> Optional[int]:
        if n < plan.solver_auto_threshold or plan.solver_rank >= n:
            return None
        return plan.solver_rank

    return rank_for


def _dense_sides(facts: ModelFacts):
    """Every dense factor side the refresh decomposes: diag-A layers
    contribute only their G side (the A refresh is elementwise); shard
    entries contribute one per-block side per stacked block (column:
    shared A + T G blocks; row: T A blocks + shared G; MoE: E of each)."""
    sides = []
    for name in sorted(facts.shapes):
        g, a = facts.shapes[name]
        form, count = facts.shard_counts.get(name, (None, 1))
        if form == "c":
            sides.append(a)
            sides.extend([g] * count)
        elif form == "r":
            sides.extend([a] * count)
            sides.append(g)
        elif form == "e":
            sides.extend([a] * count)
            sides.extend([g] * count)
        else:
            if name not in facts.diag_a:
                sides.append(a)
            sides.append(g)
    return sides


def refresh_cost(facts: ModelFacts, plan: Plan) -> int:
    """Total MAC cost of one curvature refresh under ``plan``'s solver."""
    rank_fn = _rank_fn_for(plan)
    return sum(
        _slot_cost(n, _GRANULARITY, _MINIMUM, rank_fn)
        for n in _dense_sides(facts)
    )


def precondition_cost(facts: ModelFacts) -> int:
    """Every-step gradient-rotation MACs, summed over layers — the same
    ``g²a + ga²`` (``g²a`` diag-A) count the LPT assignment balances."""
    total = 0
    for name, (g, a) in facts.shapes.items():
        form_count = facts.shard_counts.get(name)
        if form_count is not None:
            # per-block rotation cost × block count, on the per-block sides
            total += form_count[1] * (g * g * a + g * a * a)
        elif name in facts.diag_a:
            total += g * g * a
        else:
            total += g * g * a + g * a * a
    return total


def wire_bytes_f32(facts: ModelFacts) -> Tuple[int, int]:
    """(bytes per replica, bucket count) of one f32 factor exchange.

    Leaf shapes match what the comm plane flattens: dense ``(a,a)`` +
    ``(g,g)`` per layer, diag-A ``(a,)`` + ``(g,g)``; bucketed by the
    plane's own ``plan_factor_buckets`` so the count is its collective
    count.
    """
    buckets = plan_factor_buckets(_factor_leaf_shapes(facts))
    return sum(b.size for b in buckets) * 4, len(buckets)


def _factor_leaf_shapes(facts: ModelFacts):
    """The stat-leaf shapes the comm plane flattens, in wire order."""
    leaf_shapes = []
    for name in sorted(facts.shapes):
        g, a = facts.shapes[name]
        form, count = facts.shard_counts.get(name, (None, 1))
        if form == "c":
            leaf_shapes.append((a, a))
            leaf_shapes.append((count, g, g))
        elif form == "r":
            leaf_shapes.append((count, a, a))
            leaf_shapes.append((g, g))
        elif form == "e":
            leaf_shapes.append((count, a, a))
            leaf_shapes.append((count, g, g))
        elif name in facts.diag_a:
            leaf_shapes.append((a,))
            leaf_shapes.append((g, g))
        else:
            leaf_shapes.append((a, a))
            leaf_shapes.append((g, g))
    return leaf_shapes


def plan_wire_bytes(facts: ModelFacts, plan: Plan) -> int:
    """Predicted bytes per replica of one factor exchange under ``plan``'s
    wire dtype — the number ``FactorComm._plan_for`` publishes on the
    ``kfac/factor_wire_bytes`` gauge at runtime, derived the same way:
    f32/bf16 pay ``itemsize`` per element; int8 pays 1 byte per element
    plus 4 bytes per 256-element block scale over the SAME per-bucket
    sizes the plane plans (``parallel.comm.quant_wire_bytes`` — scales
    are per bucket-local block, so boundaries matter)."""
    from kfac_pytorch_tpu_torch.parallel.comm import quant_wire_bytes

    buckets = plan_factor_buckets(_factor_leaf_shapes(facts))
    sizes = [b.size for b in buckets]
    if plan.factor_comm_dtype == "int8":
        return quant_wire_bytes(sizes)
    itemsize = {"f32": 4, "bf16": 2}[plan.factor_comm_dtype]
    return sum(sizes) * itemsize


def service_carve_cost(facts: ModelFacts, env: PlanEnv) -> int:
    """The curvature-service engagement bar, in MACs per refresh interval.

    The training capacity the offered carve gives up — per-step
    precondition work scaled by the carved device fraction and the
    interval length — times :data:`SERVICE_MIN_REFRESH_RATIO`. 0 when no
    carve is offered (or there is no multi-device mesh to carve from), so
    ``dense refresh > bar > 0`` is the whole engagement test.
    """
    if env.service_devices <= 0 or not env.multi_device:
        return 0
    return int(
        SERVICE_MIN_REFRESH_RATIO
        * env.service_devices
        * env.kfac_update_freq
        * precondition_cost(facts)
        / env.world
    )


@dataclasses.dataclass(frozen=True)
class CostReport:
    """The numbers behind a resolved plan — what the snapshot lint pins
    and ``docs/PLANNER.md`` documents. All integer MACs/bytes except the
    speedup ratio (rounded to 3 places for stable goldens)."""

    world: int
    layer_count: int
    dense_side_count: int
    max_side: int
    refresh_cost_dense: int
    refresh_cost_resolved: int
    rsvd_speedup: float
    precondition_cost: int
    wire_bytes_f32: int
    wire_bucket_count: int
    owner_bytes_local: Optional[int]
    owner_bytes_replicated: Optional[int]
    # Curvature-service numbers (defaults keep pre-service callers and
    # goldens constructible): the carve the resolved plan engages and the
    # engagement bar the dense refresh was judged against (0 = no carve
    # offered).
    service_devices: int = 0
    service_carve_cost: int = 0

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _resolve_production(facts: ModelFacts, env: PlanEnv) -> Plan:
    """The profile="production" intent: every lever the model judges
    profitable, before :func:`fit_plan` drops what the env refuses."""
    sides = _dense_sides(facts)
    max_side = max(sides) if sides else 0
    precond = precondition_cost(facts)
    dense_cost = refresh_cost(facts, Plan())

    # service: decided FIRST — when an operator-offered carve clears the
    # engagement bar, the refresh leaves the training step entirely, which
    # supersedes every in-step refresh lever below (solver truncation,
    # chunk spreading, owner-sharded eigen state). The worker refreshes
    # dense eigh on whole replicated factors (the service exclusions), and
    # a one-step staleness budget licenses install slip.
    carve_bar = service_carve_cost(facts, env)
    service = env.service_devices if (
        carve_bar > 0 and dense_cost > carve_bar
    ) else 0

    if service:
        plan = Plan(service_devices=service, staleness_budget=1)
    else:
        # solver: truncate when it actually shrinks the refresh enough.
        # Where periodic rsvd pays off, streaming pays off strictly more:
        # the same truncated layout, but the recurring refresh becomes a
        # drift-gated re-orth while capture steps fold with matmuls only.
        candidate = Plan(
            solver="streaming",
            solver_rank=RSVD_RANK,
            solver_auto_threshold=RSVD_SIDE_THRESHOLD,
            stream_drift_threshold=STREAM_DRIFT_THRESHOLD,
        )
        rsvd_cost = refresh_cost(facts, candidate)
        use_rsvd = (
            max_side >= RSVD_SIDE_THRESHOLD
            and rsvd_cost > 0
            and dense_cost / rsvd_cost >= RSVD_MIN_SPEEDUP
        )
        plan = candidate if use_rsvd else Plan()

        # chunks: spread the refresh spike until it is within budget of
        # one step's precondition work (scheduler clamps k_eff to the
        # refresh interval, so cap there too). Streaming has no recurring
        # spike to spread (streaming_vs_chunks) — chunks stay 1.
        resolved_refresh = refresh_cost(facts, plan)
        if precond > 0 and plan.solver != "streaming":
            want = math.ceil(
                resolved_refresh / (CHUNK_SPIKE_BUDGET * precond)
            )
            chunks = max(1, min(want, MAX_CHUNKS, env.kfac_update_freq))
        else:
            chunks = 1
        plan = dataclasses.replace(plan, eigh_chunks=chunks)

    # placement is decided in the wire block below, but the DECISION has
    # to precede the wire dtype: the int8 wire is incompatible with owner
    # sharding (int8_wire_vs_owner_sharding), so an owner-bound plan must
    # stop at bf16 rather than engage a dtype fit_plan would strip.
    will_owner = env.factor_world >= OWNER_MIN_WORLD and not service

    # wire: compress when the exchange is payload-bound; defer when there
    # are enough capture steps per refresh to amortize over. The int8
    # wire engages past its own (higher) payload bar, and only where the
    # error-feedback residuals have a home: the deferred path.
    if env.world > 1:
        bytes_f32, _ = wire_bytes_f32(facts)
        ratio = env.kfac_update_freq // max(1, env.fac_update_freq)
        comm_freq = (
            min(COMM_DEFER_FREQ, ratio)
            if ratio >= COMM_DEFER_MIN_RATIO
            else 1
        )
        if (
            bytes_f32 >= COMM_INT8_MIN_BYTES
            and comm_freq > 1
            and not will_owner
        ):
            comm_dtype = "int8"
        elif bytes_f32 >= COMM_BF16_MIN_BYTES:
            comm_dtype = "bf16"
        else:
            comm_dtype = "f32"
        plan = dataclasses.replace(
            plan, factor_comm_dtype=comm_dtype, factor_comm_freq=comm_freq
        )

    # placement: owner-shard the curvature state at scale (the shard world
    # is the data axes only — tensor replicas hold identical rows). Not
    # under service: the worker consumes whole replicated factors
    # (service_vs_owner_sharding would drop the carve in fit_plan).
    if will_owner:
        plan = dataclasses.replace(plan, factor_sharding="owner")

    # overlap: fuse the factor exchange into the gradient stream whenever
    # there IS one — the reorder is bitwise-inert, so the only cost is the
    # explicit-wrapper requirement fit_plan already polices. A one-step
    # staleness budget engages alongside it when the schedule has slack to
    # slip into (deferred flushes or a chunked refresh).
    if env.world > 1:
        plan = dataclasses.replace(plan, comm_overlap=True)
        # streaming has no pending swap to slip (streaming_vs_swap_slip);
        # service already carries its install-slip budget from above
        if (
            (plan.factor_comm_freq > 1 or plan.eigh_chunks > 1)
            and plan.solver != "streaming"
            and not service
        ):
            plan = dataclasses.replace(plan, staleness_budget=1)

    # kernel: pin the hand-written capture kernels where they run — the
    # conv A kernel (kernel 1) and the embedding token-count kernel
    # (kernel 2) both ride the same factor_kernel dispatch ("auto" already
    # resolves to them on CUDA tensors; pinning records the decision in the
    # plan, as the JAX package pins Pallas on a TPU)
    if (facts.has_conv or facts.has_diag_a) and env.on_cuda:
        plan = dataclasses.replace(plan, factor_kernel="kernel")
    # apply kernel: the fused eigenbasis apply and SGD (kernels 3 and 4)
    # serve every captured model — the dense rotate/scale/back-rotate chain
    # they replace runs per layer per step regardless of layer family. On
    # the CPU "auto" already resolves to the plain versions; pin only where
    # the kernels run. Inverse-method envs drop it via
    # apply_pallas_vs_inverse.
    if env.on_cuda:
        plan = dataclasses.replace(plan, apply_kernel="kernel")
    return plan


def _resolve_memory(facts: ModelFacts, env: PlanEnv) -> Plan:
    """The profile="memory" intent: minimize per-device curvature bytes.

    Owner sharding divides factor+eigen state by the owner count, the
    truncated solver shrinks each eigenbasis from n² to n·r, and the
    bf16 wire halves exchange payload. ``eigh_chunks`` stays 1 — the
    pipelined refresh double-buffers the eigen state (eigen_pending),
    the opposite of a memory win.
    """
    sides = _dense_sides(facts)
    max_side = max(sides) if sides else 0
    plan = Plan(
        factor_sharding="owner" if env.factor_world > 1 else "replicated",
        factor_comm_dtype="bf16" if env.world > 1 else "f32",
    )
    if max_side >= RSVD_SIDE_THRESHOLD:
        plan = dataclasses.replace(
            plan,
            solver="rsvd",
            solver_rank=RSVD_RANK,
            solver_auto_threshold=RSVD_SIDE_THRESHOLD,
        )
    return plan


def resolve_profile(
    profile: Union[str, Plan],
    facts: Optional[ModelFacts],
    env: PlanEnv,
) -> Tuple[Plan, Optional[CostReport], Tuple[str, ...]]:
    """Resolve a named profile (or fit an explicit plan) against an env.

    Returns ``(plan, report, dropped)``: the valid plan, the cost numbers
    it was derived from (``None`` when no shapes were available — then
    only the world-size levers resolve), and the names of the validity
    rules :func:`fit_plan` applied.
    """
    if isinstance(profile, Plan):
        plan, dropped = fit_plan(profile, env)
        report = _report(facts, env, plan) if facts is not None else None
        return plan, report, dropped
    if profile not in PROFILES:
        raise ValueError(
            f"unknown profile {profile!r}; expected one of "
            f"{tuple(PROFILES)} or a planner.Plan"
        )
    if profile == "safe":
        return Plan(), (
            _report(facts, env, Plan()) if facts is not None else None
        ), ()
    if facts is None:
        # No shapes: resolve only what the mesh alone decides. The
        # shape-driven levers (solver, chunks, wire compression) stay at
        # defaults rather than guessing.
        intent = Plan(
            factor_sharding=(
                "owner"
                if (
                    profile == "memory"
                    and env.factor_world > 1
                    or env.factor_world >= OWNER_MIN_WORLD
                )
                else "replicated"
            )
        )
        plan, dropped = fit_plan(intent, env)
        return plan, None, dropped
    intent = (
        _resolve_memory(facts, env)
        if profile == "memory"
        else _resolve_production(facts, env)
    )
    plan, dropped = fit_plan(intent, env)
    return plan, _report(facts, env, plan), dropped


def _report(facts: ModelFacts, env: PlanEnv, plan: Plan) -> CostReport:
    sides = _dense_sides(facts)
    dense_cost = refresh_cost(facts, Plan())
    resolved_cost = refresh_cost(facts, plan)
    bytes_f32, buckets = wire_bytes_f32(facts)
    owner_local = owner_repl = None
    if plan.factor_sharding == "owner" and env.factor_world > 1:
        shard = plan_factor_shards(
            facts.shapes, env.factor_world, diag_a=set(facts.diag_a)
        )
        info = shard_plan_bytes(shard, rank_fn=_rank_fn_for(plan))
        owner_local = int(info["total_buffer_local"])
        owner_repl = int(info["replicated_total"])
    return CostReport(
        world=env.world,
        layer_count=len(facts.shapes),
        dense_side_count=len(sides),
        max_side=max(sides) if sides else 0,
        refresh_cost_dense=dense_cost,
        refresh_cost_resolved=resolved_cost,
        rsvd_speedup=round(dense_cost / resolved_cost, 3)
        if resolved_cost
        else 1.0,
        precondition_cost=precondition_cost(facts),
        wire_bytes_f32=bytes_f32,
        wire_bucket_count=buckets,
        owner_bytes_local=owner_local,
        owner_bytes_replicated=owner_repl,
        service_devices=int(plan.service_devices),
        service_carve_cost=service_carve_cost(facts, env),
    )
