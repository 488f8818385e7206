"""Plan: one value per K-FAC perf lever, plus the composition validity matrix.

Port of ``kfac_pytorch_tpu/planner/profiles.py``. The levers
(``eigh_chunks``, ``factor_kernel``, ``factor_comm_dtype``/``factor_comm_freq``,
``solver``/``solver_rank``, ``factor_sharding``, ``comm_overlap``,
``staleness_budget``, ``service_devices``, ``apply_kernel``) each refuse
the compositions they cannot run; this module holds those refusals as ONE
declarative matrix, the table ``KFAC.__init__`` and ``KFAC.init`` refuse
through:

* :class:`Plan` — an immutable record of the lever settings, the unit
  the cost model resolves, the autotuner times, and ``KFAC(profile=...)``
  consumes.
* :class:`PlanEnv` — the non-lever context a plan must be valid against
  (mesh shape, preconditioner method, model facts).
* :data:`RULES` / :func:`violations` / :func:`fit_plan` — the validity
  matrix itself. Every rule names the code that enforces it, and a rule the
  constructor enforces carries the constructor's own wording
  (:attr:`Rule.refusal`, the JAX constructor's messages word for word), so
  :func:`constructor_refusals` is the one place the port's ``KFAC``
  decides what it refuses.

The port's kernel levers take ``"auto"|"kernel"|"dense"``: the JAX
package's ``"pallas"`` is ``"kernel"`` here, and :attr:`PlanEnv.on_cuda`
(the hand kernels' device) takes the place of ``on_tpu``. Two rules differ
from the JAX table by design: the port's constructor, which knows its
world, refuses the comm and overlap levers on a seq axis itself (the JAX
package leaves them to the train step), and it refuses
``apply_kernel="kernel"`` under the inverse method where the JAX package
warns and degrades (the port's ``"kernel"`` means the hand kernel or an
error).

Named profiles (the strings ``KFAC(profile=...)`` accepts) live here as
declarative intents; the shape-aware resolution that turns an intent into
a concrete :class:`Plan` is ``planner.cost_model.resolve_profile``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# The lever fields and their bitwise-inert defaults — must mirror the
# KFAC constructor defaults exactly (preconditioner.py).
LEVER_FIELDS = (
    "eigh_chunks",
    "factor_kernel",
    "factor_comm_dtype",
    "factor_comm_freq",
    "solver",
    "solver_rank",
    "solver_auto_threshold",
    "factor_sharding",
    "comm_overlap",
    "staleness_budget",
    "stream_drift_threshold",
    "service_devices",
    "apply_kernel",
)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One concrete composition of the K-FAC perf levers.

    All defaults are the bitwise-inert values: a default ``Plan()`` run
    through ``KFAC(profile=Plan())`` configures exactly what ``KFAC()``
    does today. ``solver_rank``/``solver_auto_threshold`` only matter when
    ``solver="rsvd"`` (they mirror the constructor args of the same name).
    """

    eigh_chunks: int = 1
    factor_kernel: str = "auto"
    factor_comm_dtype: str = "f32"
    factor_comm_freq: int = 1
    solver: str = "eigh"
    solver_rank: int = 128
    solver_auto_threshold: int = 512
    factor_sharding: str = "replicated"
    comm_overlap: bool = False
    staleness_budget: int = 0
    # Only matters when solver="streaming" (mirrors the constructor
    # default): drift-gauge level above which the cadence
    # re-orthonormalizes at a kfac_update_freq boundary.
    stream_drift_threshold: float = 0.05
    # Decoupled curvature service: N devices carved out of the world as
    # dedicated refresh workers (service/). 0 = refresh stays in-step
    # (bitwise-inert default).
    service_devices: int = 0
    # Fused apply (ops/apply_kernels.py, kernels 3 and 4): "auto" resolves
    # like factor_kernel (the CUDA kernels on CUDA tensors, their plain
    # versions on CPU ones); mirrors the constructor default.
    apply_kernel: str = "auto"

    def kfac_kwargs(self) -> Dict[str, object]:
        """The KFAC constructor kwargs this plan pins."""
        return {f: getattr(self, f) for f in LEVER_FIELDS}

    def non_default_levers(self) -> Tuple[str, ...]:
        """Lever names set away from their bitwise-inert defaults.

        ``solver_rank``/``solver_auto_threshold``/``stream_drift_threshold``
        count only when a truncating solver is actually on, and
        ``factor_kernel``/``apply_kernel`` count only when pinned away from
        ``auto`` — matching what changes the compiled program.
        """
        default = Plan()
        out = []
        for f in ("eigh_chunks", "factor_kernel", "factor_comm_dtype",
                  "factor_comm_freq", "solver", "factor_sharding",
                  "comm_overlap", "staleness_budget", "service_devices",
                  "apply_kernel"):
            if getattr(self, f) != getattr(default, f):
                out.append(f)
        return tuple(out)

    def to_dict(self) -> Dict[str, object]:
        return {f: getattr(self, f) for f in LEVER_FIELDS}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Plan":
        unknown = set(d) - set(LEVER_FIELDS)
        if unknown:
            raise ValueError(f"unknown Plan fields: {sorted(unknown)}")
        kwargs = dict(d)
        for f in ("eigh_chunks", "factor_comm_freq", "solver_rank",
                  "solver_auto_threshold", "staleness_budget",
                  "service_devices"):
            if f in kwargs:
                kwargs[f] = int(kwargs[f])
        if "comm_overlap" in kwargs:
            kwargs["comm_overlap"] = bool(kwargs["comm_overlap"])
        if "stream_drift_threshold" in kwargs:
            kwargs["stream_drift_threshold"] = float(
                kwargs["stream_drift_threshold"]
            )
        return cls(**kwargs)

    # -- checkpoint form --------------------------------------------------
    # The categorical levers as small int arrays, so a resolved plan can
    # ride inside a checkpoint and be reconstructed exactly. The JAX
    # package's encoding: "kernel" sits at "pallas"'s index.

    _KERNELS = ("auto", "kernel", "dense")
    # "int8" appended at the END (same contract as _SOLVERS below): the
    # encoded index rides inside checkpoints, so existing entries must
    # keep their positions.
    _COMM_DTYPES = ("f32", "bf16", "int8")
    # "streaming" appended at the END: the encoded index rides inside
    # checkpoints, so existing entries must keep their positions.
    _SOLVERS = ("eigh", "rsvd", "streaming")
    _SHARDINGS = ("replicated", "owner")
    # stream_drift_threshold rides the int32 checkpoint encoding in
    # micro-units (1e-6); plenty for a [0, ~2000] gauge threshold.
    _DRIFT_SCALE = 1_000_000

    def to_state(self) -> Dict[str, np.ndarray]:
        """Array-leaved form (one int32 array per lever)."""
        enc = {
            "eigh_chunks": self.eigh_chunks,
            "factor_kernel": self._KERNELS.index(self.factor_kernel),
            "factor_comm_dtype": self._COMM_DTYPES.index(self.factor_comm_dtype),
            "factor_comm_freq": self.factor_comm_freq,
            "solver": self._SOLVERS.index(self.solver),
            "solver_rank": self.solver_rank,
            "solver_auto_threshold": self.solver_auto_threshold,
            "factor_sharding": self._SHARDINGS.index(self.factor_sharding),
            "comm_overlap": int(self.comm_overlap),
            "staleness_budget": self.staleness_budget,
            "stream_drift_threshold": int(
                round(self.stream_drift_threshold * self._DRIFT_SCALE)
            ),
            "service_devices": self.service_devices,
            "apply_kernel": self._KERNELS.index(self.apply_kernel),
        }
        return {k: np.asarray(v, np.int32) for k, v in enc.items()}

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray]) -> "Plan":
        g = {k: int(np.asarray(v)) for k, v in state.items()}
        return cls(
            eigh_chunks=g["eigh_chunks"],
            factor_kernel=cls._KERNELS[g["factor_kernel"]],
            factor_comm_dtype=cls._COMM_DTYPES[g["factor_comm_dtype"]],
            factor_comm_freq=g["factor_comm_freq"],
            solver=cls._SOLVERS[g["solver"]],
            solver_rank=g["solver_rank"],
            solver_auto_threshold=g["solver_auto_threshold"],
            factor_sharding=cls._SHARDINGS[g["factor_sharding"]],
            # absent in pre-overlap checkpoints: default to inert
            comm_overlap=bool(g.get("comm_overlap", 0)),
            staleness_budget=g.get("staleness_budget", 0),
            # absent in pre-streaming checkpoints: the field default
            stream_drift_threshold=(
                g.get(
                    "stream_drift_threshold",
                    int(round(0.05 * cls._DRIFT_SCALE)),
                )
                / cls._DRIFT_SCALE
            ),
            # absent in pre-service checkpoints: refresh stays in-step
            service_devices=g.get("service_devices", 0),
            # absent in pre-fused-apply checkpoints: index 0 = "auto",
            # the field default
            apply_kernel=cls._KERNELS[g.get("apply_kernel", 0)],
        )

    def describe(self) -> str:
        """One-line human summary (trainer startup banners)."""
        on = self.non_default_levers()
        if not on:
            return "plan: all levers at bitwise-inert defaults"
        bits = []
        if "eigh_chunks" in on:
            bits.append(f"eigh_chunks={self.eigh_chunks}")
        if "factor_kernel" in on:
            bits.append(f"factor_kernel={self.factor_kernel}")
        if "factor_comm_dtype" in on:
            bits.append(f"factor_comm_dtype={self.factor_comm_dtype}")
        if "factor_comm_freq" in on:
            bits.append(f"factor_comm_freq={self.factor_comm_freq}")
        if "solver" in on:
            if self.solver == "streaming":
                bits.append(
                    f"solver=streaming(rank={self.solver_rank},"
                    f"threshold={self.solver_auto_threshold},"
                    f"drift={self.stream_drift_threshold})"
                )
            else:
                bits.append(
                    f"solver={self.solver}(rank={self.solver_rank},"
                    f"threshold={self.solver_auto_threshold})"
                )
        if "factor_sharding" in on:
            bits.append("factor_sharding=owner")
        if "comm_overlap" in on:
            bits.append("comm_overlap=on")
        if "staleness_budget" in on:
            bits.append(f"staleness_budget={self.staleness_budget}")
        if "service_devices" in on:
            bits.append(f"service_devices={self.service_devices}")
        if "apply_kernel" in on:
            bits.append(f"apply_kernel={self.apply_kernel}")
        return "plan: " + " ".join(bits)


@dataclasses.dataclass(frozen=True)
class PlanEnv:
    """Everything a plan's validity and cost depend on besides the levers.

    ``mesh_axes`` is the world's axis-name tuple (empty on one process;
    ``("data",)``, ``("data", "seq")``, ``("data", "tensor")`` or
    ``("data", "fsdp", "tensor")`` for the port's ``parallel.mesh``
    worlds); ``world`` its total process count (1 on one process);
    ``data_world`` the count along the factor (data) axes only — 0 means
    "same as world", which holds without a tensor axis; a data×tensor world
    passes the data size, since owner shard stacks split over the data axis
    while tensor peers hold the same rows. The model facts
    (``has_diag_a_layers``: any embedding/diagonal-A layer captured;
    ``has_conv_layers``: any conv layer) feed the cost model's kernel
    choices — both families have a hand-written capture kernel.
    ``on_cuda`` gates pinning those kernels (on the CPU only their plain
    versions run).
    """

    world: int = 1
    data_world: int = 0  # 0 → world (no tensor axes)
    mesh_axes: Tuple[str, ...] = ()
    precond_method: str = "eigen"
    diag_blocks: int = 1
    distribute_precondition: bool = False
    track_diagnostics: bool = False
    has_diag_a_layers: bool = False
    has_conv_layers: bool = True
    # Sharded-parameter model facts (shardwise/): any
    # column/row/FSDP shard-lens layer ("#c/#r" names), any MoE expert bank
    # ("#e" names). Both default False so pre-shardwise envs decode
    # unchanged.
    has_shard_lens_layers: bool = False
    has_moe_layers: bool = False
    on_cuda: bool = False
    fac_update_freq: int = 10
    kfac_update_freq: int = 100
    # The curvature-service carve the OPERATOR has offered (devices already
    # removed from the training mesh by split_service_mesh) — env, not
    # lever: the cost model may engage plan.service_devices only up to this
    # offer, and never invents a carve the deployment did not make.
    service_devices: int = 0

    @property
    def multi_device(self) -> bool:
        return self.world > 1

    @property
    def factor_world(self) -> int:
        """Replica count the owner shard plans size to (the data axes)."""
        return self.data_world or self.world

    @property
    def pure_dp(self) -> bool:
        """At most one mesh axis outside the batch/tensor conventions —
        what the factor comm plane's single-data-axis collectives require.
        Axes named ``tensor*`` carry replicated or shard-lens compute
        (parallel/mesh.py), and ``fsdp*`` axes carry whole examples
        (parameter sharding only), so the K-FAC collectives ride the
        batch-axes tuple through both."""
        data_axes = [
            a for a in self.mesh_axes
            if not str(a).startswith("tensor") and not str(a).startswith("fsdp")
        ]
        return len(data_axes) <= 1


def _comm_active(plan: Plan) -> bool:
    return plan.factor_comm_dtype != "f32" or plan.factor_comm_freq > 1


@dataclasses.dataclass(frozen=True)
class Rule:
    """One row of the composition validity matrix.

    ``applies`` — does the plan engage the lever this rule guards;
    ``conflicts`` — does the environment (or another lever) refuse it;
    ``drop`` — lever field(s) :func:`fit_plan` clears to satisfy the rule;
    ``enforced_by`` — where the real refusal lives (``"constructor"`` =
    ``KFAC.__init__`` raises, and ``KFAC.init`` for layers it discovers;
    ``"degrade"`` = warn-and-ignore rather than raise);
    ``message`` — the planner's reason (the JAX table's);
    ``refusal`` — the JAX constructor's own ``ValueError`` words for the
    rule, kept only where they differ from ``message`` and a test holds
    them (against the JAX constructor, or the port's earlier words);
    ``{kind}`` names the shard-lens or MoE layers, ``{solver}`` the solver.
    ``None`` raises ``message`` with the rule's name.
    """

    name: str
    applies: Callable[[Plan], bool]
    conflicts: Callable[[Plan, PlanEnv], bool]
    drop: Tuple[str, ...]
    enforced_by: str
    message: str
    refusal: Optional[str] = None

    def refusal_text(self, plan: Plan, env: PlanEnv) -> str:
        """The ``ValueError`` text ``KFAC`` raises for this rule."""
        if self.refusal is None:
            return f"{self.message} (planner rule {self.name})"
        kind = "shard-lens layers" if env.has_shard_lens_layers else "MoE expert banks"
        return self.refusal.format(kind=kind, solver=repr(plan.solver))


# the constructor's words for owner sharding over shard-lens or MoE
# factor stacks, less the rule's name
_OWNER_PIN = (
    "{kind} pin each factor block to the device holding the matching "
    "kernel shard (shardwise.factor_leaf_spec); factor_sharding='owner' "
    "would re-home those blocks onto LPT owners and gather them back every "
    "step — pick one placement scheme (planner rule "
)

RULES: Tuple[Rule, ...] = (
    Rule(
        name="chunks_vs_inverse",
        applies=lambda p: p.eigh_chunks > 1,
        conflicts=lambda p, e: e.precond_method == "inverse",
        drop=("eigh_chunks",),
        enforced_by="constructor",
        message="eigh_chunks > 1 pipelines the eigendecomposition refresh; "
                "precond_method='inverse' has no eigh spike to spread",
        refusal=("eigh_chunks > 1 pipelines the eigendecomposition refresh; "
                 "precond_method='inverse' refreshes via one batched Cholesky "
                 "~30x cheaper than the eigh it replaces — there is no spike "
                 "to spread, so refusing a config that implies one"),
    ),
    Rule(
        name="rsvd_vs_inverse",
        applies=lambda p: p.solver != "eigh",
        conflicts=lambda p, e: e.precond_method == "inverse",
        drop=("solver",),
        enforced_by="constructor",
        message="a truncating solver (rsvd/streaming) feeds the eigenbasis "
                "(Woodbury) apply path; precond_method='inverse' would "
                "silently ignore it",
        refusal=("solver={solver} produces a truncated eigenbasis consumed by "
                 "the eigenbasis (Woodbury) apply path; precond_method="
                 "'inverse' preconditions with explicit Cholesky inverses and "
                 "would silently ignore the configured solver"),
    ),
    Rule(
        name="rsvd_vs_diag_blocks",
        applies=lambda p: p.solver != "eigh",
        conflicts=lambda p, e: e.diag_blocks > 1,
        drop=("solver",),
        enforced_by="constructor",
        message="a truncating solver (rsvd/streaming) stores one basis per "
                "whole factor; diag_blocks > 1 carves factors into blocks",
        refusal=("solver={solver} stores one (Q_r, d_r, rho) triple per whole "
                 "factor; diag_blocks > 1 carves factors into diagonal blocks "
                 "whose truncated bases cannot share that layout — pick one "
                 "approximation"),
    ),
    Rule(
        name="owner_vs_inverse",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.precond_method != "eigen",
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="factor_sharding='owner' shards eigenbasis state; "
                "precond_method='inverse' keeps Cholesky inverses it does "
                "not lay out",
        refusal=("factor_sharding='owner' shards the eigenbasis state; "
                 "precond_method='inverse' keeps explicit Cholesky inverses "
                 "that this mode does not lay out — use the eigen method or "
                 "replicated sharding"),
    ),
    Rule(
        name="owner_vs_diag_blocks",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.diag_blocks > 1,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="factor_sharding='owner' stores one whole-factor slot per "
                "(layer, side); diag_blocks > 1 has its own owner table",
        refusal=("factor_sharding='owner' stores one whole-factor slot per "
                 "(layer, side); diag_blocks > 1 carves factors into blocks "
                 "with their own owner table — pick one distribution scheme"),
    ),
    Rule(
        name="owner_vs_distribute_precondition",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.distribute_precondition,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="factor_sharding='owner' already preconditions each layer "
                "on its owner; distribute_precondition would layer a second "
                "owner table on top",
        refusal=("factor_sharding='owner' already preconditions each layer "
                 "on its owner (that is where its eigenbasis lives); "
                 "distribute_precondition=True would layer a second, "
                 "different owner table on top — drop it"),
    ),
    Rule(
        name="owner_vs_diagnostics",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.track_diagnostics,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="factor_sharding='owner' keeps no replicated per-layer "
                "spectra for the diagnostics pytree to read",
        refusal=("factor_sharding='owner' keeps no replicated per-layer "
                 "spectra for the diagnostics pytree to read — run "
                 "track_diagnostics with replicated sharding"),
    ),
    Rule(
        name="owner_vs_multi_axis_mesh",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.multi_device and not e.pure_dp,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="factor_sharding='owner' requires a single data axis to "
                "shard across (extra axes are allowed only under the "
                "replicated-compute tensor* convention)",
    ),
    # PR-6's owner_vs_diag_a_layers refusal used to live here; owner
    # sharding now lays diagonal-A (embedding) factors out as [vocab]
    # vector slots (parallel/assignment.py v-groups), so the composition
    # is simply valid and has no matrix row.
    Rule(
        name="comm_vs_multi_axis_mesh",
        applies=_comm_active,
        conflicts=lambda p, e: e.multi_device and not e.pure_dp,
        drop=("factor_comm_dtype", "factor_comm_freq"),
        enforced_by="constructor",
        message="factor_comm_dtype/factor_comm_freq ride the explicit "
                "single-data-axis collective wrapper (training/step.py "
                "require_pure_dp_mesh); a mesh with a second non-tensor "
                "axis cannot use them",
    ),
    Rule(
        name="overlap_vs_multi_axis_mesh",
        applies=lambda p: p.comm_overlap,
        conflicts=lambda p, e: e.multi_device and not e.pure_dp,
        drop=("comm_overlap",),
        enforced_by="constructor",
        message="comm_overlap=True fuses factor reductions into the "
                "gradient pmean inside the explicit single-data-axis "
                "wrapper (training/step.py require_pure_dp_mesh); a mesh "
                "with a second non-tensor axis cannot use it",
    ),
    # Degrade rules: not refusals — the constructor warns and runs with the
    # lever inert — but a RESOLVED plan should not carry dead levers, so
    # fit_plan clears them too (and reports them as dropped).
    Rule(
        name="owner_vs_single_device",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: not e.multi_device,
        drop=("factor_sharding",),
        enforced_by="degrade",
        message="factor_sharding='owner' has no effect without a "
                "multi-device mesh — factor state stays replicated",
    ),
    Rule(
        name="comm_vs_single_device",
        applies=_comm_active,
        conflicts=lambda p, e: not e.multi_device,
        drop=("factor_comm_dtype", "factor_comm_freq"),
        enforced_by="degrade",
        message="factor_comm_dtype/factor_comm_freq shape a cross-replica "
                "exchange that does not exist without a multi-device mesh",
    ),
    Rule(
        name="overlap_vs_single_device",
        applies=lambda p: p.comm_overlap,
        conflicts=lambda p, e: not e.multi_device,
        drop=("comm_overlap",),
        enforced_by="degrade",
        message="comm_overlap=True has no effect without a multi-device "
                "mesh — there is no factor exchange to overlap",
    ),
    # Plan-internal streaming exclusions — BEFORE staleness_requires_slack
    # (which must stay last) so a plan that keeps streaming sheds its
    # chunk/budget levers first, exactly as the constructor refuses them.
    Rule(
        name="streaming_vs_chunks",
        applies=lambda p: p.solver == "streaming",
        conflicts=lambda p, e: p.eigh_chunks > 1,
        drop=("eigh_chunks",),
        enforced_by="constructor",
        message="solver='streaming' replaces the periodic refresh with a "
                "per-step fold — no recurring eigh spike remains for "
                "eigh_chunks > 1 to spread",
        refusal=("solver='streaming' replaces the periodic refresh with a "
                 "per-step fold — there is no recurring eigh spike left for "
                 "eigh_chunks > 1 to spread, and the chunk plan's double "
                 "buffer would shadow the streamed tables (planner rule "
                 "streaming_vs_chunks)"),
    ),
    Rule(
        name="streaming_vs_swap_slip",
        applies=lambda p: p.solver == "streaming",
        conflicts=lambda p, e: p.staleness_budget > 0,
        drop=("staleness_budget",),
        enforced_by="constructor",
        message="solver='streaming' has no pending eigen swap to slip — "
                "re-orthonormalizations land in place on drift boundaries, "
                "so a staleness_budget would silently mean nothing",
        refusal=("solver='streaming' has no pending eigen swap to slip — "
                 "re-orthonormalizations land in place on drift boundaries — "
                 "so a staleness_budget would silently mean nothing on the "
                 "eigen side (planner rule streaming_vs_swap_slip); leave "
                 "staleness_budget=0"),
    ),
    # Curvature-service exclusions (service/ — refresh runs on carved
    # workers, out of the training step). Environment conflicts shed the
    # service; the chunk conflict sheds the chunks instead (the in-step
    # spike eigh_chunks spreads no longer exists once the service owns the
    # refresh). BEFORE staleness_requires_slack: service counts as slack
    # there, so a plan that loses the service here must be re-judged.
    Rule(
        name="service_vs_inverse",
        applies=lambda p: p.service_devices > 0,
        conflicts=lambda p, e: e.precond_method == "inverse",
        drop=("service_devices",),
        enforced_by="constructor",
        message="service_devices > 0 publishes factor snapshots to workers "
                "that refresh an eigenbasis; precond_method='inverse' "
                "refreshes ~30x-cheaper Cholesky inverses in-step — no "
                "refresh spike worth a carve",
    ),
    Rule(
        name="service_vs_streaming",
        applies=lambda p: p.service_devices > 0,
        conflicts=lambda p, e: p.solver == "streaming",
        drop=("service_devices",),
        enforced_by="constructor",
        message="service_devices > 0 moves the periodic refresh to "
                "dedicated workers; solver='streaming' already replaced it "
                "with a per-step in-graph fold that cannot leave the "
                "training program — pick one refresh-elimination scheme",
    ),
    Rule(
        name="service_vs_chunks",
        applies=lambda p: p.service_devices > 0,
        conflicts=lambda p, e: p.eigh_chunks > 1,
        drop=("eigh_chunks",),
        enforced_by="constructor",
        message="service_devices > 0 removes the refresh from the training "
                "step entirely; eigh_chunks > 1 spreads an in-step refresh "
                "spike that no longer exists",
    ),
    Rule(
        name="service_vs_diag_blocks",
        applies=lambda p: p.service_devices > 0,
        conflicts=lambda p, e: e.diag_blocks > 1,
        drop=("service_devices",),
        enforced_by="constructor",
        message="service_devices > 0 runs the worker refresh on whole "
                "factors; diag_blocks > 1 needs the trainer-side conv "
                "layout the published snapshot does not carry",
    ),
    Rule(
        name="service_vs_owner_sharding",
        applies=lambda p: p.service_devices > 0,
        # owner sharding on a single-device mesh degrades to replicated
        # (owner_requires_devices) before the service check sees it
        conflicts=lambda p, e: p.factor_sharding == "owner"
        and e.factor_world > 1,
        drop=("service_devices",),
        enforced_by="constructor",
        message="service_devices > 0 publishes full replicated factor "
                "snapshots and installs full replicated bases; "
                "factor_sharding='owner' keeps per-owner shards that would "
                "have to gather through the mailbox every boundary",
    ),
    # Shard-lens / MoE exclusions (shardwise/). The model
    # facts are ENV, not levers, so two of these rows guard env-vs-env
    # compositions (inverse, diag_blocks): they apply to every plan and
    # drop nothing — fit_plan cannot repair a model/method mismatch, only
    # check_plan/the constructor can refuse it. The lever-engaging rows
    # shed their lever as usual. BEFORE staleness_requires_slack (which
    # must stay last): shedding deferral/service here orphans a budget.
    Rule(
        name="shard_lens_vs_inverse",
        applies=lambda p: True,
        conflicts=lambda p, e: (
            (e.has_shard_lens_layers or e.has_moe_layers)
            and e.precond_method == "inverse"
        ),
        drop=(),
        enforced_by="constructor",
        message="shard-lens/MoE layers precondition through per-shard "
                "eigenbases (shardwise.precondition); precond_method="
                "'inverse' keeps whole-factor Cholesky inverses that have "
                "no per-shard block layout",
        refusal=("{kind} precondition per shard block in the eigenbasis "
                 "(shardwise.precondition); precond_method='inverse' keeps "
                 "whole-factor Cholesky inverses with no per-block layout — "
                 "use the eigen method (planner rule shard_lens_vs_inverse)"),
    ),
    Rule(
        name="shard_lens_vs_diag_blocks",
        applies=lambda p: True,
        conflicts=lambda p, e: (
            (e.has_shard_lens_layers or e.has_moe_layers)
            and e.diag_blocks > 1
        ),
        drop=(),
        enforced_by="constructor",
        message="shard-lens/MoE factors already carry a stack (block) "
                "dimension per shard; diag_blocks > 1 would carve a second "
                "block structure into the same factors",
        refusal=("{kind} already block their factors along shard/expert "
                 "boundaries; diag_blocks > 1 would carve a second, "
                 "conflicting block structure into the same factors "
                 "(planner rule shard_lens_vs_diag_blocks)"),
    ),
    Rule(
        name="shard_lens_vs_owner_sharding",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.has_shard_lens_layers,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="shard-lens factors are already device-sharded along the "
                "tensor axis (shardwise.factor_leaf_spec); factor_sharding="
                "'owner' would re-shard them over the batch axes and force "
                "a gather on every solve",
        refusal=_OWNER_PIN + "shard_lens_vs_owner_sharding)",
    ),
    Rule(
        name="moe_vs_owner_sharding",
        applies=lambda p: p.factor_sharding == "owner",
        conflicts=lambda p, e: e.has_moe_layers,
        drop=("factor_sharding",),
        enforced_by="constructor",
        message="MoE expert banks keep per-expert [E, n, n] factor stacks "
                "whose token-count-weighted EMA runs where the dispatch "
                "statistics live; factor_sharding='owner' has no slot "
                "layout for expert stacks",
        refusal=_OWNER_PIN + "moe_vs_owner_sharding)",
    ),
    Rule(
        name="shard_lens_vs_chunks",
        applies=lambda p: p.eigh_chunks > 1,
        conflicts=lambda p, e: e.has_shard_lens_layers or e.has_moe_layers,
        drop=("eigh_chunks",),
        enforced_by="constructor",
        message="eigh_chunks > 1 pipelines the refresh through the "
                "whole-factor slot planner; shard-lens/MoE stacks refresh "
                "as batched per-block eigh outside that plan",
        refusal=("{kind} refresh densely per block — there is no "
                 "whole-factor eigh spike for eigh_chunks > 1 to spread, and "
                 "the chunk planner's slot tables do not describe stacked "
                 "factors (planner rule shard_lens_vs_chunks)"),
    ),
    Rule(
        name="shard_lens_vs_streaming",
        applies=lambda p: p.solver == "streaming",
        conflicts=lambda p, e: e.has_shard_lens_layers or e.has_moe_layers,
        drop=("solver",),
        enforced_by="constructor",
        message="solver='streaming' folds factors through retained "
                "whole-factor bases; shard-lens/MoE stacks have no "
                "streaming fold",
        refusal=("{kind} keep dense per-block bases; solver='streaming' "
                 "folds factors through retained truncated bases that the "
                 "stacked layout does not carry — non-shard layers may ride "
                 "solver='rsvd' instead (planner rule shard_lens_vs_streaming)"),
    ),
    Rule(
        name="moe_vs_deferred_comm",
        applies=lambda p: p.factor_comm_freq > 1,
        conflicts=lambda p, e: e.has_moe_layers,
        drop=("factor_comm_freq",),
        enforced_by="constructor",
        message="factor_comm_freq > 1 merges deferred factor EMAs by "
                "linearity; the MoE token-count-weighted per-expert decay "
                "(alpha**(f_e*E)) is not linear in the deferred statistics",
        refusal=("MoE expert banks use the token-count-weighted EMA "
                 "(shardwise.moe_ema), whose per-expert decay alpha**w_e is "
                 "not linear in the contributions — deferred factor "
                 "communication (factor_comm_freq > 1) merges per-replica "
                 "EMAs by linearity and would silently corrupt expert "
                 "statistics (planner rule moe_vs_deferred_comm)"),
    ),
    Rule(
        name="service_vs_shard_lens",
        applies=lambda p: p.service_devices > 0,
        conflicts=lambda p, e: e.has_shard_lens_layers or e.has_moe_layers,
        drop=("service_devices",),
        enforced_by="constructor",
        message="service_devices > 0 publishes replicated whole-factor "
                "snapshots to refresh workers; shard-lens/MoE factor "
                "stacks live device-sharded and never leave the mesh",
        refusal=("{kind} refresh in-step (cheap dense per-block eigh); "
                 "service_devices > 0 publishes whole-factor snapshots the "
                 "worker protocol does not lay out as stacks — run the "
                 "service on unsharded models (planner rule "
                 "service_vs_shard_lens)"),
    ),
    # Int8 wire exclusions (parallel/comm.py block-scaled quantization).
    # AFTER moe_vs_deferred_comm and the comm single-device/multi-axis
    # rules: any rule above that strips factor_comm_freq (or the whole
    # comm pair) must run first so a freshly-orphaned int8 dtype is
    # cleared here rather than surviving into a refused plan. BEFORE
    # staleness_requires_slack, which must stay last.
    Rule(
        name="int8_wire_requires_deferral",
        applies=lambda p: p.factor_comm_dtype == "int8",
        conflicts=lambda p, e: p.factor_comm_freq <= 1,
        drop=("factor_comm_dtype",),
        enforced_by="constructor",
        message="factor_comm_dtype='int8' quantizes the deferred factor "
                "flush with error-feedback residuals carried in "
                "state['wire_error']; factor_comm_freq=1 exchanges "
                "contributions every capture step with no residual slot — "
                "the rounding bias would accumulate unrecoverably in the "
                "EMA",
        refusal=("factor_comm_dtype='int8' quantizes the deferred factor "
                 "flush with error-feedback accumulators carried in state; "
                 "factor_comm_freq=1 exchanges contributions every capture "
                 "step with no residual slot to carry — set factor_comm_freq "
                 "> 1 or widen the wire to bf16 (planner rule "
                 "int8_wire_requires_deferral)"),
    ),
    Rule(
        name="int8_wire_vs_owner_sharding",
        applies=lambda p: p.factor_comm_dtype == "int8",
        conflicts=lambda p, e: p.factor_sharding == "owner",
        drop=("factor_comm_dtype",),
        enforced_by="constructor",
        message="factor_comm_dtype='int8' exchanges codes + block scales "
                "over all_gather on the replicated deferred flush; "
                "factor_sharding='owner' merges through psum_scatter, "
                "which would widen the int8 codes on-wire — use the bf16 "
                "wire with owner sharding",
        refusal=("factor_comm_dtype='int8' rides the replicated deferred "
                 "flush (codes + block scales over all_gather); "
                 "factor_sharding='owner' exchanges through psum_scatter, "
                 "which would have to widen the codes on-wire — use the bf16 "
                 "wire with owner sharding (planner rule "
                 "int8_wire_vs_owner_sharding)"),
    ),
    # The JAX package's degrade row (it warns and runs the dense apply);
    # the port refuses, since its "kernel" means the hand kernel or an
    # error. "auto" under the inverse method still degrades to dense with
    # the JAX package's warning (preconditioner.py).
    Rule(
        name="apply_pallas_vs_inverse",
        applies=lambda p: p.apply_kernel == "kernel",
        conflicts=lambda p, e: e.precond_method == "inverse",
        drop=("apply_kernel",),
        enforced_by="constructor",
        message="apply_kernel='kernel' fuses the eigenbasis rotate/scale/"
                "back-rotate apply; precond_method='inverse' preconditions "
                "through Cholesky inverse matmuls with no eigenbasis to "
                "fuse",
        refusal=("apply_kernel='kernel' launches the fused eigenbasis apply; "
                 "precond_method='inverse' preconditions with explicit "
                 "Cholesky inverses, which that kernel does not compute — use "
                 "apply_kernel='auto' or 'dense'"),
    ),
    # Last on purpose: its conflict is plan-internal, so it must see the
    # plan AFTER every rule above has cleared levers — a fitted plan that
    # lost its deferral/chunking/service slack must lose the budget too,
    # or the constructor would refuse the fit_plan output.
    Rule(
        name="staleness_requires_slack",
        applies=lambda p: p.staleness_budget > 0,
        conflicts=lambda p, e: not (
            p.factor_comm_freq > 1 or p.eigh_chunks > 1
            or p.service_devices > 0
        ),
        drop=("staleness_budget",),
        enforced_by="constructor",
        message="staleness_budget > 0 bounds how far a deferred factor "
                "flush, a pending eigen swap, or a service basis install "
                "may slip, and this configuration has none of them: enable "
                "factor_comm_freq > 1 (deferred flushes), eigh_chunks > 1 "
                "(pending swaps), or service_devices > 0 (curvature "
                "service)",
        refusal=("staleness_budget > 0 bounds how far a deferred factor "
                 "flush, a pending eigen swap, or a service basis install may "
                 "slip, and this configuration has none of them: enable "
                 "factor_comm_freq > 1 (deferred reduction), eigh_chunks > 1 "
                 "(pipelined refresh), or service_devices > 0 (curvature "
                 "service), or leave staleness_budget=0"),
    ),
)

# Rules whose real enforcement raises (vs warns): the set the pairwise
# matrix test checks against actual KFAC construction / init behavior.
REFUSAL_RULES = tuple(r for r in RULES if r.enforced_by != "degrade")


def violations(plan: Plan, env: PlanEnv,
               include_degrades: bool = False) -> List[Rule]:
    """Rules this (plan, env) pair trips, in matrix order."""
    rules = RULES if include_degrades else REFUSAL_RULES
    return [r for r in rules if r.applies(plan) and r.conflicts(plan, env)]


def constructor_refusals(plan: Plan, env: PlanEnv) -> List[Rule]:
    """The rules ``KFAC`` raises for this (plan, env) pair, in matrix
    order: the constructor's refusals are exactly these."""
    return [r for r in RULES if r.enforced_by == "constructor"
            and r.applies(plan) and r.conflicts(plan, env)]


def check_plan(plan: Plan, env: PlanEnv) -> None:
    """Raise ``ValueError`` listing every refusal this plan would hit."""
    bad = violations(plan, env)
    if bad:
        lines = "; ".join(f"[{r.name}] {r.message}" for r in bad)
        raise ValueError(f"invalid lever composition: {lines}")


def fit_plan(plan: Plan, env: PlanEnv) -> Tuple[Plan, Tuple[str, ...]]:
    """Clear every lever the environment refuses (or would silently
    ignore); returns the valid plan plus the names of the rules applied.

    Deterministic: rules apply in matrix order, and clearing a lever means
    resetting its field(s) to the ``Plan()`` defaults — so the result is a
    pure function of (plan, env) and every host derives the same one.
    """
    default = Plan()
    dropped: List[str] = []
    current = plan
    for rule in RULES:
        if rule.applies(current) and rule.conflicts(current, env):
            current = dataclasses.replace(
                current, **{f: getattr(default, f) for f in rule.drop}
            )
            dropped.append(rule.name)
    return current, tuple(dropped)


# ---------------------------------------------------------------------------
# Named profiles
# ---------------------------------------------------------------------------

#: The strings ``KFAC(profile=...)`` accepts. Values are intents — which
#: levers the profile WANTS engaged; ``cost_model.resolve_profile`` turns
#: an intent into a concrete :class:`Plan` using the layer shapes and the
#: environment, then :func:`fit_plan` drops whatever the environment
#: refuses.
PROFILES: Dict[str, str] = {
    "safe": "all levers at bitwise-inert defaults (reference parity)",
    "memory": "minimize per-device curvature memory: owner-sharded state, "
              "truncated solver, compressed wire; no refresh pipelining "
              "(the double buffer costs memory)",
    "production": "minimize amortized step overhead: every lever the cost "
                  "model judges profitable for this model and mesh",
}


def profile_names() -> Tuple[str, ...]:
    return tuple(PROFILES)
