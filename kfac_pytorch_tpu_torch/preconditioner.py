"""KFAC: the K-FAC gradient preconditioner, on one device or data-parallel.

Port of ``kfac_pytorch_tpu/preconditioner.py::KFAC`` for the ported
paths: identity-initialized factor running averages, a curvature refresh
every ``kfac_update_freq`` steps, and preconditioning of every K-FAC
layer's gradient with the global KL clip, every step. The refresh is an
eigendecomposition of every factor (``precond_method="eigen"``; conv
factors in ``diag_blocks`` diagonal blocks once ``diag_warmup`` epochs have
passed) or π-damped Cholesky inverses (``precond_method="inverse"``).
``track_diagnostics`` keeps the health diagnostics of
``observability/diagnostics.py`` in the state. ``eigen_dtype`` is the
storage type of the eigenvectors (or of the inverse method's matrix
inverses): ``torch.bfloat16`` halves the every-step apply's largest input
stream, while eigh runs in float32 and the eigenvalues, factors and every
other state entry stay float32, as in the JAX package.
``precond_precision`` sets the matmul precision of the dense rotations
(``device.rotation_precision``: ``"default"`` is one TF32 pass on the card,
``"high"``/``"highest"``/``None`` IEEE float32); the fused apply kernel
ignores it, as the JAX package's fused branch does.
Embeddings (``KFACEmbed``) keep a diagonal A factor, ``A_diag [vocab]``,
initialized to ones, whose "eigendecomposition" is the floored diagonal
itself. The interface keeps the reference's functional shape:

    kfac = KFAC(...)
    state = kfac.init(model)
    new_grads, state = kfac.update(
        grads, state, a_contribs=..., g_factor_stats=...,
        lr=lr, damping=damping, update_factors=..., update_eigen=...)

``grads`` maps parameter names to gradients
(``{n: p.grad for n, p in model.named_parameters()}``); the returned dict
has every K-FAC layer's entries replaced and BatchNorm's passed through.
Statistics come from ``capture.Capture``. The state is a dict of tensors on
the preconditioner's device.

Data-parallel (the reference's algorithm, one process per GPU): the world
is ``process_group=`` or, when ``torch.distributed`` is initialised, the
default group (the JAX package's ``mesh=``). The ranks' A/G statistics
cross the wire through the factor comm plane (``parallel.comm.FactorComm``,
inert on a world of one): by default each capture step averages the
ranks' contributions before the EMA, in a few flat float32 buckets, so
every rank keeps the global batch's factors; ``factor_comm_dtype="bf16"``
halves the wire; ``factor_comm_freq=N`` defers the exchange, each rank
keeping the running averages of its own statistics and
``update(flush_factors=True)`` merging them every N capture steps and
before every eigen read (``"int8"``, on the deferred flush only, with the
error-feedback residuals in ``state["wire_error"]``). Over more than one
rank the refresh is sharded (``parallel.sharded_eigh.sharded_eigen_update``: each
rank decomposes the factors the round-robin table gives it, A and G of a
layer on different ranks with ``distribute_layer_factors``, by default
when there are more ranks than layers), and with ``distribute_precondition``
so is the every-step apply (``ops.precondition.precondition_all_distributed``,
its exchange in ``precond_comm_dtype`` when set).

The refresh can be pipelined (``eigh_chunks > 1``: the refresh plan's
chunks run on the steps after each boundary into ``state["eigen_pending"]``,
swapped in when all have landed, a swap that may slip by
``staleness_budget`` steps; ``scheduler.EigenRefreshCadence`` gives the
flags) or truncated (``solver="rsvd"``: factor sides from
``solver_auto_threshold`` keep ``solver_rank`` eigenpairs of the
randomized solve of ``ops/rsvd.py`` plus a residual mass ``rho``, and
precondition through the Woodbury solves of ``ops/precondition.py``;
``"streaming"`` folds each capture step's factors through the kept bases,
``ops/streaming.py``, and re-orthonormalizes when the drift gauge trips).
Over the ranks the chunks and the truncated solves are sharded as the
refresh is.

Owner-sharded factor state (``factor_sharding="owner"``, DP-KFAC, arxiv
2206.15143): each layer's factors and eigenbases live only on the rank
that preconditions it (``parallel.assignment.plan_factor_shards``), in the
``state["factor_shard"]``/``state["eigen_shard"]`` stacks of this rank's
rows; ``state["factors"]`` keeps scalar placeholders, the layer registry.
Every capture step reduce-scatters the ranks' ``(1−α)·contrib`` onto the
owners (``FactorComm.scatter_merge``; deferred, the full-size per-rank
``state["factor_local"]`` accumulates and the flush scatters it with decay
``α^m``), the refresh is owner-local with no collective
(``parallel.sharded_eigh.owner_eigen_update``), and the apply solves each
layer on its owner and replicates the results with one ``all_gather``
(``ops.precondition.precondition_all_owner``). Per-rank curvature memory and
the factor wire both become O(model / ranks). On a world of one rank the
mode warns and runs replicated, as in the JAX package.

The overlap plane (``comm_overlap=True``): the train steps start a capture
step's factor bucket means, reversed and asynchronous, before the gradient
mean and hand ``update(exchanged=True)`` the result; on a chunk-only step
the precondition runs before the chunk, and the chunk's decomposition runs
on a side CUDA stream, joined at the next ``update``. Values are bitwise
those of the serial order. Inert on a world of one.

Shard-lens layers (``KFACShardedDense``'s ``path#cT``/``path#rT`` and
``KFACMoE``'s ``path#eE``, ``shardwise/``) keep stacked factors and
form-prefixed eigen entries: their EMA is elementwise (the MoE bank's
token-count-weighted, ``shardwise.moe_ema``), their refresh a dense batched
eigh on every rank, outside the round-robin and truncated-solver tables,
and their solve a batched product chain outside kernel 3's shape groups,
its KL-clip partials after the fused kernel's. The levers that reshape a
refresh or re-home factors refuse them, with the JAX package's messages
(the shard-lens rows of ``planner.RULES``).

On a data×fsdp×tensor world (``parallel.mesh.data_fsdp_tensor_world``;
``process_group`` its data×fsdp subgroup, ``tensor_group`` its tensor
subgroup) the column and row layers are split (``KFACShardedDense.split_``)
and each rank keeps, refreshes and solves only the factor blocks of its
own kernel shard: a column layer's ``G``/``cQG``/``cdG`` and a row layer's
``A``/``rQA``/``rdA`` stack ``[T/T_axis, ·, ·]`` (:meth:`KFAC.state_placements`,
the JAX ``state_shardings``), beside the shared side whole. The factor
plane (the buckets, the deferred flush, the int8 wire, the sharded refresh
of the other layers, the owner plan) rides the data×fsdp group, so a
column G block is averaged among the ranks of its own tensor slot only
and the tensor group sees no factor collective. The one tensor-group sum
the preconditioner issues is the KL clip's: ``Σ v·g`` over the local
blocks of the split layers, added once to the replicated layers' sum
(which every tensor slot holds whole and must not count ``T`` times), and,
with ``track_diagnostics``, the norms and spectra of the same blocks.

The curvature service (``service_devices > 0``, ``service/``) takes the
refresh out of the training step: ``update`` refuses every refresh flag,
and a ``service.CurvatureService`` publishes factor snapshots to its
worker and installs the bases it publishes back between steps.

The constructor takes every argument of the reference with its default and
validation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from kfac_pytorch_tpu_torch import capture, shardwise
from kfac_pytorch_tpu_torch.device import (
    DeviceLike,
    resolve_device,
    resolve_precond_precision,
    use_ieee_f32,
)
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACEmbed
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import apply_kernels as apply_kernel_ops
from kfac_pytorch_tpu_torch.ops import factor_kernels as factor_kernel_ops
from kfac_pytorch_tpu_torch.ops import factors as factor_ops
from kfac_pytorch_tpu_torch.ops import precondition as precond_ops
from kfac_pytorch_tpu_torch.ops import streaming as streaming_ops
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.assignment import (
    layer_assignment,
    plan_eigh_chunks,
    plan_factor_shards,
    plan_owner_chunks,
    precondition_assignment,
    shard_plan_bytes,
)
from kfac_pytorch_tpu_torch.parallel.comm import FactorComm, resolve_factor_comm_dtype, tree_leaves
from kfac_pytorch_tpu_torch.parallel.mesh import WIRE_DTYPES, World, data_parallel_world
from kfac_pytorch_tpu_torch.planner.profiles import Plan, PlanEnv, constructor_refusals
from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
    build_slots,
    owner_eigen_chunk_update,
    owner_eigen_entry_init,
    owner_eigen_update,
    owner_spectrum_mass,
    owner_stream_fold,
    replicated_eigen_chunk_update,
    replicated_eigen_update,
    sharded_eigen_chunk_update,
    sharded_eigen_update,
)

KFACState = Dict[str, Any]

# storage types of the eigenvectors / matrix inverses the port carries: the
# fused apply kernel reads float32 or bfloat16 Q
EIGEN_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class KFACHParams:
    """Host-side mutable hyperparameters (``KFACParamScheduler`` mutates them)."""

    damping: float = 0.001
    kl_clip: float = 0.001
    fac_update_freq: int = 10
    kfac_update_freq: int = 100


def _side_spectrum(e: Dict[str, torch.Tensor], side: str) -> torch.Tensor:
    """One side's eigenvalues for the diagnostics: a truncated side's ``d``
    with its residual mass ``rho`` appended (the eigenvalue of every
    complement direction), so its min/max and condition number stay
    meaningful."""
    d = e[f"d{side}"]
    rho = e.get(f"rho{side}")
    if rho is None:
        return d
    return torch.cat([d, rho.reshape(1).to(d.dtype)])


def _validate(name: str, ok: bool, value) -> None:
    if not ok:
        raise ValueError(f"Invalid {name}: {value}")


# the planner's names of the factor wire dtypes
_WIRE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def lever_env(processes: int, data_world: int, seq_parallel: int = 1,
              tensor_axis: bool = False, **kw) -> PlanEnv:
    """The :class:`PlanEnv` of K-FAC planes that span ``data_world`` of
    ``processes`` ranks. Its axis names stand for the JAX mesh's: none on
    one process, ``("data", "seq")`` with a seq axis, ``("data", "fsdp",
    "tensor")`` with the genuine tensor axis of a data×fsdp×tensor world,
    ``("data", "tensor")`` when the planes span a data subgroup (the
    replicated-compute data×tensor world), else ``("data",)``.
    ``data_world`` excludes the tensor axis, as the JAX rule excludes
    ``tensor*`` axes. ``KFAC`` builds its env here from its world, and the
    LM twin's command-line check from its flags."""
    if processes <= 1:
        return PlanEnv(**kw)
    if seq_parallel > 1:
        axes = ("data", "seq")
    elif tensor_axis:
        axes = ("data", "fsdp", "tensor")
    elif processes > data_world:
        axes = ("data", "tensor")
    else:
        axes = ("data",)
    return PlanEnv(world=processes, data_world=data_world, mesh_axes=axes, **kw)


class KFAC:
    """K-FAC gradient preconditioner (eigen or inverse method).

    Args mirror the reference (kfac_pytorch_tpu/preconditioner.py:142-179)
    plus ``device`` (default CUDA; raises without a GPU unless
    ``device="cpu"``), ``process_group`` (the world, in place of the JAX
    package's ``mesh``, which the port refuses) and ``seq_parallel`` (the
    seq axis of a data×seq world, ``parallel.mesh.data_seq_world``: the
    refresh still shards over all its ranks, as the JAX package's does
    over a data×seq mesh, and the levers that ride one data axis are
    refused). Every lever-composition refusal is a constructor row of the
    planner's table (``planner.RULES``, :meth:`_refuse`); ``profile=`` and
    ``profile_shapes=`` resolve a planner profile or ``Plan`` into the
    levers left at their defaults. ``lr`` is validated for
    API parity only: the KL clip always uses the per-step
    ``update(lr=...)``.
    """

    def __init__(
        self,
        lr: float = 0.1,
        factor_decay: float = 0.95,
        damping: float = 0.001,
        kl_clip: float = 0.001,
        fac_update_freq: int = 10,
        kfac_update_freq: int = 100,
        batch_averaged: bool = True,
        diag_blocks: int = 1,
        diag_warmup: int = 0,
        distribute_layer_factors: Optional[bool] = None,
        distribute_precondition: bool = False,
        precond_comm_dtype: Optional[Any] = None,
        mesh: Optional[Any] = None,
        axis_name: str = "data",
        eps: float = 1e-10,
        layers: Optional[list] = None,
        precond_precision: Optional[Any] = None,
        eigen_dtype: Any = torch.float32,
        precond_method: str = "eigen",
        track_diagnostics: bool = False,
        eigh_chunks: int = 1,
        factor_kernel: str = "auto",
        apply_kernel: str = "auto",
        factor_comm_dtype: Any = "f32",
        factor_comm_freq: int = 1,
        solver: str = "eigh",
        solver_rank: int = 128,
        solver_auto_threshold: int = 512,
        factor_sharding: str = "replicated",
        comm_overlap: bool = False,
        staleness_budget: int = 0,
        stream_drift_threshold: float = 0.05,
        service_devices: int = 0,
        profile: Optional[Any] = None,
        profile_shapes: Optional[Any] = None,
        device: DeviceLike = None,
        process_group: Optional[Any] = None,
        seq_parallel: int = 1,
        tensor_group: Optional[Any] = None,
    ):
        _validate("learning rate", 0.0 <= lr, lr)
        _validate("factor decay rate", 0.0 < factor_decay <= 1, factor_decay)
        _validate("damping", 0.0 < damping, damping)
        _validate("clipping value", 0.0 < kl_clip, kl_clip)
        _validate("factor update frequency", 0 < fac_update_freq, fac_update_freq)
        _validate("K-FAC update frequency", 0 < kfac_update_freq, kfac_update_freq)
        _validate("diagonal block approx count", 0 < diag_blocks, diag_blocks)
        _validate("precond_method", precond_method in ("eigen", "inverse"), precond_method)
        _validate("eigh chunk count", 0 < eigh_chunks, eigh_chunks)
        _validate("solver", solver in ("eigh", "rsvd", "streaming"), solver)
        _validate(
            "factor_sharding", factor_sharding in ("replicated", "owner"), factor_sharding
        )
        if kfac_update_freq % fac_update_freq != 0:
            print(
                "WARNING: kfac_update_freq does not divide evenly by "
                "fac_update_freq; eigendecompositions will sometimes run on "
                "stale factors"
            )

        if mesh is not None:
            raise ValueError(
                "mesh= is the JAX package's device mesh; the port's world is "
                "a torch.distributed process group: pass process_group= (or "
                "initialise torch.distributed for the default group)"
            )
        if precond_comm_dtype is not None and not distribute_precondition:
            raise ValueError(
                "precond_comm_dtype compresses the distributed-precondition "
                "exchange and does nothing without distribute_precondition="
                "True — refusing a config whose numerics would silently "
                "change when run at scale"
            )
        _validate(
            "precond_comm_dtype",
            precond_comm_dtype is None or precond_comm_dtype in WIRE_DTYPES,
            precond_comm_dtype,
        )
        if precond_method == "inverse" and diag_blocks != 1:
            raise ValueError(
                "diag_blocks > 1 (and its diag_warmup schedule) is a feature "
                "of the eigenbasis path; precond_method='inverse' inverts "
                "whole factors and would silently ignore the configured "
                "block-diagonal approximation"
            )
        world = data_parallel_world(process_group)
        if tensor_group is not None and dist.get_world_size(tensor_group) > 1:
            # the genuine tensor axis of a data×fsdp×tensor world
            world = dataclasses.replace(
                world, tensor_size=dist.get_world_size(tensor_group),
                tensor_rank=dist.get_rank(tensor_group), tensor_group=tensor_group)
        self._tensor_size = world.tensor_size
        _validate(
            "seq_parallel",
            isinstance(seq_parallel, int) and 0 < seq_parallel and world.size % seq_parallel == 0,
            seq_parallel,
        )
        self.seq_parallel = seq_parallel
        self.precond_method = precond_method
        # the shard-lens registry: an explicit layer list names them here,
        # else init() discovers them and refuses through the same table
        self._register_shard_layers(layers or [])
        # planner/ entry point: profile=None is inert (the cost model is not
        # consulted and every lever keeps the value the caller passed). A
        # profile name ("production"/"memory"/"safe") or a planner.Plan
        # resolves against this constructor's world and fills in ONLY the
        # levers the caller left at their defaults: an explicit lever always
        # wins over the plan (docs/PLANNER.md).
        self.plan = None
        self.plan_dropped: Tuple[str, ...] = ()
        self.plan_report = None
        self.plan_env = None
        levers = {
            "eigh_chunks": eigh_chunks, "factor_kernel": factor_kernel,
            "apply_kernel": apply_kernel,
            "factor_comm_dtype": _WIRE_NAMES[resolve_factor_comm_dtype(factor_comm_dtype)],
            "factor_comm_freq": factor_comm_freq, "solver": solver,
            "solver_rank": solver_rank, "solver_auto_threshold": solver_auto_threshold,
            "factor_sharding": factor_sharding, "comm_overlap": comm_overlap,
            "staleness_budget": staleness_budget,
            "stream_drift_threshold": stream_drift_threshold,
            "service_devices": service_devices,
        }
        self._lever_env = lever_env(
            launch.size() if world.distributed else 1, world.size, seq_parallel,
            world.tensor_size > 1, precond_method=precond_method, diag_blocks=diag_blocks,
            distribute_precondition=distribute_precondition,
            track_diagnostics=track_diagnostics, fac_update_freq=fac_update_freq,
            kfac_update_freq=kfac_update_freq, service_devices=int(service_devices),
            has_shard_lens_layers=self.has_shard_lens, has_moe_layers=self.has_moe,
        )
        if profile is not None:
            levers = self._resolve_profile(profile, profile_shapes, levers, device, layers)
        eigh_chunks = levers["eigh_chunks"]
        factor_kernel = levers["factor_kernel"]
        apply_kernel = levers["apply_kernel"]
        factor_comm_freq = levers["factor_comm_freq"]
        solver = levers["solver"]
        solver_rank = levers["solver_rank"]
        solver_auto_threshold = levers["solver_auto_threshold"]
        factor_sharding = levers["factor_sharding"]
        comm_overlap = levers["comm_overlap"]
        staleness_budget = levers["staleness_budget"]
        stream_drift_threshold = levers["stream_drift_threshold"]
        service_devices = levers["service_devices"]
        factor_comm_dtype = resolve_factor_comm_dtype(levers["factor_comm_dtype"])
        _validate(
            "factor_comm_freq",
            isinstance(factor_comm_freq, int) and 0 < factor_comm_freq,
            factor_comm_freq,
        )
        _validate("comm_overlap", isinstance(comm_overlap, bool), comm_overlap)
        _validate("solver_rank", isinstance(solver_rank, int) and 0 < solver_rank, solver_rank)
        _validate(
            "solver_auto_threshold",
            isinstance(solver_auto_threshold, int) and 0 < solver_auto_threshold,
            solver_auto_threshold,
        )
        _validate(
            "stream_drift_threshold",
            isinstance(stream_drift_threshold, (int, float))
            and 0.0 <= float(stream_drift_threshold),
            stream_drift_threshold,
        )
        _validate(
            "staleness_budget",
            isinstance(staleness_budget, int) and staleness_budget >= 0,
            staleness_budget,
        )
        _validate(
            "service_devices",
            isinstance(service_devices, int) and service_devices >= 0,
            service_devices,
        )
        _validate("eigen_dtype", eigen_dtype in EIGEN_DTYPES, eigen_dtype)
        # The lever-composition refusals: exactly the constructor rows of the
        # planner's table (planner/profiles.py RULES), each with the JAX
        # constructor's message; the caller's levers, before a world of one
        # degrades them
        self._lever_plan = Plan(**levers)
        self._refuse()
        if diag_blocks != 1:
            print(
                "WARNING: the block-diagonal factor approximation "
                "(diag_blocks > 1) trades accuracy for parallelism — expect "
                "degraded convergence on some models"
            )
        # Where the factor running averages and eigenbases live: on every
        # rank ("replicated") or only on each layer's precondition owner
        # ("owner", DP-KFAC); a world of one runs the replicated layout
        self.requested_factor_sharding = factor_sharding
        if factor_sharding == "owner" and world.size <= 1:
            # trainers pass the same flags to one-rank runs: nothing to
            # shard across, so the (same-numerics) replicated layout
            print(
                "WARNING: factor_sharding='owner' has no effect without "
                "a multi-device mesh — factor state stays replicated"
            )
            factor_sharding = "replicated"
        self.factor_sharding = factor_sharding
        self._shard_plans: Dict[Any, Any] = {}
        # planned bytes of the owner layout (shard_plan_bytes) and the
        # apply's gather width, set when a plan is built (the
        # kfac/factor_shard_* gauges) and at each owner apply
        # (kfac/precond_allgather_bytes)
        self.shard_plan_info: Optional[Dict[str, Any]] = None
        self.precond_gather_width: Optional[int] = None
        # Overlap plane: the capture step's factor bucket means issued
        # before the gradient mean, in reverse bucket order and
        # asynchronously (bitwise the serial values), and on chunk-only
        # steps the precondition ahead of the chunk, whose decomposition
        # runs on a side CUDA stream
        if comm_overlap and world.size <= 1:
            print(
                "WARNING: comm_overlap=True has no effect without a "
                "multi-device mesh — there is no factor exchange to overlap"
            )
            comm_overlap = False
        self.comm_overlap = bool(comm_overlap)
        self.device = resolve_device(device)
        use_ieee_f32()
        self.world: World = world
        self.distribute_layer_factors = distribute_layer_factors
        # shard the every-step rotations over the ranks (off by default, as
        # in the JAX package: the exchange can cost more than the rotations
        # it saves on few devices)
        self.distribute_precondition = distribute_precondition
        self.precond_comm_dtype = precond_comm_dtype
        if distribute_precondition and self.world.size <= 1:
            # update() takes the replicated apply then; trainers pass the
            # same flags to one-device runs, so this is not an error
            print(
                "WARNING: distribute_precondition=True has no effect without "
                "a multi-device mesh — preconditioning runs replicated"
                + (" and precond_comm_dtype is unused" if precond_comm_dtype is not None else "")
            )
        self.factor_comm = FactorComm(
            self.world, factor_comm_dtype, factor_comm_freq,
            sharded=self.owner_sharded, overlap=self.comm_overlap,
        )
        # the overlap plane's side stream for chunk decompositions and the
        # event the next update() joins (CUDA only)
        self._side_stream = None
        self._side_done = None
        if (
            factor_comm_freq > 1 or factor_comm_dtype != torch.float32
        ) and not self.factor_comm.multi_device:
            # trainers pass the same flags to one-device runs
            print(
                "WARNING: factor_comm_dtype/factor_comm_freq shape the "
                "cross-replica factor exchange and have no effect on a world "
                "of one rank — factor statistics stay local and exact"
            )
        self.eigen_dtype = eigen_dtype
        self.precond_precision = resolve_precond_precision(precond_precision)
        self.factor_decay = factor_decay
        self.batch_averaged = batch_averaged
        self.diag_blocks = diag_blocks
        self.diag_warmup = diag_warmup
        self.precond_method = precond_method
        # the inverse method keeps no eigenvalues: its diagnostics carry
        # the spectrum entries forward and refresh only the every-step ones
        self.track_diagnostics = track_diagnostics
        self.eps = eps
        self.layers = list(layers) if layers is not None else None
        # "auto": the CUDA kernels for CUDA tensors, their plain versions for
        # CPU tensors; "kernel": the CUDA kernels or an error; "dense": the
        # oracle paths (im2col factors, einsum-chain apply, per-leaf SGD).
        self.factor_kernel = factor_kernel_ops.resolve_factor_kernel(
            factor_kernel, self.device
        )
        # the inverse method's 2-matmul apply has no eigenbasis stage for
        # the fused kernel (kernel 3) to cover, so "auto" takes the dense
        # apply (and the per-leaf SGD), as the JAX package degrades its
        # Pallas apply; "kernel" was refused above
        self.apply_kernel = apply_kernel_ops.resolve_apply_kernel(
            apply_kernel, self.device
        )
        if precond_method == "inverse" and self.apply_kernel == "auto":
            print(
                "WARNING: apply_kernel='auto' fuses the eigenbasis apply; "
                "precond_method='inverse' preconditions with explicit "
                "Cholesky inverses — falling back to the dense apply path"
            )
            self.apply_kernel = "dense"
        self.eigh_chunks = int(eigh_chunks)
        self.solver = solver
        self.solver_rank = int(solver_rank)
        self.solver_auto_threshold = int(solver_auto_threshold)
        self.stream_drift_threshold = float(stream_drift_threshold)
        self.staleness_budget = int(staleness_budget)
        # Curvature service (service/): N workers refresh the bases out of
        # band from published factor snapshots and update() runs no refresh
        self.service_devices = int(service_devices)
        # Host-side signals of the cadence, zero-argument callables: the
        # streaming drift gauge (trainers point it at
        # state["stream_residual"]; None re-orthonormalizes at every
        # boundary) and the comm/compute pressure of the staleness slip
        # (None never slips).
        self.stream_drift_signal = None
        self.staleness_signal = None
        self.hparams = KFACHParams(
            damping=damping,
            kl_clip=kl_clip,
            fac_update_freq=fac_update_freq,
            kfac_update_freq=kfac_update_freq,
        )

    def _register_shard_layers(self, names) -> None:
        """Register ``names``' shard-lens layers (:attr:`shard_layers`,
        :attr:`has_shard_lens`, :attr:`has_moe`)."""
        names = list(names)
        self.shard_layers = shardwise.shard_entries(names)
        # the column/row layers whose blocks a genuine tensor axis splits
        tp = self._tensor_size
        self.split_layers = {
            n: count // tp for n, (_, form, count) in self.shard_layers.items()
            if tp > 1 and form in ("c", "r")
        }
        for n, local in self.split_layers.items():
            if local * tp != self.shard_layers[n][2]:
                raise ValueError(
                    f"shard-lens layer {n!r}: {self.shard_layers[n][2]} blocks do not "
                    f"split over a {tp}-slot tensor axis")
        self.has_shard_lens = shardwise.has_shard_lens(names)
        self.has_moe = shardwise.has_moe(names)

    def _refuse(self) -> None:
        """Raise the first constructor refusal of the planner's table
        (``planner.constructor_refusals``) that the caller's levers meet
        in this preconditioner's environment, with its message."""
        bad = constructor_refusals(self._lever_plan, self._lever_env)
        if bad:
            raise ValueError(bad[0].refusal_text(self._lever_plan, self._lever_env))

    def _resolve_profile(self, profile, profile_shapes, levers: Dict[str, Any],
                         device: DeviceLike, layers: Optional[list]) -> Dict[str, Any]:
        """``levers`` with the ones at their defaults filled from
        ``profile`` (a name or a ``planner.Plan``), resolved against this
        preconditioner's world and ``profile_shapes`` (a
        ``planner.ModelFacts``, a ``{layer: (g_side, a_side)}`` dict or the
        live ``nn.Module``, its K-FAC layers ``layers``); sets :attr:`plan`, :attr:`plan_dropped`,
        :attr:`plan_report` and :attr:`plan_env` and publishes the plan's
        gauges (``planner.log_plan``)."""
        from kfac_pytorch_tpu_torch import planner

        facts = profile_shapes
        if isinstance(facts, nn.Module):
            facts = planner.model_facts(facts, layers=layers)
        elif facts is not None and not isinstance(facts, planner.ModelFacts):
            facts = planner.ModelFacts(
                shapes={k: (int(g), int(a)) for k, (g, a) in dict(facts).items()})
        env = dataclasses.replace(
            self._lever_env,
            has_diag_a_layers=facts.has_diag_a if facts is not None else False,
            has_conv_layers=facts.has_conv if facts is not None else True,
            on_cuda=resolve_device(device).type == "cuda",
        )
        if isinstance(profile, planner.Plan):
            # an explicit plan must be valid as given; the degrade rules
            # then normalize it (owner sharding on one rank → replicated)
            planner.check_plan(profile, env)
            plan, dropped = planner.fit_plan(profile, env)
            report = None
        else:
            plan, report, dropped = planner.resolve_profile(profile, facts, env)
        defaults = planner.Plan()
        levers = dict(levers)
        for field, value in plan.kfac_kwargs().items():
            if levers[field] == getattr(defaults, field):
                levers[field] = value
        self.plan = plan
        self.plan_dropped = tuple(dropped)
        self.plan_report = report
        self.plan_env = env
        planner.log_plan(plan, dropped)
        return levers

    # ------------------------------------------------------------------
    # Solver policy
    # ------------------------------------------------------------------

    def _rank_for(self, n: int) -> Optional[int]:
        """The rank the truncated solvers keep for a factor side of size
        ``n``, or ``None`` for the dense path: below
        ``solver_auto_threshold``, or with ``solver_rank >= n`` (truncation
        buys nothing, and those configurations stay bitwise equal to
        ``solver="eigh"``). A function of the size alone, so every rank
        derives the same answer."""
        if self.solver not in ("rsvd", "streaming"):
            return None
        if n < self.solver_auto_threshold or self.solver_rank >= n:
            return None
        return self.solver_rank

    def _rank_fn(self):
        """The ``rank_fn`` of the refresh planners and updates: ``None``
        under the dense solver, so those paths stay as they were."""
        return self._rank_for if self.solver in ("rsvd", "streaming") else None

    def _spectrum_mass(self, facs, eigen_full, names) -> torch.Tensor:
        """``Σ d_r / Σ tr(F)`` over every truncated factor side: the share
        of factor trace the kept bases captured (1 when no side is
        truncated)."""
        cap = tot = None
        for n in names:
            e = eigen_full[n]
            for side in ("A", "G"):
                if f"rho{side}" not in e:
                    continue
                c = e[f"d{side}"].float().sum()
                t = torch.trace(facs[n][side].float())
                cap, tot = (c, t) if cap is None else (cap + c, tot + t)
        if cap is None:
            return torch.ones((), dtype=torch.float32, device=self.device)
        return cap / torch.clamp(tot, min=1e-30)

    # ------------------------------------------------------------------
    # Owner sharding (factor_sharding="owner")
    # ------------------------------------------------------------------

    @property
    def owner_sharded(self) -> bool:
        return self.factor_sharding == "owner"

    def _shard_plan(self, shapes: Dict[str, Tuple[int, int]], diag_a=frozenset()):
        """The owner-shard layout of this layer-shape set, cached; building
        it sets :attr:`shard_plan_info` (``shard_plan_bytes``) and
        :attr:`precond_gather_width` (the apply's per-rank gather elements)."""
        key = (tuple(sorted((n, tuple(v)) for n, v in shapes.items())), tuple(sorted(diag_a)))
        plan = self._shard_plans.get(key)
        if plan is None:
            plan = self._shard_plans[key] = plan_factor_shards(
                shapes, self.world.size, self.factor_comm.max_bucket_elems, diag_a=set(diag_a)
            )
            self.shard_plan_info = info = shard_plan_bytes(
                plan, rank_fn=self._rank_fn(), eigen_itemsize=self.eigen_dtype.itemsize
            )
            tel = get_telemetry()
            tel.set_gauge("kfac/factor_shard_bytes_local", info["total_buffer_local"])
            tel.set_gauge("kfac/factor_shard_owner_count", info["owner_count"])
            self.precond_gather_width = precond_ops._owner_gather_layout(
                shapes, plan.owners, plan.world, self._rank_fn(), set(diag_a))[2]
        return plan

    @staticmethod
    def _owner_shapes(facs) -> Tuple[Dict[str, Tuple[int, int]], set]:
        """``({layer: (g, a)}, diagonal-A layers)`` from full factors (or
        the owner state's placeholders' keys and the model's shapes)."""
        shapes, diag = {}, set()
        for name, f in facs.items():
            if "A_diag" in f:
                shapes[name] = (int(f["G"].shape[0]), int(f["A_diag"].shape[0]))
                diag.add(name)
            else:
                shapes[name] = (int(f["G"].shape[0]), int(f["A"].shape[0]))
        return shapes, diag

    def _owner_zero_eigen_shard(self, plan) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zero eigen stacks of this rank's rows: ``{"Q", "d"[, "rho"]}`` per
        matrix group (truncated groups by the size → rank policy) and
        ``{"d"}`` per diagonal-A vector group."""
        out = {
            f"n{n}": owner_eigen_entry_init(plan, n, self._rank_for(n), self.eigen_dtype,
                                            self.device)
            for n in plan.group_sizes
        }
        for n in plan.diag_group_sizes:
            out[f"v{n}"] = {"d": torch.zeros((plan.diag_group_rows[n], n),
                                             dtype=torch.float32, device=self.device)}
        return out

    def _owner_diag_eigen(self, shard, plan) -> Dict[str, Dict[str, torch.Tensor]]:
        """The diagonal-A groups' eigen entries: the floored factor
        diagonals ``d·(d > eps)`` of this rank's rows, at every refresh and
        swap."""
        return {
            f"v{n}": {"d": shard[f"v{n}"] * (shard[f"v{n}"] > self.eps)}
            for n in plan.diag_group_sizes
        }

    def _owner_factor_shard_from_full(self, facs, plan) -> Dict[str, torch.Tensor]:
        """This rank's rows of the factor stacks from full per-layer factors
        (init's identities, or a replicated state being re-homed); pad rows
        are zeros, fed only by the EMA's decay and never read."""
        rank = self.world.rank
        shard = {}
        for n in plan.group_sizes:
            shard[f"n{n}"] = torch.zeros((plan.group_rows[n], n, n), dtype=torch.float32,
                                         device=self.device)
        for n in plan.diag_group_sizes:
            shard[f"v{n}"] = torch.zeros((plan.diag_group_rows[n], n), dtype=torch.float32,
                                         device=self.device)
        for s in plan.slots:
            if s.owner == rank:
                key = f"v{s.size}" if s.diag else f"n{s.size}"
                src = facs[s.name]["A_diag" if s.diag else s.factor]
                shard[key][s.row] = src.to(self.device, torch.float32)
        return shard

    def _owner_eigen_shard_from_full(self, eigen, plan) -> Dict[str, Dict[str, torch.Tensor]]:
        """This rank's rows of the eigen stacks from full per-layer eigen
        entries (a re-homed replicated state), bitwise."""
        shard = self._owner_zero_eigen_shard(plan)
        for s in plan.slots:
            if s.owner != self.world.rank:
                continue
            e = eigen[s.name]
            if s.diag:
                shard[f"v{s.size}"]["d"][s.row] = e["dA"]
                continue
            grp = shard[f"n{s.size}"]
            for field in grp:
                grp[field][s.row] = e[f"{field}{s.factor}"].to(grp[field].dtype)
        return shard

    @staticmethod
    def _eigen_entries_from_split(singles, stacked, shapes) -> Dict[str, Dict[str, torch.Tensor]]:
        """Full per-layer eigen entries from the singles/stacked form (the
        inverse of ``split_eigen_state``, in ``shape_groups``' row order)."""
        full = {n: dict(e) for n, e in singles.items()}
        for (g, a), names in precond_ops.shape_groups(shapes).items():
            key = f"{g}x{a}"
            if key in stacked:
                for i, n in enumerate(names):
                    full[n] = {k: v[i] for k, v in stacked[key].items()}
        return full

    def _owner_placeholders(self, facs, diag_a) -> Dict[str, Dict[str, torch.Tensor]]:
        """Scalar placeholders of the per-layer factors (the layer registry;
        a diagonal-A layer keeps its ``A_diag`` key)."""
        z = lambda: torch.zeros((), dtype=torch.float32, device=self.device)  # noqa: E731
        return {n: {("A_diag" if n in diag_a else "A"): z(), "G": z()} for n in facs}

    def _owner_local_init(self, shapes, diag_a) -> Dict[str, Dict[str, torch.Tensor]]:
        """The deferred mode's full-size per-rank accumulators, zero (a
        non-owner holds no master copy to start them from)."""
        return {
            n: {"A": torch.zeros((shapes[n][1],) * (1 if n in diag_a else 2),
                                 dtype=torch.float32, device=self.device),
                "G": torch.zeros((shapes[n][0],) * 2, dtype=torch.float32, device=self.device)}
            for n in shapes
        }

    def _owner_init(self, facs) -> KFACState:
        """The owner-sharded initial state: placeholders for ``factors``,
        this rank's rows of the identity factors in ``factor_shard`` and of
        zero bases in ``eigen_shard``, ``eigen_pending_shard`` under chunks,
        and the deferred mode's ``factor_local`` and ``factor_sync_age``."""
        shapes, diag_a = self._owner_shapes(facs)
        plan = self._shard_plan(shapes, frozenset(diag_a))
        eigen_shard = self._owner_zero_eigen_shard(plan)
        state = {
            "step": 0,
            "factors": self._owner_placeholders(facs, diag_a),
            "eigen": {},
            "eigen_stacked": {},
            "factor_shard": self._owner_factor_shard_from_full(facs, plan),
            "eigen_shard": eigen_shard,
        }
        self._owner_optional_entries(state, shapes, diag_a, eigen_shard)
        return state

    def _owner_optional_entries(self, state, shapes, diag_a, eigen_shard, old=None) -> None:
        """The levers' entries of an owner state, from ``old`` (a replicated
        state being re-homed) where it has them."""
        old = old or {}
        z = lambda dtype=torch.float32: torch.zeros((), dtype=dtype, device=self.device)  # noqa: E731
        if self.eigh_chunks > 1 and "eigen_pending_shard" not in state:
            state["eigen_pending_shard"] = {
                k: {f: torch.zeros_like(v) for f, v in e.items()} for k, e in eigen_shard.items()
            }
        if self.solver in ("rsvd", "streaming"):
            state["spectrum_mass"] = old.get("spectrum_mass", z())
        if self.solver == "streaming":
            state["stream_residual"] = old.get("stream_residual", z())
            state["stream_fold_steps"] = old.get("stream_fold_steps", z(torch.int32))
        if self.factor_comm.defer:
            # a replicated deferred state's factors may hold unmerged local
            # statistics: a re-home takes them as merged (age 0)
            state["factor_local"] = self._owner_local_init(shapes, diag_a)
            state["factor_sync_age"] = z(torch.int32)
        if self.staleness_budget > 0:
            state["eigen_swap_slip"] = old.get("eigen_swap_slip", z(torch.int32))

    def owner_state_from_replicated(self, state: KFACState) -> KFACState:
        """A replicated-form state re-homed into this rank's owner rows: the
        checkpoint migration. The plan is a function of the layer shapes,
        so every rank re-derives it; the stored factors and bases land in
        their owners' rows bitwise, the pending buffer too."""
        if not self.owner_sharded:
            raise ValueError(
                "owner_state_from_replicated() requires factor_sharding='owner'"
            )
        facs = state["factors"]
        shapes, diag_a = self._owner_shapes(facs)
        plan = self._shard_plan(shapes, frozenset(diag_a))
        full_eigen = self._eigen_entries_from_split(
            state["eigen"], state.get("eigen_stacked") or {},
            {n: v for n, v in shapes.items() if n not in diag_a},
        )
        eigen_shard = self._owner_eigen_shard_from_full(full_eigen, plan)
        new_state = {
            "step": state["step"],
            "factors": self._owner_placeholders(facs, diag_a),
            "eigen": {},
            "eigen_stacked": {},
            "factor_shard": self._owner_factor_shard_from_full(facs, plan),
            "eigen_shard": eigen_shard,
        }
        if self.eigh_chunks > 1 and state.get("eigen_pending") is not None:
            new_state["eigen_pending_shard"] = self._owner_eigen_shard_from_full(
                state["eigen_pending"], plan)
        self._owner_optional_entries(new_state, shapes, diag_a, eigen_shard, old=state)
        return new_state

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _eigen_side_init(self, side: str, n: int) -> Dict[str, torch.Tensor]:
        """Zero eigen entries of one factor side: square ``Q``/full ``d``,
        or, for a side the truncated solvers keep at rank ``r``
        (:meth:`_rank_for`), ``Q [n, r]``, ``d [r]`` and the scalar
        residual mass; the layout is fixed from init."""
        rank = self._rank_for(n)
        cols = n if rank is None else rank
        e = {
            f"Q{side}": torch.zeros((n, cols), dtype=self.eigen_dtype, device=self.device),
            f"d{side}": torch.zeros((cols,), dtype=torch.float32, device=self.device),
        }
        if rank is not None:
            e[f"rho{side}"] = torch.zeros((), dtype=torch.float32, device=self.device)
        return e

    def _identity_factors(self, model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
        """Identity-initialized ``{layer: {A, G}}`` — the shape oracle.
        Embeddings get ``{A_diag, G}``: ones (the diagonal of I) over the
        vocab and an identity over the features. A grouped conv's
        pseudo-layer ``path#gK`` gets an ``(in/G)·kh·kw (+1)`` A side and an
        ``out/G`` G side; a lens split ``path#sK`` the layer's whole A side
        and an ``out/S`` G side; a shard-lens layer its identity stacks
        (``shardwise.identity_factors``)."""
        facs = {}
        names = self.layers
        if names is None:
            names = capture.discover_layers(model)
            self._register_shard_layers(names)
            self._lever_env = dataclasses.replace(
                self._lever_env, has_shard_lens_layers=self.has_shard_lens,
                has_moe_layers=self.has_moe)
            self._refuse()
        modules: Dict[str, nn.Module] = {}
        for name in names:
            base = capture.layer_base(name)
            m = modules.get(base)
            if m is None:
                m = modules[base] = model.get_submodule(base)
            parts = capture.pseudo_layers(base, m)
            if name not in parts:
                raise ValueError(
                    f"K-FAC layer {name!r}: a grouped conv is listed as its "
                    f"pseudo-layers '{base}{capture.GROUP_SEP}K', a lens-split "
                    f"dense layer as its '{base}{capture.SPLIT_SEP}K', a "
                    f"shard-lens layer as '{parts[0]}', any other layer by "
                    "its module path"
                )
            _, form, count = capture.split_shard_name(name)
            if form is not None:
                local = self.split_layers.get(name, count)
                if getattr(m, "local_shards", count) != local:
                    raise ValueError(
                        f"shard-lens layer {name!r} holds {m.local_shards} of its "
                        f"{count} blocks; this preconditioner's tensor axis gives it "
                        f"{local} (split the model over the same world: "
                        "KFACShardedDense.split_)")
                facs[name] = shardwise.identity_factors(
                    form, local, tuple(m.weight.shape), getattr(m, "bias", None) is not None,
                    device=self.device)
                continue
            if isinstance(m, KFACEmbed):
                vocab, feats = m.weight.shape
                facs[name] = {
                    "A_diag": torch.ones(vocab, dtype=torch.float32, device=self.device),
                    "G": torch.eye(feats, dtype=torch.float32, device=self.device),
                }
                continue
            has_bias = m.bias is not None
            if isinstance(m, KFACConv):
                cout, cin, kh, kw = m.weight.shape  # cin: in/G already
                a_side = cin * kh * kw + int(has_bias)
            else:
                cout, cin = m.weight.shape
                a_side = cin + int(has_bias)
            cout //= len(parts)  # a group's or a lens split's output slice
            facs[name] = {
                "A": torch.eye(a_side, dtype=torch.float32, device=self.device),
                "G": torch.eye(cout, dtype=torch.float32, device=self.device),
            }
        return facs

    def factor_shapes(self, model: nn.Module) -> Tuple[Dict[str, Tuple[int, int]], set]:
        """``({layer: (g, a)}, diagonal-A layers)`` of ``model``: the pure
        inputs of the owner-shard plan, the same on every rank, which is
        what makes the elastic resize replan deterministic."""
        return self._owner_shapes(self._identity_factors(model))

    def init(self, model: nn.Module) -> KFACState:
        """Identity factors + zero eigen (or inverse) state, same-shape groups
        pre-stacked; the zeroed diagnostics with ``track_diagnostics``, and
        the entries of the levers that are set: the pipelined refresh's
        ``eigen_pending`` (``eigh_chunks > 1``), the truncated solvers'
        ``spectrum_mass``, streaming's ``stream_residual`` and
        ``stream_fold_steps``, the staleness slip's ``eigen_swap_slip``, the
        deferred factor flush's ``factor_sync_age`` and, on the int8 wire,
        ``wire_error``."""
        facs = self._identity_factors(model)
        if self.owner_sharded:
            return self._owner_init(facs)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def zq(n):  # a matrix inverse
            return z(n, n, dtype=self.eigen_dtype)

        inverse = self.precond_method == "inverse"
        eigen = {}
        for name, f in facs.items():
            form = capture.split_shard_name(name)[1]
            if form is not None:
                # form-prefixed identity bases, always float32
                eigen[name] = shardwise.identity_eigen(form, f)
                continue
            g_side = f["G"].shape[0]
            if "A_diag" in f:
                vocab = f["A_diag"].shape[0]
                eigen[name] = (
                    {"iA_diag": z(vocab), "iG": zq(g_side)} if inverse
                    else {"dA": z(vocab), **self._eigen_side_init("G", g_side)}
                )
                continue
            a_side = f["A"].shape[0]
            eigen[name] = (
                {"iA": zq(a_side), "iG": zq(g_side)} if inverse
                else {**self._eigen_side_init("A", a_side), **self._eigen_side_init("G", g_side)}
            )
        split = precond_ops.split_inv_state if inverse else precond_ops.split_eigen_state
        singles, stacked = split(eigen)
        state = {"step": 0, "factors": facs, "eigen": singles, "eigen_stacked": stacked}
        if self.eigh_chunks > 1:
            # the pipelined refresh's double buffer, in full per-layer form
            # (chunks write block regions; the swap splits it); tensors of
            # its own, apart from the active basis's
            state["eigen_pending"] = {
                n: {k: torch.zeros_like(v) for k, v in e.items()} for n, e in eigen.items()
            }
        if self.solver in ("rsvd", "streaming"):
            # share of factor trace the truncated bases captured at the last
            # refresh
            state["spectrum_mass"] = z()
        if self.solver == "streaming":
            # the fold's drift gauge and the folds since the last
            # re-orthonormalization
            state["stream_residual"] = z()
            state["stream_fold_steps"] = z(dtype=torch.int32)
        if self.factor_comm.defer:
            # capture steps since the last merge of the ranks' factors (0:
            # merged); between flushes the factors are each rank's own
            # running averages, so no extra buffers
            state["factor_sync_age"] = z(dtype=torch.int32)
            if self.factor_comm.quantized:
                # one float32 residual per wire bucket: what this rank's last
                # int8 flush rounded away, folded into the next one
                state["wire_error"] = self.factor_comm.wire_error_init(facs)
        if self.staleness_budget > 0:
            # 1 while a fully landed pending basis waits for a slipped swap
            state["eigen_swap_slip"] = z(dtype=torch.int32)
        if self.track_diagnostics:
            state["diagnostics"] = {
                "nu": torch.ones((), dtype=torch.float32, device=self.device),
                "min_damped_eig": z(),
                "max_damped_eig": z(),
                "grad_norm": z(),
                "update_norm": z(),
                "update_grad_cos": z(),
                "eigen_stale_steps": z(dtype=torch.int32),
                "layer_cond": {name: {"cond_A": z(), "cond_G": z()} for name in facs},
            }
        return state

    def state_placements(self, state: KFACState) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Where the shardwise factor/eigen leaves of ``state`` live on this
        preconditioner's world (the shardwise part of the JAX
        ``state_shardings``): ``{"factors"|"eigen": {layer: {key:
        placement}}}``, a placement ``("tensor", 0)`` for a stack whose
        blocks the tensor slots split (each rank holds its kernel shard's)
        and ``None`` for one every rank holds whole
        (``shardwise.factor_leaf_spec``). Every other leaf is replicated
        over the tensor slots, and under owner sharding split by the owner
        plan as before."""
        out: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for key in ("factors", "eigen"):
            for name, entry in state.get(key, {}).items():
                se = self.shard_layers.get(name)
                if se is not None:
                    out.setdefault(key, {})[name] = {
                        k: shardwise.factor_leaf_spec(name, k, (se[2],), self.world.tensor_size)
                        for k in entry}
        return out

    # ------------------------------------------------------------------
    # Update
    # ------------------------------------------------------------------

    def update(
        self,
        grads: Dict[str, torch.Tensor],
        state: KFACState,
        *,
        a_contribs: Optional[Dict[str, torch.Tensor]] = None,
        g_factor_stats: Optional[Dict[str, torch.Tensor]] = None,
        lr=None,
        damping=None,
        update_factors: bool,
        update_eigen: bool,
        diag_warmup_done: bool = True,
        eigen_chunk: Optional[Tuple[int, int]] = None,
        swap_eigen: bool = False,
        flush_factors: bool = False,
        exchanged: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], KFACState]:
        """One K-FAC step: factor EMA (capture steps), curvature refresh
        (``update_eigen``), precondition + KL clip (every step).

        ``diag_warmup_done`` (``kfac_flags_for_step``: ``epoch >=
        diag_warmup``) lets a refresh split conv factors into
        ``diag_blocks`` blocks; before it, every factor is one block.

        ``eigen_chunk=(c, k)`` and ``swap_eigen`` (``eigh_chunks > 1``
        only) drive the pipelined refresh: the step runs chunk ``c`` of a
        ``k``-chunk plan into ``state["eigen_pending"]`` and still
        preconditions with the active basis; ``swap_eigen`` on the last
        chunk's step promotes the completed pending basis first. Alone,
        ``swap_eigen`` is a slipped swap's catch-up (``staleness_budget >
        0``). ``scheduler.EigenRefreshCadence`` owns the schedule, and the
        invariant that a partial basis is never swapped in.

        ``flush_factors`` (deferred factor communication only:
        ``factor_comm_freq > 1`` over more than one rank) merges the ranks'
        local running averages after this step's EMA and before any eigen
        work reads them; a step that starts a refresh (``update_eigen``, or
        chunk 0) must carry it, and the cadences set it. The int8 wire's
        flush writes the new residuals into the input state's
        ``wire_error`` buffers.

        Under ``solver="streaming"`` a capture step without a refresh folds
        the averaged factors through the kept bases (in deferred mode on
        flush steps only).

        ``exchanged`` says the statistics are the ranks' means already: the
        overlap plane's train steps exchange them before the gradient mean
        (``FactorComm.start_exchange``).

        Under ``factor_sharding="owner"`` the same flags drive
        :meth:`_update_owner`.

        The ``trace/kfac/*`` spans (the JAX package's names) time each
        phase's host dispatch, with no sync: the port runs eagerly, where
        the JAX package's spans time the phase's tracing once a compile."""
        self._join_side_stream()
        tel = get_telemetry()
        if lr is None:
            raise ValueError(
                "KFAC.update() requires lr= (the KL clip scales with the "
                "trainer's current learning rate)"
            )
        if damping is None:
            damping = self.hparams.damping
        if self.service_devices > 0 and (update_eigen or eigen_chunk is not None or swap_eigen):
            # the zero-eigh training step the service promises: no flag
            # combination runs a refresh here
            raise ValueError(
                "service_devices > 0 delegates the curvature refresh to "
                "dedicated workers — the training step must never run "
                "update_eigen/eigen_chunk/swap_eigen; refreshed bases "
                "arrive via service.ServiceClient.install between steps"
            )
        if eigen_chunk is not None:
            if self.eigh_chunks <= 1:
                raise ValueError(
                    "eigen_chunk= requires KFAC(eigh_chunks > 1) — the state "
                    "carries no eigen_pending double buffer to accumulate into"
                )
            if update_eigen:
                raise ValueError(
                    "eigen_chunk= and update_eigen=True are mutually "
                    "exclusive: a step either pipelines one chunk or runs "
                    "the monolithic refresh"
                )
            c, k = eigen_chunk
            if not (0 < k and 0 <= c < k):
                raise ValueError(f"Invalid eigen_chunk: {eigen_chunk}")
        elif swap_eigen:
            if self.staleness_budget <= 0:
                raise ValueError(
                    "swap_eigen=True without eigen_chunk=: the swap rides "
                    "the final chunk's step so the program count stays "
                    "bounded (only a staleness_budget > 0 configuration "
                    "may land a slipped swap on a chunk-free step)"
                )
            if self.eigh_chunks <= 1:
                raise ValueError(
                    "swap_eigen=True requires KFAC(eigh_chunks > 1) — the "
                    "state carries no eigen_pending double buffer to promote"
                )
            if update_eigen:
                raise ValueError(
                    "swap_eigen= and update_eigen=True are mutually "
                    "exclusive: the monolithic refresh installs its own "
                    "basis"
                )
        if flush_factors and not self.factor_comm.defer:
            raise ValueError(
                "flush_factors=True without deferred factor communication "
                "(factor_comm_freq > 1 on a multi-device mesh) — there is "
                "no locally-accumulated factor state to merge"
            )
        if self.factor_comm.defer and not flush_factors:
            if update_eigen or (eigen_chunk is not None and eigen_chunk[0] == 0):
                raise ValueError(
                    "deferred factor communication requires flush_factors="
                    "True on every step that starts an eigen refresh — the "
                    "eigendecomposition would otherwise read per-replica "
                    "unmerged factors. The cadence helpers "
                    "(kfac_flags_for_step / EigenRefreshCadence) set this; "
                    "hand-rolled schedules must too."
                )
        if self.owner_sharded:
            return self._update_owner(
                grads, state, a_contribs=a_contribs, g_factor_stats=g_factor_stats, lr=lr,
                damping=damping, update_factors=update_factors, update_eigen=update_eigen,
                eigen_chunk=eigen_chunk, swap_eigen=swap_eigen, flush_factors=flush_factors,
            )
        names = list(state["factors"].keys())
        facs = state["factors"]
        if update_factors:
            if a_contribs is None or g_factor_stats is None:
                raise ValueError(
                    "update_factors=True requires a_contribs and g_factor_stats"
                )
            missing = [n for n in names if n not in a_contribs or n not in g_factor_stats]
            if missing:
                raise ValueError(
                    f"no captured statistics for layers {missing}; build the "
                    "Capture with the same layer list as KFAC"
                )
            with tel.span("trace/kfac/factor_update"):
                if self.factor_comm.multi_device and not exchanged:
                    # the global batch's statistics: each rank's contributions
                    # are over its own batch, so their mean over the ranks is
                    # the JAX package's global-batch A and G (deferred: this
                    # rank's own, until the flush)
                    a_contribs, g_factor_stats = self.factor_comm.exchange_contribs(
                        {n: a_contribs[n] for n in names}, {n: g_factor_stats[n] for n in names}
                    )
                # elementwise EMA: the same update serves A matrices, the
                # embeddings' A_diag vectors and the column/row shard stacks; an
                # MoE bank's is token-count-weighted (shardwise.ema_update)
                old_facs, facs = facs, {}
                for name in names:
                    se = self.shard_layers.get(name)
                    if se is not None:
                        facs[name] = shardwise.ema_update(
                            se[1], old_facs[name], a_contribs[name], g_factor_stats[name],
                            self.factor_decay)
                        continue
                    a_key = "A_diag" if "A_diag" in old_facs[name] else "A"
                    facs[name] = {
                        a_key: factor_ops.update_running_avg(
                            a_contribs[name], old_facs[name][a_key], self.factor_decay
                        ),
                        "G": factor_ops.update_running_avg(
                            g_factor_stats[name], old_facs[name]["G"], self.factor_decay
                        ),
                    }
        wire_error = state.get("wire_error")
        if flush_factors:
            # the ranks' running averages merged after this step's EMA and
            # before any eigen path below reads them; the int8 wire folds in
            # and carries out the residuals, its rounding keyed by the step
            if self.factor_comm.quantized:
                if not update_factors:
                    # the merge lands in the leaves: keep the input state's
                    facs = {n: {k: v.clone() for k, v in f.items()} for n, f in facs.items()}
                facs, wire_error = self.factor_comm.flush(
                    facs, wire_error=wire_error, step=state["step"]
                )
            else:
                facs = self.factor_comm.flush(facs)
        eigen, stacked = state["eigen"], state["eigen_stacked"]
        pending = state.get("eigen_pending")
        spectrum_mass = state.get("spectrum_mass")
        # per-layer (dA, dG) of an eigen refresh, for the diagnostics
        fresh_spectra = None
        # overlap mechanism (b): a chunk-only step leaves the active basis
        # alone, so precondition first and run the chunk on the side stream
        early = None
        if self._precond_early(eigen_chunk, swap_eigen):
            with tel.span("trace/kfac/precondition"):
                early = self._precondition_replicated(grads, names, eigen, stacked, lr, damping)
        if update_eigen and self.precond_method == "inverse":
            with tel.span("trace/kfac/eigh"):
                inv = precond_ops.factored_inverse_all(facs, damping, self.eps)
                # only the matrix inverses take eigen_dtype; an embedding's
                # iA_diag stays float32, as its eigen-method dA does
                inv = {
                    n: {k: v if k == "iA_diag" else v.to(self.eigen_dtype) for k, v in e.items()}
                    for n, e in inv.items()
                }
                eigen, stacked = precond_ops.split_inv_state(inv)
        elif update_eigen:
            with tel.span("trace/kfac/eigh"):
                diag_blocks = self.diag_blocks if diag_warmup_done else 1
                # the shard-lens layers refresh apart, below
                norm_names = [n for n in names if n not in self.shard_layers]
                norm_facs = {n: facs[n] for n in norm_names}
                # eigh runs in float32; Q is written in eigen_dtype
                if self.world.size > 1:
                    eigen = sharded_eigen_update(
                        norm_facs, self._eigh_table(grads, norm_names, diag_blocks), self.world,
                        self.eps, self.eigen_dtype, rank_fn=self._rank_fn(),
                    )
                else:
                    # blocks split conv factors only (a conv weight is OIHW)
                    blocks = {n: diag_blocks if self._is_conv(grads, n) else 1 for n in norm_names}
                    eigen = replicated_eigen_update(
                        norm_facs, blocks, self.eps, self.eigen_dtype, rank_fn=self._rank_fn()
                    )
                # shard-lens layers: a dense batched eigh per stack on every rank
                # (shardwise.eigen_refresh), no assignment table, no collective
                for n, (_, form, _) in self.shard_layers.items():
                    eigen[n] = shardwise.eigen_refresh(form, facs[n])
                eigen, stacked, spectrum_mass, fresh_spectra = self._install(
                    facs, eigen, names, spectrum_mass, self.solver != "eigh"
                )
        elif eigen_chunk is not None:
            # one chunk of the refresh plan, on the current factors, into
            # the pending buffer; the plan is LPT over the slots the
            # monolithic refresh would build, so every rank derives it
            c, k = eigen_chunk
            diag_blocks = self.diag_blocks if diag_warmup_done else 1
            if self.world.size > 1:
                slots = build_slots(facs, self._eigh_table(grads, names, diag_blocks))
            else:
                slots = build_slots(
                    facs, None,
                    {n: diag_blocks if self._is_conv(grads, n) else 1 for n in names},
                )
            plan = plan_eigh_chunks(slots, k, rank_fn=self._rank_fn())
            chunk_slots = [slots[i] for i in plan[c]]
            if c == 0:
                # a fresh interval: new zeroed buffers, so the swap sees what
                # a refresh from zeros builds (block boundaries move when the
                # diag warmup ends) and no chunk writes into a tensor the
                # active basis holds
                pending = {
                    n: {key: torch.zeros_like(v) for key, v in e.items()}
                    for n, e in pending.items()
                }
            if chunk_slots:
                if self.world.size > 1:
                    run = lambda p: sharded_eigen_chunk_update(  # noqa: E731
                        facs, p, chunk_slots, self.world, self.eps, rank_fn=self._rank_fn(),
                    )
                else:
                    run = lambda p: replicated_eigen_chunk_update(  # noqa: E731
                        facs, p, chunk_slots, self.eps, rank_fn=self._rank_fn()
                    )
                with tel.span("trace/kfac/eigh"):
                    pending = self._on_side_stream(early is not None, (facs, pending), run,
                                                   pending)
            if swap_eigen:
                eigen, stacked, spectrum_mass, fresh_spectra = self._install(
                    facs, pending, names, spectrum_mass, self.solver == "rsvd"
                )
        elif swap_eigen:
            # a slipped swap's catch-up: every chunk is in the pending
            # buffer already
            eigen, stacked, spectrum_mass, fresh_spectra = self._install(
                facs, pending, names, spectrum_mass, self.solver == "rsvd"
            )

        # streaming: a capture step folds the averaged factors through the
        # kept bases; a re-orthonormalization (a refresh) resets the gauge
        # from its own spectrum mass
        stream_residual = state.get("stream_residual")
        stream_fold_steps = state.get("stream_fold_steps")
        if self.solver == "streaming":
            if update_eigen:
                stream_residual = torch.clamp(1.0 - spectrum_mass, min=0.0)
                stream_fold_steps = torch.zeros_like(stream_fold_steps)
            elif update_factors and (not self.factor_comm.defer or flush_factors):
                with tel.span("trace/kfac/stream_fold"):
                    eigen, stacked, stream_residual = streaming_ops.fold_replicated(
                        facs, eigen, stacked, self.eps
                    )
                stream_fold_steps = stream_fold_steps + 1

        if early is None:
            with tel.span("trace/kfac/precondition"):
                early = self._precondition_replicated(grads, names, eigen, stacked, lr, damping)
        new_grads, gmats, updates, nu = early
        new_state = {
            "step": state["step"] + 1,
            "factors": facs,
            "eigen": eigen,
            "eigen_stacked": stacked,
        }
        if pending is not None:
            new_state["eigen_pending"] = pending
        if spectrum_mass is not None:
            new_state["spectrum_mass"] = spectrum_mass
        if stream_residual is not None:
            new_state["stream_residual"] = stream_residual
            new_state["stream_fold_steps"] = stream_fold_steps
        if "factor_sync_age" in state:
            new_state["factor_sync_age"] = (
                torch.zeros_like(state["factor_sync_age"]) if flush_factors
                else state["factor_sync_age"] + int(update_factors)
            )
        if wire_error is not None:
            # replaced by the quantized merge's residuals on flush steps
            new_state["wire_error"] = wire_error
        if "eigen_swap_slip" in state:
            # 1 from the last chunk's step that withheld its swap until a
            # swap or a refresh installs a basis
            last_chunk_no_swap = (
                eigen_chunk is not None and eigen_chunk[0] == eigen_chunk[1] - 1 and not swap_eigen
            )
            new_state["eigen_swap_slip"] = (
                torch.zeros_like(state["eigen_swap_slip"]) if (swap_eigen or update_eigen)
                else state["eigen_swap_slip"] + int(last_chunk_no_swap)
            )
        if self.track_diagnostics:
            new_state["diagnostics"] = self._diagnostics(
                state["diagnostics"], fresh_spectra, gmats, updates, nu, damping,
                update_eigen or swap_eigen,
            )
        return new_grads, new_state

    # ------------------------------------------------------------------
    # The overlap plane's side stream (mechanism (b))
    # ------------------------------------------------------------------

    def _precond_early(self, eigen_chunk, swap_eigen) -> bool:
        """A chunk-only step under ``comm_overlap``: the chunk feeds only the
        pending buffer, so the precondition goes first."""
        return self.comm_overlap and eigen_chunk is not None and not swap_eigen

    def _on_side_stream(self, early, reads, run, pending):
        """``run(pending)`` (a chunk's decomposition into the pending
        buffer): on a CUDA device, when the precondition went first
        (``early``), on the side stream, ordered after everything issued so
        far (the factors, the fresh pending buffers, the precondition), so
        that it overlaps what the host issues next; otherwise here. Tensors
        read across the streams are recorded on the stream that reads them,
        and :meth:`_join_side_stream` orders the next reader after it.
        ``torch.linalg.eigh`` waits on the host for its info check, so the
        host issues nothing more until the side stream's eigh ends."""
        if not early or self.device.type != "cuda":
            return run(pending)
        main = torch.cuda.current_stream(self.device)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(main)
        for t in (t for tree in reads for t in tree_leaves(tree)):
            t.record_stream(side)
        with torch.cuda.stream(side):
            out = run(pending)
        for t in tree_leaves(out):
            t.record_stream(main)
        self._side_done = torch.cuda.Event()
        self._side_done.record(side)
        return out

    def _join_side_stream(self) -> None:
        """Order the current stream after the last side-stream chunk (the
        next update may swap or refresh from its pending buffer)."""
        if self._side_done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._side_done)
            self._side_done = None

    # ------------------------------------------------------------------
    # Owner-sharded update
    # ------------------------------------------------------------------

    def _update_owner(self, grads, state, *, a_contribs, g_factor_stats, lr, damping,
                      update_factors, update_eigen, eigen_chunk, swap_eigen, flush_factors):
        """The ``factor_sharding="owner"`` step (DP-KFAC), with
        :meth:`update`'s flags (validated there):

        * factor EMA: each rank's ``(1−α)·contrib`` reduce-scattered onto the
          owners' rows (``FactorComm.scatter_merge``); deferred, the EMA of
          this rank's own statistics in ``factor_local`` (from zeros), and
          the flush scatters it with decay ``α^m``, ``m`` the capture steps
          since the last flush, this one's included;
        * the refresh, chunk, swap and bare swap over this rank's shard
          stacks, owner-local (no collective), the streaming fold on capture
          steps (flush steps when deferred);
        * the precondition: each layer on its owner, one ``all_gather``
          (``ops.precondition.precondition_all_owner``), in
          ``precondition_all``'s emission order."""
        names = list(state["factors"].keys())
        # the diagonal-A set from the placeholders' keys, the shapes from the
        # gradients: the plan init derived from the same
        diag_a = frozenset(n for n in names if "A_diag" in state["factors"][n])
        lgrads = capture.layer_grads(grads, names, diag_a)
        gmats = {n: m.float() for n, m in capture.grad_mats(lgrads).items()}
        plan = self._shard_plan({n: tuple(g.shape) for n, g in gmats.items()}, diag_a)
        tel = get_telemetry()
        alpha = self.factor_decay
        shard = state["factor_shard"]
        local = state.get("factor_local")
        if update_factors:
            if a_contribs is None or g_factor_stats is None:
                raise ValueError(
                    "update_factors=True requires a_contribs and g_factor_stats"
                )
            missing = [n for n in names if n not in a_contribs or n not in g_factor_stats]
            if missing:
                raise ValueError(
                    f"no captured statistics for layers {missing}; build the "
                    "Capture with the same layer list as KFAC"
                )
            with tel.span("trace/kfac/factor_update"):
                if self.factor_comm.defer:
                    local = {
                        n: {"A": factor_ops.update_running_avg(a_contribs[n], local[n]["A"],
                                                               alpha),
                            "G": factor_ops.update_running_avg(g_factor_stats[n], local[n]["G"],
                                                               alpha)}
                        for n in names
                    }
                else:
                    payload = {
                        n: {"A": (1.0 - alpha) * a_contribs[n].float(),
                            "G": (1.0 - alpha) * g_factor_stats[n].float()}
                        for n in names
                    }
                    shard = self.factor_comm.scatter_merge(payload, shard, plan, alpha)
        if flush_factors:
            m = state["factor_sync_age"] + int(update_factors)
            decay = torch.pow(torch.tensor(alpha, dtype=torch.float32, device=self.device),
                              m.float())
            shard = self.factor_comm.scatter_merge(local, shard, plan, decay)
            local = {n: {k: torch.zeros_like(v) for k, v in f.items()} for n, f in local.items()}

        eigen_shard = state["eigen_shard"]
        pending = state.get("eigen_pending_shard")
        spectrum_mass = state.get("spectrum_mass")
        rank_fn = self._rank_fn()
        new_grads = None
        if self._precond_early(eigen_chunk, swap_eigen):
            new_grads = self._precondition_owner(grads, gmats, eigen_shard, lr, damping, plan,
                                                 diag_a)

        def mass(eigen):
            return owner_spectrum_mass(shard, eigen, plan, self.world, rank_fn=rank_fn)

        if update_eigen:
            with tel.span("trace/kfac/eigh"):
                eigen_shard = {
                    **owner_eigen_update(shard, plan, self.world.rank, self.eps, rank_fn=rank_fn,
                                         eigen_dtype=self.eigen_dtype),
                    **self._owner_diag_eigen(shard, plan),
                }
                if self.solver in ("rsvd", "streaming"):
                    spectrum_mass = mass(eigen_shard)
        elif eigen_chunk is not None:
            c, k = eigen_chunk
            jobs = plan_owner_chunks(plan, k, rank_fn=rank_fn)[c]
            if c == 0:
                # a fresh interval: new zeroed buffers, none the active basis holds
                pending = {key: {f: torch.zeros_like(v) for f, v in e.items()}
                           for key, e in pending.items()}
            if jobs:
                with tel.span("trace/kfac/eigh"):
                    pending = self._on_side_stream(
                        new_grads is not None, (shard, pending),
                        lambda p: owner_eigen_chunk_update(
                            shard, p, jobs, plan, self.world.rank, self.eps, rank_fn=rank_fn,
                            eigen_dtype=self.eigen_dtype),
                        pending,
                    )
            if swap_eigen:
                eigen_shard = {**pending, **self._owner_diag_eigen(shard, plan)}
                if self.solver == "rsvd":
                    spectrum_mass = mass(eigen_shard)
        elif swap_eigen:
            eigen_shard = {**pending, **self._owner_diag_eigen(shard, plan)}
            if self.solver == "rsvd":
                spectrum_mass = mass(eigen_shard)

        stream_residual = state.get("stream_residual")
        stream_fold_steps = state.get("stream_fold_steps")
        if self.solver == "streaming":
            if update_eigen:
                stream_residual = torch.clamp(1.0 - spectrum_mass, min=0.0)
                stream_fold_steps = torch.zeros_like(stream_fold_steps)
            elif update_factors and (not self.factor_comm.defer or flush_factors):
                with tel.span("trace/kfac/stream_fold"):
                    eigen_shard, stream_residual = owner_stream_fold(
                        shard, eigen_shard, plan, self.world, self.eps, rank_fn=rank_fn
                    )
                stream_fold_steps = stream_fold_steps + 1

        if new_grads is None:
            new_grads = self._precondition_owner(grads, gmats, eigen_shard, lr, damping, plan,
                                                 diag_a)
        new_state = {
            "step": state["step"] + 1,
            "factors": state["factors"],
            "eigen": state["eigen"],
            "eigen_stacked": state["eigen_stacked"],
            "factor_shard": shard,
            "eigen_shard": eigen_shard,
        }
        if pending is not None:
            new_state["eigen_pending_shard"] = pending
        if spectrum_mass is not None:
            new_state["spectrum_mass"] = spectrum_mass
        if stream_residual is not None:
            new_state["stream_residual"] = stream_residual
            new_state["stream_fold_steps"] = stream_fold_steps
        if local is not None:
            new_state["factor_local"] = local
            new_state["factor_sync_age"] = (
                torch.zeros_like(state["factor_sync_age"]) if flush_factors
                else state["factor_sync_age"] + int(update_factors)
            )
        if "eigen_swap_slip" in state:
            last_chunk_no_swap = (
                eigen_chunk is not None and eigen_chunk[0] == eigen_chunk[1] - 1 and not swap_eigen
            )
            new_state["eigen_swap_slip"] = (
                torch.zeros_like(state["eigen_swap_slip"]) if (swap_eigen or update_eigen)
                else state["eigen_swap_slip"] + int(last_chunk_no_swap)
            )
        return new_grads, new_state

    def _precondition_owner(self, grads, gmats, eigen_shard, lr, damping, plan, diag_a):
        """The owner mode's precondition + KL clip (:meth:`_update_owner`)."""
        with get_telemetry().span("trace/kfac/precondition"):
            updates = precond_ops.precondition_all_owner(
                gmats, eigen_shard, damping, self.precond_precision, world=self.world, plan=plan,
                rank_fn=self._rank_fn(), eigen_dtype=self.eigen_dtype, kind=self.apply_kernel,
            )
            nu = precond_ops.kl_clip_coefficient(updates, gmats, lr, self.hparams.kl_clip)
            return capture.write_back(grads, updates, nu, set(diag_a))

    def start_exchange(self, state: KFACState, a_contribs, g_factor_stats):
        """Overlap mechanism (a): a capture step's factor bucket means
        started now (reversed, asynchronous) over the state's layers in its
        order, the order :meth:`update` would exchange them in; calling the
        returned function finishes them and gives the means for
        ``update(exchanged=True)``. ``None`` when the plane does not overlap
        this exchange (serial, deferred, owner-sharded or a world of one)."""
        if not self.factor_comm.overlaps_exchange:
            return None
        names = list(state["factors"].keys())
        return self.factor_comm.start_exchange(
            {n: a_contribs[n] for n in names}, {n: g_factor_stats[n] for n in names}
        )

    def _eigh_table(self, grads, names, diag_blocks):
        """The round-robin owners of the refresh's slots over the ranks."""
        return layer_assignment(
            names,
            {n: self._is_conv(grads, n) for n in names},
            self.world.size,
            self.distribute_layer_factors,
            diag_blocks,
        )

    def _install(self, facs, full, names, spectrum_mass, with_mass):
        """A refreshed (or swapped-in) full per-layer eigen dict made the
        active basis: the embeddings' diagonal-A eigenvalues from the
        current factors (the identity is their eigenbasis, so no eigh: the
        diagonal under the reference's floor), the spectrum mass when
        ``with_mass``, the diagnostics' spectra, the singles/stacked split.
        Returns ``(singles, stacked, spectrum_mass, fresh_spectra)``."""
        full, spectrum_mass = self._finish_refresh(facs, full, names, spectrum_mass, with_mass)
        fresh_spectra = None
        if self.track_diagnostics:
            # a shard-lens layer's spectra are its blocks' eigenvalues, flat
            fresh_spectra = {}
            for n in names:
                se = self.shard_layers.get(n)
                if se is not None:
                    _, da_k, _, dg_k = shardwise.EIGEN_KEYS[se[1]]
                    fresh_spectra[n] = (full[n][da_k].reshape(-1), full[n][dg_k].reshape(-1))
                else:
                    fresh_spectra[n] = (_side_spectrum(full[n], "A"), _side_spectrum(full[n], "G"))
        singles, stacked = precond_ops.split_eigen_state(full)
        return singles, stacked, spectrum_mass, fresh_spectra

    def _finish_refresh(self, facs, full, names, spectrum_mass, with_mass):
        """A refreshed full per-layer eigen dict completed as every refresh
        completes it (the inline one and the curvature service's worker):
        the embeddings' ``dA`` is the current ``A_diag`` under the floor, and
        with ``with_mass`` the spectrum mass is recomputed. Returns
        ``(full, spectrum_mass)``."""
        full = {n: dict(e) for n, e in full.items()}
        for name in names:
            if "A_diag" in facs[name]:
                d = facs[name]["A_diag"]
                full[name]["dA"] = d * (d > self.eps)
        if with_mass:
            spectrum_mass = self._spectrum_mass(facs, full, names)
        return full, spectrum_mass

    @staticmethod
    def _is_conv(grads, name: str) -> bool:
        """A conv layer (an OIHW weight): the layers ``diag_blocks`` splits."""
        return grads[f"{capture.layer_base(name)}.weight"].dim() == 4

    def _precondition_replicated(self, grads, names, eigen, stacked, lr, damping):
        """Every-step precondition + KL clip (the JAX method's name: the
        distributed apply is a branch of it there too); returns
        ``(new_grads, gmats, updates, nu)``."""
        embeddings = precond_ops.diag_a_names(eigen)
        lgrads = capture.layer_grads(grads, names, embeddings)
        gmats = {n: m.float() for n, m in capture.grad_mats(lgrads).items()}
        # shard-lens layers solve shard-locally (shardwise.precondition),
        # outside the shape groups and the distributed assignment
        norm_gmats = {n: g for n, g in gmats.items() if n not in self.shard_layers}
        vg_terms = None
        if not norm_gmats:
            updates = {}
        elif self.distribute_precondition and self.world.size > 1:
            owners = precondition_assignment(
                {n: tuple(g.shape) for n, g in norm_gmats.items()},
                self.world.size,
                diag_a=embeddings,
            )
            common = dict(world=self.world, owners=owners, comm_dtype=self.precond_comm_dtype)
            if self.precond_method == "inverse":
                updates = precond_ops.precondition_all_inv_distributed(
                    norm_gmats, eigen, stacked, self.precond_precision, **common
                )
            else:
                updates = precond_ops.precondition_all_distributed(
                    norm_gmats, eigen, damping, stacked, self.precond_precision,
                    kind=self.apply_kernel, **common,
                )
        elif self.precond_method == "inverse":
            updates = precond_ops.precondition_all_inv(
                norm_gmats, eigen, stacked=stacked, precision=self.precond_precision
            )
        else:
            updates, vg_terms = precond_ops.precondition_all_with_vg(
                norm_gmats, eigen, damping, stacked=stacked, kind=self.apply_kernel,
                precision=self.precond_precision,
            )
        for n, (_, form, count) in self.shard_layers.items():
            updates[n] = shardwise.precondition(
                form, self.split_layers.get(n, count), gmats[n], eigen[n], damping)
            if vg_terms is not None and n not in self.split_layers:
                # after the fused kernel's partials, in emission order
                vg_terms.append((updates[n] * gmats[n]).sum())
        if self.split_layers:
            # the split layers' Σ v·g over their local blocks, summed over
            # the tensor slots, once beside the replicated layers' terms
            if vg_terms is None:
                vg_terms = [(v.float() * gmats[n].float()).sum() for n, v in updates.items()
                            if n not in self.split_layers]
            part = sum((updates[n] * gmats[n]).sum() for n in self.split_layers).reshape(1)
            vg_terms.append(self.world.tensor_sum_(part)[0])
            nu = precond_ops.kl_clip_from_vg(vg_terms, lr, self.hparams.kl_clip)
        elif vg_terms is not None:
            nu = precond_ops.kl_clip_from_vg(vg_terms, lr, self.hparams.kl_clip)
        else:
            nu = precond_ops.kl_clip_coefficient(updates, gmats, lr, self.hparams.kl_clip)
        return capture.write_back(grads, updates, nu, embeddings), gmats, updates, nu

    def _diagnostics(self, prev, fresh_spectra, gmats, updates, nu, damping, update_eigen):
        """The next diagnostics state (the structure of :meth:`init`'s).

        The spectrum entries (min/max damped eigenvalue, per-layer damped
        condition numbers) refresh from ``fresh_spectra`` (an eigen-method
        refresh) and carry forward otherwise; the norms, the update/gradient
        cosine and the staleness count are computed every step. Device
        tensors throughout: nothing is read back to the host.
        """
        # λ in float32: a 0-d tensor stays on the device (no host read)
        lam = (damping.to(torch.float32) if isinstance(damping, torch.Tensor)
               else float(np.float32(damping)))
        min_eig, max_eig = prev["min_damped_eig"], prev["max_damped_eig"]
        layer_cond = prev["layer_cond"]
        if fresh_spectra is not None:
            mins, maxs, layer_cond = [], [], {}
            ext = {}
            for n, (da, dg) in fresh_spectra.items():
                da_mn, da_mx = torch.aminmax(da.float())
                dg_mn, dg_mx = torch.aminmax(dg.float())
                ext[n] = (da_mn, da_mx, dg_mn, dg_mx)
            split = [n for n in ext if n in self.split_layers]
            if split:
                # the split layers' extremes over every tensor slot's blocks:
                # one max over (−min, max) pairs
                v = torch.stack([torch.stack((-ext[n][0], ext[n][1], -ext[n][2], ext[n][3]))
                                 for n in split])
                dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.world.tensor_group)
                ext.update({n: (-r[0], r[1], -r[2], r[3]) for n, r in zip(split, v)})
            for n, (da_mn, da_mx, dg_mn, dg_mx) in ext.items():
                # the eigenvalues of G ⊗ A are products of the factors'
                # (floored ≥ 0); λ on both ends of a condition number bounds
                # it as the damped solve does
                mins.append(dg_mn * da_mn)
                maxs.append(dg_mx * da_mx)
                layer_cond[n] = {
                    "cond_A": (da_mx + lam) / (da_mn + lam),
                    "cond_G": (dg_mx + lam) / (dg_mn + lam),
                }
            min_eig = torch.min(torch.stack(mins)) + lam
            max_eig = torch.max(torch.stack(maxs)) + lam
        sq_g = sq_v = dot = torch.zeros((), dtype=torch.float32, device=self.device)
        for name, v in updates.items():
            if name in self.split_layers:
                continue
            g, v = gmats[name].float(), v.float()
            sq_g = sq_g + torch.sum(g * g)
            sq_v = sq_v + torch.sum(v * v)
            dot = dot + torch.sum(v * g)
        if self.split_layers:
            # the split layers' local blocks, summed over the tensor slots
            part = torch.zeros(3, dtype=torch.float32, device=self.device)
            for name in self.split_layers:
                g, v = gmats[name].float(), updates[name].float()
                part = part + torch.stack((torch.sum(g * g), torch.sum(v * v), torch.sum(v * g)))
            self.world.tensor_sum_(part)
            sq_g, sq_v, dot = sq_g + part[0], sq_v + part[1], dot + part[2]
        grad_norm, upd_norm = torch.sqrt(sq_g), torch.sqrt(sq_v)
        cos = dot / torch.clamp(grad_norm * upd_norm, min=1e-30)
        return {
            "nu": nu,
            "min_damped_eig": min_eig,
            "max_damped_eig": max_eig,
            "grad_norm": grad_norm,
            "update_norm": nu * upd_norm,
            "update_grad_cos": cos,
            # steps since the curvature (eigenbasis or inverses) was recomputed
            "eigen_stale_steps": (
                torch.zeros_like(prev["eigen_stale_steps"]) if update_eigen
                else prev["eigen_stale_steps"] + 1
            ),
            "layer_cond": layer_cond,
        }
