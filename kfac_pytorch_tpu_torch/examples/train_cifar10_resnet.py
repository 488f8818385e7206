"""CIFAR-10 ResNet training with K-FAC on one GPU or data-parallel (PyTorch port).

Twin of the JAX package's ``examples/train_cifar10_resnet.py``: the same
flags with the same defaults, the same data choice, the same K-FAC gating
(``--kfac-update-freq 0`` is plain SGD). It trains on
CIFAR-10 from ``--data-dir`` (a ``cifar-10-batches-py`` directory or its
parent), on the learnable stand-in ``synthetic_cifar_like`` when no data is
found there (a data choice it prints, not a device fallback), or on pure
noise with ``--synthetic``; with data it evaluates the whole test split
after each epoch. ``--checkpoint-dir`` saves ``checkpoint-<epoch>`` after
each epoch and resumes from the newest one; ``--log-dir`` writes
``scalars.jsonl`` (it defaults to none here, ``./logs`` in the JAX
trainer). ``--bf16`` computes the convs and BatchNorm in bfloat16 (float32
master weights, K-FAC state and loss), ``--eigen-dtype bf16`` stores the
eigenvectors in bfloat16, ``--precond-precision`` sets the dense
rotations' matmul precision. Every step's K-FAC flags come from
``scheduler.EigenRefreshCadence``: ``--eigh-chunks`` pipelines the
refresh (``--staleness-budget`` lets its swap slip), ``--solver rsvd`` or
``streaming`` (``--solver-rank``, ``--solver-auto-threshold``,
``--stream-drift-threshold``) truncates the wide factor sides.
``--preempt-save-dir`` turns on the elastic runtime (``elastic/``): a
SIGTERM takes an emergency snapshot and stops, ``--snapshot-every N``
also snapshots every N steps, a restart resumes from the newest complete
snapshot at its step (the resumed epoch skips the batches already
trained, so the data order is kept), and ``KFAC_FAULT_KILL_AT_STEP`` /
``KFAC_FAULT_KILL_MODE`` inject a kill.
``--telemetry-dir`` turns on the telemetry registry (step and phase spans,
the K-FAC gauges; ``observability/``) and writes ``metrics.prom`` and
``telemetry.jsonl`` there each epoch, with a summary table at the end;
``--profile-epoch N`` writes a ``torch.profiler`` Chrome trace of epoch N
into ``--log-dir``; ``--profile`` resolves the K-FAC levers left at their
defaults from a planner profile (``planner/``) and ``--autotune-steps``
times its candidate plans before training and keeps the fastest. The training batches come from the native
threaded loader (``runtime/loader.py``, ``--num-workers`` threads, 4 by
default, as in the JAX trainer) or, with ``--num-workers 0``, from the
numpy pipeline. ``--service-devices N`` takes the refresh out of the
training step (``service/``): of the ``torchrun`` world's ranks the
trailing N become curvature workers, the first of which serves the
factor snapshots that training rank 0 publishes at each boundary through a
``HostMailbox`` pair in a temporary directory (so every rank must run on
one machine), and the leading ranks train, installing each published basis
within ``--staleness-budget`` steps (``history["service"]``).

Data-parallel, one process per GPU under ``torchrun`` (NCCL; gloo with
``--device cpu``): ``--batch-size`` is per device, the learning rate is
``--base-lr`` times the world size (with the warmup of
``create_lr_schedule(world, ...)``), each rank trains on its interleaved
shard of every epoch, K-FAC runs the reference's distributed algorithm
(``--distribute-precondition``, ``--distribute-layer-factors``,
``--precond-comm-dtype``), its factor statistics cross the wire through
the factor comm plane (``--factor-comm-dtype f32|bf16|int8``,
``--factor-comm-freq``), ``--grad-comm-dtype bf16`` compresses the
gradient mean (and BatchNorm normalizes per rank, as in the JAX trainer),
rank 0 prints, logs and writes checkpoints, and every rank starts from
rank 0's state.
``--init-from-torch`` starts from a reference CIFAR ResNet checkpoint's
weights (``interop.init_from_torch_checkpoint``).

On a CUDA device outside any process group the train step runs as CUDA
graphs, one captured per step variant and replayed
(``training.graphs.GraphedTrainStep``, the JAX trainer's jitted step);
the configurations of :func:`eager_step_reason` run the eager step, which
it names once. ``compile_cache.RecompileMonitor`` holds the captured
graphs to ``compile_cache.expected_step_variants`` and warns each epoch
of any beyond it, as the JAX trainer does of its recompiles.

    python -m kfac_pytorch_tpu_torch.examples.train_cifar10_resnet \\
        --data-dir /path/to/cifar-10-batches-py --model resnet32 --epochs 100
    python -m kfac_pytorch_tpu_torch.examples.train_cifar10_resnet \\
        --synthetic --model resnet32 --epochs 1 --steps-per-epoch 30
    torchrun --nproc-per-node 4 -m kfac_pytorch_tpu_torch.examples.train_cifar10_resnet \\
        --data-dir /path/to/cifar-10-batches-py --distribute-precondition

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the history: per step the loss,
the step kind (``training.step.step_kind``), the wall milliseconds around
a synchronized step and each ``kfac_*`` metric (the diagnostics with
``--kfac-diagnostics``, the truncated solvers' gauges); per epoch the
validation loss, accuracy and sample count, the milliseconds of the
full-split evaluation (after any BatchNorm recalibration) and of the
checkpoint save; the restore milliseconds of a resume; with
``--preempt-save-dir`` the snapshots' blocking and write milliseconds
(``elastic``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import (
    EigenRefreshCadence,
    KFAC,
    KFACParamScheduler,
    capture,
    elastic,
    interop,
    observability,
    planner,
)
from kfac_pytorch_tpu_torch.compile_cache import RecompileMonitor
from kfac_pytorch_tpu_torch.device import use_ieee_f32
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import (
    World,
    data_parallel_world,
    put_global_batch,
    service_world,
)
from kfac_pytorch_tpu_torch.examples.autotune import autotune_kfac
from kfac_pytorch_tpu_torch.runtime import NativeEpochLoader
from kfac_pytorch_tpu_torch.service import CurvatureService, CurvatureWorker, HostMailbox
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training import data as data_lib
from kfac_pytorch_tpu_torch.training import profiling
from kfac_pytorch_tpu_torch.training.evaluation import evaluate_split
from kfac_pytorch_tpu_torch.training.graphs import (
    GraphedTrainStep,
    compiled_record,
    compiled_step,
    eager_step_reason,
)
from kfac_pytorch_tpu_torch.training.metrics import Metric, ScalarWriter
from kfac_pytorch_tpu_torch.training.schedules import create_lr_schedule
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    make_bn_recal_step,
    make_masked_eval_step,
    make_sgd,
    make_train_step,
    step_kind,
)

NUM_CLASSES = 10

# per-step K-FAC health keys beyond ν and the min damped eigenvalue that
# --kfac-diagnostics reduces to per-epoch means (the JAX trainer's)
DIAG_EXTRA_KEYS = (
    "kfac_max_damped_eig",
    "kfac_cond_max",
    "kfac_grad_norm",
    "kfac_update_norm",
    "kfac_update_grad_cos",
    "kfac_eigen_stale_steps",
)

# how long a --service-devices worker rank waits for the next factor
# snapshot before it calls the trainers dead (an evaluation or a checkpoint
# runs between two boundaries)
SERVICE_IDLE_TIMEOUT_S = 3600.0

# the stand-in's flags (flag, type, default, help); set next to real data
# they are refused
_SYNTH_FLAGS = (
    ("--synth-classes", int, 10, "stand-in class count (also sizes the model head)"),
    ("--synth-prototypes", int, 10, "stand-in prototypes per class"),
    ("--synth-noise", float, 0.55, "stand-in additive pixel noise sigma"),
    ("--synth-label-noise", float, 0.08, "stand-in TRAIN label flip fraction"),
    ("--synth-val-label-noise", float, 0.0,
     "stand-in VAL label flip fraction f (a hard accuracy ceiling of 1-f)"),
)


def add_precision_flags(p: argparse.ArgumentParser) -> None:
    """The JAX image trainers' precision flags: ``--precond-precision``,
    ``--eigen-dtype`` and ``--bf16``."""
    p.add_argument("--precond-precision", default=None,
                   choices=["default", "high", "highest"],
                   help="matmul precision of the dense eigenbasis rotations "
                        "(default: one TF32 pass on the GPU; high, highest: "
                        "IEEE float32); None = IEEE float32; the fused apply "
                        "kernel ignores it")
    p.add_argument("--eigen-dtype", default="f32", choices=["f32", "bf16"],
                   help="storage dtype of the eigenvector matrices (bf16 "
                        "halves the fused apply's largest input stream)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/BatchNorm compute (params, K-FAC factor "
                        "math and the loss stay float32)")


def precision_kwargs(args) -> Dict[str, object]:
    """``KFAC`` keyword arguments of :func:`add_precision_flags`' flags."""
    return {
        "eigen_dtype": torch.bfloat16 if args.eigen_dtype == "bf16" else torch.float32,
        "precond_precision": args.precond_precision,
    }


def add_refresh_flags(p: argparse.ArgumentParser) -> None:
    """The JAX trainers' refresh-scheduling and solver flags:
    ``--eigh-chunks``, ``--solver``, ``--solver-rank``,
    ``--solver-auto-threshold``, ``--stream-drift-threshold``,
    ``--staleness-budget`` and ``--service-devices``."""
    p.add_argument("--eigh-chunks", type=int, default=1,
                   help="pipeline the eigen refresh over this many steps "
                        "after each --kfac-update-freq boundary (double-"
                        "buffered basis, swapped when all chunks land); 1 = "
                        "monolithic refresh, bit-exact")
    p.add_argument("--solver", default="eigh",
                   choices=["eigh", "rsvd", "streaming"],
                   help="curvature eigensolver: eigh = full (dense) "
                        "eigendecomposition, rsvd = randomized truncated "
                        "eigensolve + low-rank Woodbury apply for factor "
                        "sides >= --solver-auto-threshold, streaming = rsvd "
                        "layout with per-step matmul-only folds and "
                        "drift-gated re-orthonormalization")
    p.add_argument("--solver-rank", type=int, default=128,
                   help="eigenpairs kept per truncated factor side "
                        "(--solver rsvd); watch kfac_spectrum_mass to size it")
    p.add_argument("--solver-auto-threshold", type=int, default=512,
                   help="factor sides at least this large use the truncated "
                        "solver; smaller sides stay dense (--solver rsvd)")
    p.add_argument("--stream-drift-threshold", type=float, default=0.05,
                   help="--solver streaming: re-orthonormalize at a refresh "
                        "boundary only when the residual-mass drift gauge "
                        "(kfac_stream_residual) exceeds this; 0 = re-orth "
                        "every boundary, exactly periodic rsvd")
    p.add_argument("--staleness-budget", type=int, default=0,
                   help="let a deferred factor flush or a completed pending "
                        "eigen swap slip up to this many steps under "
                        "measured comm/compute pressure (needs "
                        "--factor-comm-freq > 1, --eigh-chunks > 1 or "
                        "--service-devices > 0; 0 = never slip; watch the "
                        "kfac/staleness_* gauges)")
    p.add_argument("--service-devices", type=int, default=0,
                   help="carve this many devices out of the mesh as "
                        "dedicated curvature workers (kfac_pytorch_tpu_torch/"
                        "service/): the eigen refresh leaves the training "
                        "step entirely — factor snapshots publish at each "
                        "--kfac-update-freq boundary, refreshed bases "
                        "install between steps, --staleness-budget bounds "
                        "the install slip (docs/SERVICE.md); 0 = inline "
                        "refresh")


def refresh_kwargs(args) -> Dict[str, object]:
    """``KFAC`` keyword arguments of :func:`add_refresh_flags`' flags."""
    return {
        "service_devices": args.service_devices,
        "eigh_chunks": args.eigh_chunks,
        "solver": args.solver,
        "solver_rank": args.solver_rank,
        "solver_auto_threshold": args.solver_auto_threshold,
        "stream_drift_threshold": args.stream_drift_threshold,
        "staleness_budget": args.staleness_budget,
    }


def refresh_cadence(kfac, live_state) -> EigenRefreshCadence:
    """The refresh cadence the twins drive every step through (at
    ``--eigh-chunks 1`` its flags are ``kfac_flags_for_step``'s). Under
    ``--solver streaming`` the drift signal reads ``live_state()``'s
    ``stream_residual``: one host read per ``--kfac-update-freq``
    boundary, as in the JAX trainers."""
    if kfac is not None and kfac.solver == "streaming":
        kfac.stream_drift_signal = lambda: float(live_state().kfac_state["stream_residual"])
    return EigenRefreshCadence(kfac)


class ServiceCarve(NamedTuple):
    """The world a twin trains on under ``--service-devices N``
    (:func:`carve_service_world`): ``world`` is the training ranks' (or on
    a worker rank the workers'), ``worker`` this rank's role and
    ``mailbox_dir`` the ``HostMailbox`` root every rank shares."""

    world: World
    worker: bool = False
    mailbox_dir: Optional[str] = None


def carve_service_world(args) -> ServiceCarve:
    """``--service-devices N``: the trailing N ranks of the default group
    become curvature workers and the leading ones the training world
    (``parallel.mesh.service_world``; refused, in the JAX words, when no
    rank is left to train). Rank 0 makes the mailbox directory (under the
    temporary directory: every rank must see it, so one machine) and
    every rank learns it; the launch helpers then answer for this rank's
    side. Without the flag, the default group's world."""
    if args.service_devices <= 0:
        return ServiceCarve(data_parallel_world())
    carved, workers = service_world(args.service_devices)
    root = [tempfile.mkdtemp(prefix="kfac-service-") if launch.rank() == 0 else None]
    dist.broadcast_object_list(root, src=0)
    worker = launch.rank() in workers
    launch.set_world_group(carved.group)
    return ServiceCarve(carved, worker, root[0])


def serve_curvature(kfac, carve: ServiceCarve, device: torch.device) -> Dict[str, List]:
    """A worker rank's run: the first worker serves the training job's
    mailboxes (``CurvatureWorker.serve``) until the trainers close them,
    then removes the mailbox directory; any further worker stays idle, as
    the JAX service uses only its first worker device. Returns the
    history: no losses, and the refreshes served."""
    history: Dict[str, List] = {"loss": [], "refresh_ms": []}
    if kfac is not None and carve.world.rank == 0:
        worker = CurvatureWorker(kfac, HostMailbox(carve.mailbox_dir, "job0-factors"),
                                 HostMailbox(carve.mailbox_dir, "job0-basis"), device=device)
        worker.serve(idle_timeout_s=SERVICE_IDLE_TIMEOUT_S)
        history["refresh_ms"] = worker.refresh_ms
        shutil.rmtree(carve.mailbox_dir, ignore_errors=True)
    launch.set_world_group(None)
    return history


def curvature_service(args, kfac, cadence, sup, carve: ServiceCarve):
    """The trainer side of ``--service-devices`` (None without it): a
    ``CurvatureService`` on the carve's mailboxes, its worker in the worker
    rank."""
    if kfac is None or args.service_devices <= 0:
        return None
    svc = CurvatureService(kfac, cadence, worker_devices=range(args.service_devices),
                           supervisor=sup, mailbox_dir=carve.mailbox_dir, run_worker=False)
    rank0_print(f"curvature service: {args.service_devices} worker device(s), "
                f"staleness budget {svc.staleness_budget}")
    return svc


def service_record(svc) -> Dict[str, List]:
    """The history's record of the service: each install's ``(version,
    step, slip)`` and milliseconds, each publish's milliseconds and each
    wait at the staleness deadline. Closes the service (the worker stops
    once every published snapshot is served) and hands the launch helpers
    back the default group."""
    svc.close()
    launch.set_world_group(None)
    return dict(svc.record)


def add_elastic_flags(p: argparse.ArgumentParser) -> None:
    """The JAX trainers' ``--preempt-save-dir`` and ``--snapshot-every``."""
    p.add_argument("--preempt-save-dir", default=None,
                   help="elastic snapshot dir: SIGTERM takes an emergency "
                        "snapshot and a restart scan-resumes the newest one "
                        "(docs/ELASTIC.md)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="elastic: also snapshot every N steps "
                        "(needs --preempt-save-dir; 0 = emergency-only)")


def elastic_supervisor(args, kfac, cadence, steps_per_epoch: int):
    """The ``--preempt-save-dir`` supervisor (None without the flag), as the
    JAX trainers build it: snapshots every ``--snapshot-every`` steps,
    heartbeats as often (else once an epoch), the environment's fault
    injector (``KFAC_FAULT_*``), the SIGTERM handler installed."""
    if not args.preempt_save_dir:
        return None
    sup = elastic.Supervisor(
        args.preempt_save_dir, snapshot_every=args.snapshot_every, kfac=kfac, cadence=cadence,
        heartbeat_every=max(1, args.snapshot_every or steps_per_epoch),
        fault_injector=elastic.maybe_injector(),
    )
    sup.install_signal_handlers()
    return sup


def elastic_record(sup) -> Dict[str, List[float]]:
    """The history's record of a run's snapshots: the blocking and the
    write milliseconds of each."""
    return {"snapshot_ms": list(sup.snapshot_durations_ms),
            "write_ms": list(sup.write_durations_ms)}


def add_telemetry_flags(p: argparse.ArgumentParser) -> None:
    """The JAX trainers' ``--profile-epoch`` and ``--telemetry-dir``."""
    p.add_argument("--profile-epoch", type=int, default=None,
                   help="capture a torch.profiler trace of this epoch into "
                        "--log-dir (profile_trace.json, Chrome format)")
    p.add_argument("--telemetry-dir", default=None,
                   help="enable structured telemetry and write metrics.prom "
                        "(Prometheus textfile) + telemetry.jsonl there each "
                        "epoch: per-phase span timings and the K-FAC gauges "
                        "(docs/OBSERVABILITY.md)")


def add_planner_flags(p: argparse.ArgumentParser, autotune: bool = True) -> None:
    """The JAX trainers' ``--profile`` and (``autotune``) ``--autotune-steps``."""
    p.add_argument("--profile", default=None, choices=["safe", "memory", "production"],
                   help="resolve the K-FAC perf levers from a named planner "
                        "profile (planner/cost_model.py) using this model's "
                        "factor shapes and the world; explicit lever flags "
                        "win over the profile's choices (docs/PLANNER.md)")
    if autotune:
        p.add_argument("--autotune-steps", type=int, default=0,
                       help="time the resolved plan against its conservative "
                            "fallbacks for this many warmup steps each and pin "
                            "the winner (0 = trust the cost model; needs "
                            "--profile; docs/PLANNER.md)")


def step_span(tel, flags):
    """The step's span, by the kind of step its flags make."""
    if flags.get("eigen_chunk") is not None:
        return tel.span("step/eigen_chunk")
    if not flags.get("update_factors"):
        return tel.span("step/plain")
    if flags.get("update_eigen"):
        return tel.span("step/eigen")
    return tel.span("step/factors")


class RunTelemetry:
    """A trainer's telemetry (``--telemetry-dir``): the process registry,
    enabled and emptied for the run (span syncs off under
    ``--comm-overlap``, whose side stream a synchronize would serialize);
    ``telemetry.jsonl`` and ``metrics.prom`` in the directory, from rank 0;
    the per-epoch phase gauges and export; the end-of-run summary table,
    which every rank computes (a collective over several)."""

    def __init__(self, telemetry_dir: Optional[str], comm_overlap: bool = False):
        self.dir = telemetry_dir
        self.tel = observability.configure(enabled=bool(telemetry_dir),
                                           block_spans=not comm_overlap)
        if self.tel.enabled:
            self.tel.reset()
        self.writer = ScalarWriter(telemetry_dir if self.tel.enabled and launch.is_primary()
                                   else None, filename="telemetry.jsonl")

    def note_metrics(self, values: Dict[str, float]) -> None:
        """Gauges of a step's host-read metrics."""
        if "kfac_spectrum_mass" in values:
            self.tel.set_gauge("kfac/spectrum_mass_captured", values["kfac_spectrum_mass"])

    def end_epoch(self, epoch: int) -> None:
        """The per-phase costs from the step kinds' p50 deltas, then the
        Prometheus file and the JSONL records of the epoch."""
        tel = self.tel
        if not tel.enabled:
            return
        p_plain = tel.percentiles("step/plain")
        p_fac = tel.percentiles("step/factors")
        p_eig = tel.percentiles("step/eigen")
        p_h2d = tel.percentiles("comm/host_to_device")
        if p_plain and p_fac:
            tel.set_gauge("phase/factor_ms", max(0.0, (p_fac[0] - p_plain[0]) * 1e3))
        if p_fac and p_eig:
            tel.set_gauge("phase/eigh_ms", max(0.0, (p_eig[0] - p_fac[0]) * 1e3))
        if p_h2d:
            tel.set_gauge("phase/comm_ms", p_h2d[0] * 1e3)
        if launch.is_primary():
            observability.write_prometheus(os.path.join(self.dir, "metrics.prom"), tel)
        observability.flush_jsonl(self.writer, tel, epoch)

    def close(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Print the summary table (rank 0) and close the stream; returns
        the final snapshot, or ``None`` with telemetry off."""
        self.writer.close()
        if not self.tel.enabled:
            return None
        table = observability.summary_table(self.tel)
        rank0_print("telemetry summary:")
        rank0_print(table)
        return self.tel.snapshot()


def plan_record(kfac, report) -> Dict[str, object]:
    """The history's record of a resolved plan and its autotune."""
    out = {"plan": kfac.plan.to_dict(), "dropped": list(kfac.plan_dropped),
           "non_default_levers": list(kfac.plan.non_default_levers())}
    if report is not None:
        out["autotune"] = {"candidates": [c.to_dict() for c in report.candidates],
                           "seconds": list(report.timings_s),
                           "winner_index": report.winner_index}
    return out


def add_parallel_flags(p: argparse.ArgumentParser) -> None:
    """The JAX image trainers' data-parallel and loader flags."""
    p.add_argument("--num-workers", type=int, default=4,
                   help="native loader threads (0 = the single-threaded numpy "
                        "pipeline; pytorch_cifar10_resnet.py:118)")
    p.add_argument("--distribute-precondition", action="store_true",
                   help="shard the every-step eigenbasis rotations across "
                        "the ranks (one owner per layer + one all_reduce)")
    p.add_argument("--distribute-layer-factors", type=lambda s: s.lower() == "true",
                   default=None, nargs="?",
                   help="decompose A and G of a layer on different ranks "
                        "(default: when there are more ranks than layers)")
    p.add_argument("--precond-comm-dtype", default=None, choices=[None, "bf16"],
                   help="downcast the distributed-precondition exchange")
    p.add_argument("--grad-comm-dtype", default=None, choices=[None, "bf16"],
                   help="downcast the data-parallel gradient mean on the wire "
                        "(BatchNorm then normalizes per rank); None = float32")


def add_factor_comm_flags(p: argparse.ArgumentParser) -> None:
    """The JAX trainers' factor comm plane flags: ``--factor-comm-dtype``
    and ``--factor-comm-freq``."""
    p.add_argument("--factor-comm-dtype", default="f32", choices=["f32", "bf16", "int8"],
                   help="wire dtype of the bucketed K-FAC factor-statistics "
                        "exchange (parallel/comm.py); int8 = block-scaled "
                        "codes + error feedback at 0.51x the bf16 bytes "
                        "(requires --factor-comm-freq > 1)")
    p.add_argument("--factor-comm-freq", type=int, default=1,
                   help="all-reduce factor statistics every N capture steps "
                        "instead of every one (merged running averages, "
                        "always flushed before an eigen refresh); 1 = "
                        "per-step exchange, exact")


def add_owner_flags(p: argparse.ArgumentParser, sharding_help: str, overlap_help: str) -> None:
    """The JAX trainers' ``--factor-sharding`` and ``--comm-overlap``, each
    twin with its JAX trainer's help."""
    p.add_argument("--factor-sharding", default="replicated", choices=["replicated", "owner"],
                   help=sharding_help)
    p.add_argument("--comm-overlap", action="store_true", help=overlap_help)


def factor_comm_kwargs(args) -> Dict[str, object]:
    """``KFAC`` keyword arguments of :func:`add_factor_comm_flags`' and
    :func:`add_owner_flags`' flags."""
    return {"factor_comm_dtype": args.factor_comm_dtype,
            "factor_comm_freq": args.factor_comm_freq,
            "factor_sharding": args.factor_sharding,
            "comm_overlap": args.comm_overlap}


def parallel_kwargs(args) -> Dict[str, object]:
    """``KFAC`` keyword arguments of :func:`add_parallel_flags`' flags."""
    return {
        "distribute_layer_factors": args.distribute_layer_factors,
        "distribute_precondition": args.distribute_precondition,
        "precond_comm_dtype": torch.bfloat16 if args.precond_comm_dtype == "bf16" else None,
    }


def grad_comm_dtype(args) -> Optional[torch.dtype]:
    return torch.bfloat16 if args.grad_comm_dtype == "bf16" else None


def rank0_print(*values) -> None:
    """``print`` on rank 0 only (the reference's ``hvd.rank() == 0`` logs)."""
    if launch.is_primary():
        print(*values)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="CIFAR-10 K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--data-dir", default=None, help="CIFAR-10 data dir")
    p.add_argument("--synthetic", action="store_true", help="use synthetic data")
    for flag, kind, default, text in _SYNTH_FLAGS:
        p.add_argument(flag, type=kind, default=default, help=text)
    p.add_argument("--log-dir", default=None, help="scalars.jsonl (+ TensorBoard) dir")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (enables save/resume)")
    add_elastic_flags(p)
    p.add_argument("--model", default="resnet32", help="cifar resnet variant")
    p.add_argument("--batch-size", type=int, default=128, help="per-device train batch size")
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step")
    p.add_argument("--stats-all-microbatches", action="store_true",
                   help="capture K-FAC statistics on every accumulation "
                        "microbatch and average them (else the last one's)")
    p.add_argument("--val-batch-size", type=int, default=128, help="per-device val batch size")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps-per-epoch", type=int, default=None, help="cap steps (synthetic/smoke)")
    p.add_argument("--base-lr", type=float, default=0.1, help="per-device lr (scaled by world)")
    p.add_argument("--lr-decay", nargs="+", type=int, default=[35, 75, 90])
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--kfac-update-freq", type=int, default=10, help="0 disables K-FAC")
    p.add_argument("--kfac-cov-update-freq", type=int, default=1)
    p.add_argument("--stat-decay", type=float, default=0.95)
    p.add_argument("--damping", type=float, default=0.003)
    p.add_argument("--damping-alpha", type=float, default=0.5)
    p.add_argument("--damping-schedule", nargs="+", type=int, default=[40, 80])
    p.add_argument("--kl-clip", type=float, default=0.001)
    p.add_argument("--diag-blocks", type=int, default=1)
    p.add_argument("--diag-warmup", type=int, default=0)
    p.add_argument("--kfac-update-freq-alpha", type=float, default=10)
    p.add_argument("--kfac-update-freq-schedule", nargs="+", type=int, default=None)
    p.add_argument("--init-from-torch", default=None,
                   help="initialize model weights from a reference CIFAR "
                        "ResNet checkpoint (.pth/.pth.tar); optimizer and "
                        "K-FAC state start fresh")
    p.add_argument("--precond-method", default="eigen", choices=["eigen", "inverse"],
                   help="eigen: eigenbasis solve (damping fresh every step); "
                        "inverse: pi-corrected factored damping + Cholesky "
                        "inverses (the dense apply: no fused apply kernel)")
    p.add_argument("--factor-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="conv A-factor statistics: kernel = the CUDA patch-"
                        "covariance kernel, dense = im2col oracle, auto = the "
                        "kernel on CUDA tensors, its plain version on CPU ones")
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    add_precision_flags(p)
    add_refresh_flags(p)
    add_parallel_flags(p)
    add_factor_comm_flags(p)
    add_owner_flags(
        p,
        "owner: DP-KFAC owner-sharded curvature — factor "
                         "stats reduce-scatter onto each layer's eigen-owner, "
                         "eigen bases live only there, and ONE allgather "
                         "replicates the preconditioned grads; factor+eigen "
                         "memory and wire scale O(model/devices) "
                         "(docs/PERF.md); replicated = exact prior behavior",
        "fuse the factor-statistics reduction into the "
                         "gradient stream: the bucketed factor psums issue "
                         "before the gradient pmean so the collectives "
                         "interleave with backprop instead of queuing after "
                         "it (multi-device mesh only; bitwise-identical "
                         "numerics; docs/PERF.md)",
    )
    p.add_argument("--kfac-diagnostics", action="store_true",
                   help="log per-epoch K-FAC stability diagnostics (nu, "
                        "damped eigenvalues, condition numbers, update/grad "
                        "cosine, staleness)")
    p.add_argument("--bn-recal-batches", type=int, default=0,
                   help="refresh BatchNorm running statistics with this many "
                        "train-mode forwards before each evaluation")
    add_telemetry_flags(p)
    add_planner_flags(p)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.batches_per_allreduce < 1:
        raise SystemExit("--batches-per-allreduce must be at least 1")
    if args.num_workers < 0:
        raise SystemExit("--num-workers must be at least 0")
    return args


def build(args, device: torch.device, world: World = World(), profile=None):
    """``(model, kfac, state, train_step)`` for parsed ``args`` on
    ``device`` over ``world``; ``kfac`` is ``None`` at
    ``--kfac-update-freq 0``. ``profile`` (default ``--profile``) is the
    planner profile name or ``Plan`` the K-FAC levers left at their
    defaults are filled from, the model's own factor shapes its facts."""
    profile = args.profile if profile is None else profile
    model = cifar_resnet.get_model(
        args.model, num_classes=args.synth_classes,
        generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.bfloat16 if args.bf16 else None,
    ).to(device)
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    kfac = None
    if args.kfac_update_freq > 0:
        kfac = KFAC(
            layers=capture.discover_layers(model),
            lr=args.base_lr * world.size,
            factor_decay=args.stat_decay,
            damping=args.damping,
            kl_clip=args.kl_clip,
            fac_update_freq=args.kfac_cov_update_freq,
            kfac_update_freq=args.kfac_update_freq,
            diag_blocks=args.diag_blocks,
            diag_warmup=args.diag_warmup,
            precond_method=args.precond_method,
            track_diagnostics=args.kfac_diagnostics,
            **precision_kwargs(args),
            **refresh_kwargs(args),
            **parallel_kwargs(args),
            **factor_comm_kwargs(args),
            factor_kernel=args.factor_kernel,
            apply_kernel=args.apply_kernel,
            profile=profile,
            profile_shapes=model if profile is not None else None,
            device=device,
            process_group=world.group,
        )
    state = TrainState(
        step=0,
        model=model,
        opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=kfac.init(model) if kfac else None,
    )
    train_step = make_train_step(
        model, tx, kfac,
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
        label_smoothing=args.label_smoothing,
        accum_steps=args.batches_per_allreduce,
        stats_all_microbatches=args.stats_all_microbatches,
        world=world,
        grad_comm_dtype=grad_comm_dtype(args),
    )
    return model, kfac, state, train_step


def load_data(args):
    """``(train, val, source)``: CIFAR-10 from ``--data-dir``, else (without
    ``--synthetic``) the learnable stand-in, else ``(None, None, ...)`` for
    the synthetic noise batches."""
    cifar_dir = None if args.synthetic else data_lib.find_cifar10(args.data_dir)
    overrides = [flag for flag, _, default, _ in _SYNTH_FLAGS
                 if getattr(args, flag[2:].replace("-", "_")) != default]
    if cifar_dir and overrides:
        raise SystemExit(
            f"{'/'.join(overrides)} only apply to the learnable stand-in, but "
            "real CIFAR-10 (10 classes) was found on disk — the flags would be "
            "silently ignored; drop them or the data"
        )
    if cifar_dir:
        return (data_lib.load_cifar10(cifar_dir, train=True),
                data_lib.load_cifar10(cifar_dir, train=False),
                f"CIFAR-10 from {cifar_dir}")
    if args.synthetic:
        return None, None, "synthetic noise batches"
    train, val = data_lib.synthetic_cifar_like(
        num_classes=args.synth_classes,
        prototypes_per_class=args.synth_prototypes,
        noise=args.synth_noise,
        label_noise=args.synth_label_noise,
        val_label_noise=args.synth_val_label_noise,
        seed=args.seed,
    )
    where = f" in {args.data_dir}" if args.data_dir else " (no --data-dir)"
    return train, val, f"synthetic-learnable stand-in: no CIFAR-10 found{where}"


def evaluate(eval_step, state, x_val, y_val, batch_size, device, world: World = World()):
    """Masked sums over the whole split (each rank its shard of
    ``batch_size`` batches), read once: ``(loss, accuracy, count)``."""
    loss_sum, correct, count = evaluate_split(
        eval_step, state,
        data_lib.eval_batches(x_val, y_val, batch_size,
                              num_shards=world.size, shard_index=world.rank),
        device, world,
    )
    return loss_sum / count, correct / count, count


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    # before any span fires
    run_tel = RunTelemetry(args.telemetry_dir, args.comm_overlap)
    tel = run_tel.tel
    device = launch.initialize(args.device)
    use_ieee_f32()
    carve = carve_service_world(args)
    world = carve.world
    if carve.worker:
        return serve_curvature(build(args, device, world)[1], carve, device)
    accum = args.batches_per_allreduce
    global_bs = args.batch_size * world.size
    rank0_print(f"devices={world.size} global_batch={global_bs}"
                + (f" x{accum} accum" if accum > 1 else ""))
    train, val, source = load_data(args)
    x_train, y_train = train or (None, None)
    x_val, y_val = val or (None, None)
    model, kfac, state, train_step = build(args, device, world)
    plan_info = None
    if kfac is not None and kfac.plan is not None:
        rank0_print(kfac.plan.describe() + (
            f" (dropped: {', '.join(kfac.plan_dropped)})" if kfac.plan_dropped else ""))
        xw, yw = next(data_lib.synthetic_batches(
            args.batch_size * accum, (3, 32, 32), args.synth_classes, 1, seed=args.seed))
        winner, report = autotune_kfac(
            kfac, lambda plan: build(args, device, world, profile=plan)[1:],
            put_global_batch((xw, yw), device, accum), args.base_lr * world.size,
            args.autotune_steps, device, broadcast=launch.broadcast_host_value,
            log=rank0_print)
        if winner is not None and winner != kfac.plan:
            model, kfac, state, train_step = build(args, device, world, profile=winner)
        # the candidates' builds published their own plans' gauges
        planner.log_plan(kfac.plan, kfac.plan_dropped)
        plan_info = plan_record(kfac, report)
    if args.init_from_torch:
        interop.init_from_torch_checkpoint(args.init_from_torch, model, args.model)
        rank0_print(f"initialized weights from torch checkpoint {args.init_from_torch}")
    kfac_sched = None
    if kfac is not None:
        kfac_sched = KFACParamScheduler(
            kfac,
            damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_schedule,
            update_freq_alpha=args.kfac_update_freq_alpha,
            update_freq_schedule=args.kfac_update_freq_schedule,
        )
    history: Dict[str, List] = {
        "loss": [], "kind": [], "step_ms": [], "val_loss": [], "val_accuracy": [],
        "val_count": [], "eval_ms": [], "checkpoint_ms": [], "restore_ms": [],
    }
    if plan_info is not None:
        history["plan"] = plan_info
    # owner-sharded curvature is this rank's rows (a restored checkpoint
    # is re-homed the same way, in auto_resume)
    state.kfac_state = ckpt.rehome_kfac_state(kfac, state.kfac_state)
    resume_from_epoch = 0
    if args.checkpoint_dir:
        t0 = time.perf_counter()
        state, resume_from_epoch = ckpt.auto_resume(args.checkpoint_dir, state, kfac)
        if resume_from_epoch and args.init_from_torch:
            raise SystemExit(
                f"--init-from-torch was given but {args.checkpoint_dir} "
                f"holds an epoch-{resume_from_epoch - 1} checkpoint that "
                "auto-resume just restored over the migrated weights; use a "
                "fresh --checkpoint-dir or drop --init-from-torch"
            )
        if resume_from_epoch:
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            if kfac_sched:
                kfac_sched.epoch = resume_from_epoch
            rank0_print(f"resumed from epoch {resume_from_epoch - 1}")
    # every rank starts from rank 0's state (hvd.broadcast_parameters)
    ckpt.broadcast_state(state, world)
    eval_step = make_masked_eval_step(model, label_smoothing=args.label_smoothing)
    bn_recal = make_bn_recal_step(model, world) if args.bn_recal_batches else None
    train_step, budget = compiled_step(train_step, kfac, device,
                                       eager_step_reason(args, world, device))
    recompiles = RecompileMonitor(tel)
    recompiles.watch("train_step", train_step, budget)
    # eager in this slice: skipped, as the JAX monitor skips a callable
    # that is not jitted
    recompiles.watch("eval_step", eval_step, 1)
    if bn_recal is not None:
        recompiles.watch("bn_recal", bn_recal, 1)
    lr_base = args.base_lr * world.size
    lr_factor = create_lr_schedule(world.size, args.warmup_epochs, args.lr_decay)
    loader = None
    if x_train is not None:
        steps_per_epoch = len(x_train) // (global_bs * accum)
        if args.num_workers > 0:
            # the C++ pipeline reads NHWC; its batches come back NCHW
            loader = NativeEpochLoader(
                np.ascontiguousarray(x_train.transpose(0, 2, 3, 1)), y_train,
                args.batch_size * accum, shuffle=True, augment=True,
                num_shards=world.size, shard_index=world.rank,
                num_workers=args.num_workers,
            )
        pipe = "native" if loader else "numpy"
        rank0_print(f"{source}: {len(x_train)} train / {len(x_val)} val ({pipe} pipeline)")
    else:
        steps_per_epoch = args.steps_per_epoch or 50
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    writer = ScalarWriter(args.log_dir if launch.is_primary() else None)

    step = state.step
    cadence = refresh_cadence(kfac, lambda: state)
    sup, resume_skip, preempted = elastic_supervisor(args, kfac, cadence, steps_per_epoch), 0, False
    if sup is not None:
        t0 = time.perf_counter()
        hit = sup.scan_resume(state)
        if hit is not None:
            state, _, step = hit
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            # the data order is kept: the resumed epoch skips its first batches
            resume_from_epoch, resume_skip = divmod(step, steps_per_epoch)
            if kfac_sched:
                kfac_sched.epoch = resume_from_epoch
            rank0_print(f"elastic: resumed from snapshot at step {step}")
    svc = curvature_service(args, kfac, cadence, sup, carve)
    for epoch in range(resume_from_epoch, args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        if loader is not None:
            batches = loader.epoch(args.seed + epoch)
        elif x_train is not None:
            batches = data_lib.epoch_batches(
                x_train, y_train, args.batch_size * accum, shuffle=True, augment=True,
                seed=args.seed + epoch, num_shards=world.size, shard_index=world.rank,
            )
        else:
            batches = data_lib.synthetic_batches(
                args.batch_size * accum, (3, 32, 32), args.synth_classes,
                steps_per_epoch, seed=args.seed,
            )
        t0 = time.perf_counter()
        loss_m, acc_m = Metric("train/loss"), Metric("train/accuracy")
        diag: Dict[str, List[float]] = {}
        with profiling.maybe_trace(args.log_dir, args.profile_epoch == epoch, device):
            for i, (xb, yb) in enumerate(batches):
                if i >= steps_per_epoch:
                    break
                if epoch == resume_from_epoch and i < resume_skip:
                    continue  # a mid-epoch snapshot's resume: i keeps the step's phase
                lr = lr_base * lr_factor(epoch + i / steps_per_epoch)
                flags = cadence.flags_for_step(step, epoch)
                with tel.span("comm/host_to_device"):
                    images, labels = put_global_batch((xb, yb), device, accum)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                ts = time.perf_counter()
                if svc is not None:
                    # the newest complete basis, waited for only at the
                    # staleness deadline
                    state.kfac_state = svc.before_step(step, state.kfac_state)
                with step_span(tel, flags) as sp:
                    state, metrics = train_step(
                        state, (images, labels), lr,
                        kfac.hparams.damping if kfac else 0.0, **flags,
                    )
                    sp.block(metrics)
                if svc is not None:
                    # a boundary publishes the factors it just folded in
                    svc.after_step(step, state.kfac_state)
                # one read of every scalar the host logs: waits for the step
                with tel.span("comm/device_get"):
                    keys = sorted(metrics)
                    values = dict(zip(keys, torch.stack(
                        [metrics[k].float() for k in keys]).tolist()))
                history["step_ms"].append((time.perf_counter() - ts) * 1e3)
                history["loss"].append(values["loss"])
                history["kind"].append(step_kind(flags))
                loss_m.update(values["loss"])
                acc_m.update(values["accuracy"])
                run_tel.note_metrics(values)
                for k, v in values.items():
                    if k.startswith("kfac_"):
                        diag.setdefault(k, []).append(v)
                        history.setdefault(k, []).append(v)
                step += 1
                if sup is not None and sup.on_step(step, lambda: state):
                    preempted = True
                    break
        if preempted:
            rank0_print(f"elastic: preempted; snapshot at step {step} saved")
            break
        dt = time.perf_counter() - t0
        rank0_print(
            f"epoch {epoch}: loss={loss_m.avg:.4f} acc={acc_m.avg:.4f} lr={lr:.4f} "
            f"{steps_per_epoch * global_bs * accum / dt:.0f} img/s ({dt:.1f}s)"
        )
        writer.add_scalar("train/loss", loss_m.avg, epoch)
        writer.add_scalar("train/accuracy", acc_m.avg, epoch)
        writer.add_scalar("train/lr", lr, epoch)
        if "kfac_nu" in diag:
            nus, eigs = diag["kfac_nu"], diag["kfac_min_damped_eig"]
            writer.add_scalar("kfac/nu_min", min(nus), epoch)
            writer.add_scalar("kfac/nu_mean", sum(nus) / len(nus), epoch)
            writer.add_scalar("kfac/min_damped_eig", min(eigs), epoch)
            means = {k: sum(diag[k]) / len(diag[k]) for k in DIAG_EXTRA_KEYS if k in diag}
            for k, v in means.items():
                writer.add_scalar(f"kfac/{k[5:]}_mean", v, epoch)  # kfac_x -> kfac/x_mean
            rank0_print(f"  kfac: nu_min={min(nus):.4f} nu_mean={sum(nus) / len(nus):.4f} "
                        f"min_damped_eig={min(eigs):.3e}")
            rank0_print(f"  kfac: cond_max={means.get('kfac_cond_max', 0.0):.3e} "
                        f"upd_cos={means.get('kfac_update_grad_cos', 0.0):.3f} "
                        f"stale={means.get('kfac_eigen_stale_steps', 0.0):.1f}")

        if x_val is not None:
            if bn_recal is not None:
                for j, (xb, _) in enumerate(data_lib.epoch_batches(
                    x_train, y_train, args.batch_size, shuffle=True, augment=False,
                    seed=args.seed + 1000 + epoch,
                    num_shards=world.size, shard_index=world.rank,
                )):
                    if j >= args.bn_recal_batches:
                        break
                    state = bn_recal(state, torch.from_numpy(xb).to(device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            te = time.perf_counter()
            val_loss, val_acc, count = evaluate(
                eval_step, state, x_val, y_val, args.val_batch_size, device, world)
            history["eval_ms"].append((time.perf_counter() - te) * 1e3)
            history["val_loss"].append(val_loss)
            history["val_accuracy"].append(val_acc)
            history["val_count"].append(count)
            rank0_print(f"  val: loss={val_loss:.4f} acc={val_acc:.4f}")
            writer.add_scalar("val/loss", val_loss, epoch)
            writer.add_scalar("val/accuracy", val_acc, epoch)

        excess = recompiles.check()
        if excess and launch.is_primary():
            print(f"  WARNING: unexpected recompiles (step graphs over budget): {excess}")
        run_tel.end_epoch(epoch)
        if args.checkpoint_dir:
            tc = time.perf_counter()
            ckpt.save_checkpoint(args.checkpoint_dir, epoch, state, world)
            history["checkpoint_ms"].append((time.perf_counter() - tc) * 1e3)
    if sup is not None:
        sup.wait()  # join any in-flight background snapshot write
        history["elastic"] = elastic_record(sup)
    writer.close()
    snapshot = run_tel.close()
    if snapshot is not None:
        history["telemetry"] = snapshot
    if svc is not None:
        history["service"] = service_record(svc)
    if isinstance(train_step, GraphedTrainStep):
        history["compiled_step"] = compiled_record(train_step, budget)
    if loader is not None:
        loader.close()
    return history


if __name__ == "__main__":
    main()
