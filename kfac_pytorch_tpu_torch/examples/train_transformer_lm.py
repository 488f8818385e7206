"""Transformer-LM training with K-FAC on one GPU or data-parallel (PyTorch port).

Twin of the JAX package's ``examples/train_transformer_lm.py`` on its
data-parallel and data×seq meshes: the same flags with the same defaults
for what the port carries (model widths, SGD with global-norm clipping,
K-FAC with an optional diagonal-A token embedding, the tied head
``--tie-embeddings``, the QKV expand lens ``--qkv-lens``, ``--remat``,
sequence parallelism ``--seq-parallel N --attention ring|ulysses``, the MoE
MLP ``--moe-experts E``, the replicated-compute ``--tensor-parallel
N`` and the 3-D ``--fsdp F --tensor-parallel T``), the same
data (WikiText token files from ``--data-dir``, else the synthetic
corpus), BPTT segments,
K-FAC gating (every step's flags from ``scheduler.EigenRefreshCadence``:
``--eigh-chunks``, ``--staleness-budget``, the truncated solvers
``--solver rsvd``/``streaming``) and per-epoch validation loss,
``scalars.jsonl`` under
``--log-dir`` (the JAX trainer's tags; with ``--kfac-diagnostics`` also
the per-epoch mean of every ``kfac_*`` diagnostic) and checkpoints with
auto-resume under ``--checkpoint-dir``, and the CIFAR twin's
``--preempt-save-dir``/``--snapshot-every`` (the elastic runtime; a
snapshot holds the one-process layout, so it is resumed before the fsdp
split), ``--telemetry-dir``, ``--profile-epoch``, ``--profile`` and
``--autotune-steps``, and ``--service-devices`` (the curvature service's
worker ranks, as in the CIFAR twin; ``history["service"]``). ``--log-dir``
defaults to none here (``./logs`` in the JAX trainer).

Data-parallel, one process per GPU under ``torchrun`` (NCCL; gloo with
``--device cpu``): ``--batch-size`` is per rank (the JAX trainer's per
data slot), the global stream is batchified at ``--batch-size`` times the
world size and each rank keeps its contiguous block of rows, the
gradients and the loss are averaged over the ranks (``--grad-comm-dtype
bf16`` compresses the gradient mean), the K-FAC statistics cross the
factor comm plane (``--factor-comm-dtype``, ``--factor-comm-freq``),
every rank starts from rank 0's state, rank 0 prints, logs and writes
checkpoints, and validation runs each rank's rows, averaged over the
ranks.

``--seq-parallel N`` makes the world data×seq
(``parallel.mesh.data_seq_world``, the JAX trainer's ``("data", "seq")``
mesh): rank ``r`` is data slot ``r // N`` and seq slot ``r % N``, the
global batch is ``--batch-size`` times the ``world / N`` data slots, and
each rank trains its data slot's rows cut to its slot's
``--seq-len / N`` positions, attention running as ring or Ulysses over
the slot's seq subgroup (``parallel/context.py``; at ``--seq-parallel 1``
the flash kernels). The levers that ride one data axis
(``--factor-sharding owner``, ``--factor-comm-dtype``/``--factor-comm-freq``,
``--comm-overlap``, ``--grad-comm-dtype``) are refused there, with the JAX
trainer's messages.

``--tensor-parallel N`` (without ``--fsdp``) makes the world data×tensor
(``parallel.mesh.data_tensor_world``, the JAX trainer's legacy
``data_tensor_mesh``): rank ``r`` is data slot ``r // N`` and tensor slot
``r % N``, the compute is replicated over the tensor axis (the model stays
dense, as in the JAX trainer), the tensor peers of a data slot train the
same rows, the global batch is ``--batch-size`` times the ``world / N``
data slots, and every collective (the gradient and loss means, the factor
comm plane, the owner mode's exchanges, a checkpoint's gathers) rides the
data axis, so the owner, comm and overlap levers all stay available.
``--moe-experts E`` swaps each block's MLP for a ``KFACMoE`` bank of E
experts (the MoE expert lens, ``shardwise/``); it composes with
``--tensor-parallel``.

``--fsdp F`` (F ≥ 1) flips ``--tensor-parallel T``'s meaning, as in the
JAX trainer: the world is data×fsdp×tensor
(``parallel.mesh.data_fsdp_tensor_world``, rank ``r`` is data slot
``r // (F·T)``, fsdp slot ``(r // T) % F``, tensor slot ``r % T``) and its
axes carry genuine sharding. The model is built with T shard lenses and
each rank keeps its tensor slot's shards of every block's ``ff1`` (column)
and ``ff2`` (row) kernel and computes with them (``parallel/tensor.py``:
one all-reduce of the row output forward and one of the column input
backward per block, on the tensor subgroup), and the K-FAC blocks of its
own shards. Attention, the embeddings, the LayerNorms and the decoder
stay whole on every tensor slot. Each fsdp slot stores only its part of
every other parameter the JAX rule splits
(``shardwise.lm_param_shardings``), and of its momentum, gathered on the
fsdp subgroup for each step (``parallel/fsdp.py``). The batch slot of a
rank is ``data·F + fsdp``, the global batch is ``--batch-size × data ×
F``, and the gradient and loss means, the factor comm plane and the owner
mode ride the data×fsdp subgroup (``--fsdp F --tensor-parallel 1``
composes with ``--factor-sharding owner``); the tensor subgroup sees only
the compute split and the scalar sums of the KL clip and the global-norm
clip. ``--fsdp`` does not compose with ``--seq-parallel`` or
``--service-devices``, and ``--moe-experts`` is refused with a genuine
``--tensor-parallel``, with the JAX trainer's messages. Checkpoints hold
the gathered one-process layout.

    python -m kfac_pytorch_tpu_torch.examples.train_transformer_lm \\
        --synthetic --d-model 512 --n-heads 8 --n-layers 4 --seq-len 2048 \\
        --batch-size 4 --kfac-embedding --epochs 2
    torchrun --nproc-per-node 2 -m kfac_pytorch_tpu_torch.examples.train_transformer_lm \\
        --synthetic --kfac-embedding --factor-comm-dtype bf16 \\
        --factor-comm-freq 2 --grad-comm-dtype bf16
    torchrun --nproc-per-node 2 -m kfac_pytorch_tpu_torch.examples.train_transformer_lm \\
        --synthetic --kfac-embedding --seq-parallel 2 --attention ulysses
    torchrun --nproc-per-node 2 -m kfac_pytorch_tpu_torch.examples.train_transformer_lm \\
        --synthetic --kfac-embedding --tensor-parallel 2 --moe-experts 4
    torchrun --nproc-per-node 4 -m kfac_pytorch_tpu_torch.examples.train_transformer_lm \\
        --synthetic --kfac-embedding --fsdp 2 --tensor-parallel 2

On a CUDA device outside any process group the train step runs as CUDA
graphs, one captured per step variant and replayed
(``training.graphs.GraphedTrainStep``, the JAX trainer's jitted step);
the configurations of ``training.graphs.eager_step_reason`` (a process
group, ``--service-devices``, ``--comm-overlap``) run the eager step,
which it names once. ``compile_cache.RecompileMonitor`` watches
``train_step`` against ``compile_cache.expected_step_variants`` and
``eval_step`` against 1, as the JAX trainer does, and warns each epoch of
any graph beyond the budget; ``history["compiled_step"]`` records the
captures.

Attention runs the CUDA flash kernels on a GPU
(``ops/flash_attention.py::best_attention_fn``). It runs on CUDA unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
``main()`` returns the per-step history (loss, step kind
(``training.step.step_kind``), wall milliseconds measured around a
synchronized step and each ``kfac_*`` metric: the diagnostics with
``--kfac-diagnostics``, the truncated solvers' gauges), the per-epoch
validation loss, and the restore milliseconds of a resume.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture, planner
from kfac_pytorch_tpu_torch.compile_cache import RecompileMonitor
from kfac_pytorch_tpu_torch.device import use_ieee_f32
from kfac_pytorch_tpu_torch.examples.autotune import autotune_kfac
from kfac_pytorch_tpu_torch.examples.train_cifar10_resnet import (
    RunTelemetry,
    add_elastic_flags,
    add_factor_comm_flags,
    add_owner_flags,
    add_planner_flags,
    add_refresh_flags,
    add_telemetry_flags,
    carve_service_world,
    curvature_service,
    elastic_record,
    elastic_supervisor,
    factor_comm_kwargs,
    grad_comm_dtype,
    plan_record,
    rank0_print,
    refresh_cadence,
    refresh_kwargs,
    serve_curvature,
    service_record,
    step_span,
)
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.ops.factor_kernels import check_token_ids
from kfac_pytorch_tpu_torch.ops.flash_attention import best_attention_fn
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.context import full_attention, make_context_parallel_attention
from kfac_pytorch_tpu_torch.parallel.fsdp import FsdpParams
from kfac_pytorch_tpu_torch.parallel.mesh import (
    World,
    data_fsdp_tensor_world,
    data_seq_world,
    data_tensor_world,
    local_seq,
)
from kfac_pytorch_tpu_torch.preconditioner import lever_env
from kfac_pytorch_tpu_torch.shardwise import lm_param_shardings
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training import data as data_lib
from kfac_pytorch_tpu_torch.training import profiling
from kfac_pytorch_tpu_torch.training.graphs import (
    GraphedTrainStep,
    compiled_record,
    compiled_step,
    eager_step_reason,
)
from kfac_pytorch_tpu_torch.training.metrics import Metric, ScalarWriter
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    make_eval_step,
    make_sgd,
    make_train_step,
    step_kind,
)

SYNTHETIC_VOCAB = 1000

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Transformer-LM K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--data-dir", default=None, help="wikitext token dir")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log-dir", default=None, help="scalars.jsonl dir")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (enables save/resume)")
    add_elastic_flags(p)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=128, help="tokens per sample")
    p.add_argument("--batch-size", type=int, default=8, help="per data-parallel rank")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--grad-clip", type=float, default=0.25)
    p.add_argument("--kfac-embedding", action="store_true",
                   help="precondition the token embedding too (diagonal-A "
                        "K-FAC); its token counts run the CUDA token-count "
                        "kernel on a GPU")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="decoder head reuses the token embedding (logits = "
                        "x @ Wᵀ); with --kfac-embedding the tied table gets "
                        "ONE set of K-FAC statistics over both use sites "
                        "(reduce lens)")
    p.add_argument("--qkv-lens", action="store_true",
                   help="expand-lens K-FAC on each block's fused QKV projection: "
                        "three d_model-side G factors (q/k/v column slices) "
                        "instead of one 3*d_model-side factor — ~9x lighter "
                        "eigendecompositions (arxiv 2311.00636)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize each block in the backward pass "
                        "(torch.utils.checkpoint): activation memory for "
                        "long sequences, same math")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence-parallel axis size (data x seq world)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor axis size: without --fsdp, of the data x tensor "
                        "world (compute replicated over it, every K-FAC "
                        "collective on the data axis); with --fsdp, of the 3-D "
                        "world, whose MLP kernels it GENUINELY splits "
                        "(column ff1, row ff2) with per-shard K-FAC blocks")
    p.add_argument("--fsdp", type=int, default=0,
                   help=">= 1 builds the 3-D data x fsdp x tensor world "
                        "(parallel/mesh.py data_fsdp_tensor_world): params "
                        "shard over 'fsdp' (gathered for each step) and, with "
                        "--tensor-parallel > 1, the MLP kernels GENUINELY "
                        "shard over 'tensor' with per-shard K-FAC factor "
                        "blocks (shardwise/); the value is the 'fsdp' axis "
                        "size (1 = tensor-sharding only)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="replace each block's MLP with a top-1 MoE bank of this "
                        "many experts (per-expert K-FAC with token-count-"
                        "weighted EMAs); 0 keeps the dense MLP")
    p.add_argument("--attention", default="ring", choices=["ring", "ulysses"],
                   help="sequence-parallel attention kind (with --seq-parallel > 1)")
    p.add_argument("--kfac-update-freq", type=int, default=10, help="0 disables K-FAC")
    p.add_argument("--kfac-cov-update-freq", type=int, default=1)
    p.add_argument("--stat-decay", type=float, default=0.95)
    p.add_argument("--damping", type=float, default=0.003)
    p.add_argument("--damping-alpha", type=float, default=0.5)
    p.add_argument("--damping-schedule", nargs="+", type=int, default=None)
    p.add_argument("--kl-clip", type=float, default=0.001)
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    add_refresh_flags(p)
    p.add_argument("--grad-comm-dtype", default=None, choices=[None, "bf16"],
                   help="downcast the per-step data-parallel gradient mean "
                        "on the wire (the reference's --fp16-allreduce); "
                        "None = float32")
    add_factor_comm_flags(p)
    add_owner_flags(
        p,
        "owner: DP-KFAC owner-sharded curvature — factor "
                         "stats reduce-scatter onto each layer's eigen-owner "
                         "and ONE allgather replicates the preconditioned "
                         "grads; O(model/devices) factor memory and wire "
                         "(docs/PERF.md); needs a single data axis "
                         "(--seq-parallel 1; --tensor-parallel composes). "
                         "Diagonal-A embedding factors shard as [vocab] "
                         "vector slots, so --kfac-embedding composes too",
        "fuse the factor-statistics reduction into the "
                         "gradient stream: the bucketed factor psums issue "
                         "before the gradient pmean so the collectives "
                         "interleave with backprop instead of queuing after "
                         "it (pure data-parallel multi-device mesh only; "
                         "bitwise-identical numerics; docs/PERF.md)",
    )
    p.add_argument("--kfac-diagnostics", action="store_true",
                   help="log per-epoch means of the K-FAC health diagnostics "
                        "(nu, damped eigenvalues, condition numbers, "
                        "update/grad geometry) to --log-dir")
    add_planner_flags(p)
    add_telemetry_flags(p)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    sp = args.seq_parallel
    if sp > 1 and args.tensor_parallel > 1:
        raise SystemExit(
            "--seq-parallel and --tensor-parallel are separate second mesh "
            "axes; pick one"
        )
    if args.fsdp >= 1 and sp > 1:
        raise SystemExit(
            "--fsdp builds the 3-D data×fsdp×tensor mesh; it does not "
            "compose with --seq-parallel"
        )
    if args.moe_experts > 0 and args.fsdp >= 1 and args.tensor_parallel > 1:
        raise SystemExit(
            "--moe-experts replaces the MLP that a genuine --tensor-parallel "
            "split (--fsdp >= 1) would shard; pick one"
        )
    if args.seq_len % sp != 0:
        raise SystemExit(f"--seq-len {args.seq_len} must be divisible by --seq-parallel {sp}")
    if args.service_devices > 0 and (sp > 1 or args.tensor_parallel > 1 or args.fsdp >= 1):
        raise SystemExit(
            "--service-devices carves a pure data-parallel mesh; it does "
            "not compose with --seq-parallel, --tensor-parallel or --fsdp"
        )
    return args


def ranks_mean(value: float, world: World, device: torch.device) -> float:
    """A host float's mean over the ranks (each rank's mean over its equal
    share of rows: the global batch's mean)."""
    if not world.distributed:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    world.all_reduce_mean_([t])
    return float(t)


def device_batch(toks: np.ndarray, tgts: np.ndarray, device: torch.device):
    """One ``(tokens, targets)`` segment as int64 tensors on ``device``."""
    return (
        torch.from_numpy(toks.astype(np.int64)).to(device),
        torch.from_numpy(tgts.astype(np.int64)).to(device),
    )


def load_corpus(args):
    """``(splits, words)``: WikiText from ``--data-dir``, else (saying so
    without ``--synthetic``) the synthetic corpus of ``SYNTHETIC_VOCAB``
    words."""
    wt_dir = None if args.synthetic else data_lib.find_wikitext(args.data_dir)
    if wt_dir:
        return data_lib.build_corpus(wt_dir)
    if not args.synthetic:
        rank0_print("no WikiText data found; falling back to --synthetic")
    return data_lib.synthetic_corpus(vocab_size=SYNTHETIC_VOCAB)


def rank_rows(split, args, world: World):
    """This rank's rows of a split's ``[batch-size × data slots, N]``
    stream: its data slot's contiguous row block (the JAX trainer's
    per-process block; the seq slots of one data slot share it)."""
    stream = data_lib.batchify_tokens(split, args.batch_size * world.data_size)
    d = world.data_slot
    return stream[d * args.batch_size:(d + 1) * args.batch_size]


def rank_segments(stream, args, world: World):
    """The BPTT segments of ``stream``, each cut to this rank's seq slot's
    positions."""
    cols = local_seq(args.seq_len, world)
    for toks, tgts in data_lib.bptt_batches(stream, args.seq_len):
        yield toks[:, cols], tgts[:, cols]


def check_world(args, world: World) -> None:
    """The JAX trainer's checks of a data×seq, data×tensor or
    data×fsdp×tensor world and of the levers it refuses there, or with the
    shard lenses and the MoE bank."""
    sp, tp, fsdp = args.seq_parallel, args.tensor_parallel, max(0, args.fsdp)
    if world.size % sp != 0:
        raise SystemExit(f"--seq-parallel {sp} must divide device count {world.size}")
    if world.size % max(1, tp) != 0:
        raise SystemExit(f"--tensor-parallel {tp} must divide device count {world.size}")
    if fsdp >= 1 and world.size % (fsdp * max(1, tp)) != 0:
        raise SystemExit(
            f"--fsdp {fsdp} x --tensor-parallel {tp} must divide device "
            f"count {world.size}"
        )
    # the CLI's lever composition through the planner's validity matrix,
    # as in the JAX trainer, each refusal in KFAC's words, on the env KFAC
    # builds (lever_env) from the flags' axes; a tensor axis is exempt (the
    # K-FAC collectives still ride one data axis through it)
    cli_plan = planner.Plan(
        eigh_chunks=args.eigh_chunks,
        apply_kernel=args.apply_kernel,
        factor_comm_dtype=args.factor_comm_dtype,
        factor_comm_freq=args.factor_comm_freq,
        solver=args.solver,
        solver_rank=args.solver_rank,
        solver_auto_threshold=args.solver_auto_threshold,
        stream_drift_threshold=args.stream_drift_threshold,
        factor_sharding=args.factor_sharding,
        comm_overlap=args.comm_overlap,
        staleness_budget=args.staleness_budget,
        service_devices=args.service_devices,
    )
    # the carved curvature workers are not part of the training world
    env = lever_env(
        world.size, world.size // max(1, tp), sp, fsdp >= 1 and tp > 1,
        track_diagnostics=args.kfac_diagnostics,
        has_diag_a_layers=args.kfac_embedding,
        has_conv_layers=False,
        has_shard_lens_layers=fsdp >= 1 and tp > 1,
        has_moe_layers=args.moe_experts > 0,
        fac_update_freq=max(1, args.kfac_cov_update_freq),
        kfac_update_freq=max(1, args.kfac_update_freq),
        service_devices=args.service_devices,
    )
    bad = planner.violations(cli_plan, env)
    if bad:
        raise SystemExit(
            "invalid K-FAC lever composition:\n"
            + "\n".join(f"  [{r.name}] {r.refusal_text(cli_plan, env)}" for r in bad)
        )
    if args.grad_comm_dtype and sp > 1:
        raise SystemExit(
            "--grad-comm-dtype requires a pure data-parallel mesh "
            "(--seq-parallel 1): a sequence axis would make the per-device "
            "local forward see a partial example"
        )


def build(args, device: torch.device, oracle: bool = False, world: World = World(),
          profile=None):
    """``(model, kfac, state, train_step, splits)`` for parsed ``args`` on
    ``device`` over ``world``: the model, the preconditioner (``None`` at
    ``--kfac-update-freq 0``), the train state, the train step and the
    corpus. ``oracle=True`` builds the oracle path instead — exact
    attention and the dense factor and apply routes — which the JAX
    trainer has no flag for. Over a seq axis the attention is the
    sequence-parallel one either way. Under ``--fsdp`` (``world`` a
    data×fsdp×tensor world) the model's MLP kernels are this rank's tensor
    shards and the state's ``fsdp`` places the other parameters, still
    whole: ``fsdp.shard_`` cuts them after a resume and the starting
    broadcast. ``profile`` (default ``--profile``) is the planner profile
    name or ``Plan`` the K-FAC levers left at their defaults are filled
    from, the model's own factor shapes its facts."""
    profile = args.profile if profile is None else profile
    splits, words = load_corpus(args)
    if world.seq_size > 1:
        attention_fn = make_context_parallel_attention(world, args.attention)
    else:
        attention_fn = full_attention if oracle else best_attention_fn(device)
    shardwise_regime = args.fsdp >= 1
    model = transformer_lm.get_model(
        len(words), max_len=args.seq_len, d_model=args.d_model,
        n_heads=args.n_heads, n_layers=args.n_layers, attention_fn=attention_fn,
        kfac_embedding=args.kfac_embedding, qkv_lens=args.qkv_lens,
        tie_embeddings=args.tie_embeddings, remat=args.remat,
        # legacy --tensor-parallel replicates the compute, so the model
        # stays dense; under --fsdp it carries the shard lenses
        tensor_parallel=args.tensor_parallel if shardwise_regime else 1,
        moe_experts=args.moe_experts,
        generator=torch.Generator().manual_seed(args.seed),
        seq_shards=world.seq_size, seq_index=world.seq_slot,
    )
    placements = lm_param_shardings(
        {n: tuple(p.shape) for n, p in model.named_parameters()},
        capture.discover_layers(model), world.tensor_size, world.fsdp_size)
    model = transformer_lm.split_tensor_layers(model, world).to(device)
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    kfac = None
    if args.kfac_update_freq > 0:
        kfac = KFAC(
            layers=capture.discover_layers(model),
            factor_decay=args.stat_decay,
            damping=args.damping,
            kl_clip=args.kl_clip,
            fac_update_freq=args.kfac_cov_update_freq,
            kfac_update_freq=args.kfac_update_freq,
            track_diagnostics=args.kfac_diagnostics,
            **refresh_kwargs(args),
            **factor_comm_kwargs(args),
            factor_kernel="dense" if oracle else "auto",
            apply_kernel="dense" if oracle else args.apply_kernel,
            profile=profile,
            profile_shapes=model if profile is not None else None,
            device=device,
            process_group=world.group,
            seq_parallel=world.seq_size,
            tensor_group=world.tensor_group,
        )
    state = TrainState(
        step=0,
        model=model,
        opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=kfac.init(model) if kfac else None,
        fsdp=FsdpParams(model, placements, world) if world.fsdp_size > 1 else None,
    )
    train_step = make_train_step(
        model, tx, kfac,
        # tx IS make_sgd(momentum, wd): with K-FAC the optimizer step runs
        # through the fused SGD kernel
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
        grad_clip=args.grad_clip,
        world=world,
        grad_comm_dtype=grad_comm_dtype(args),
    )
    return model, kfac, state, train_step, splits


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    # before any span fires
    run_tel = RunTelemetry(args.telemetry_dir, args.comm_overlap)
    tel = run_tel.tel
    device = launch.initialize(args.device)
    use_ieee_f32()
    carve = carve_service_world(args)
    if carve.worker:
        return serve_curvature(build(args, device, world=carve.world)[1], carve, device)
    check_world(args, carve.world)
    if args.service_devices > 0:
        world = carve.world
    elif args.fsdp >= 1:
        world = data_fsdp_tensor_world(args.fsdp, args.tensor_parallel)
    elif args.tensor_parallel > 1:
        world = data_tensor_world(args.tensor_parallel)
    else:
        world = data_seq_world(args.seq_parallel, device)
    # the batch slots: data × fsdp on the 3-D world
    global_bs = args.batch_size * world.data_size
    rank0_print(f"mesh data={world.data_size // world.fsdp_size} fsdp={max(0, args.fsdp)} "
                f"seq={world.seq_size} tensor={args.tensor_parallel} "
                f"global_batch={global_bs} seq_len={args.seq_len}")
    model, kfac, state, train_step, splits = build(args, device, world=world)
    history: Dict[str, List] = {
        "loss": [], "kind": [], "step_ms": [], "val_loss": [], "restore_ms": [],
    }
    if kfac is not None and kfac.plan is not None:
        rank0_print(kfac.plan.describe() + (
            f" (dropped: {', '.join(kfac.plan_dropped)})" if kfac.plan_dropped else ""))
        toks, tgts = next(rank_segments(rank_rows(splits["train"], args, world), args, world))
        winner, report = autotune_kfac(
            kfac, lambda plan: build(args, device, world=world, profile=plan)[1:4],
            device_batch(toks, tgts, device), args.base_lr, args.autotune_steps, device,
            broadcast=launch.broadcast_host_value, log=rank0_print)
        if winner is not None and winner != kfac.plan:
            model, kfac, state, train_step, splits = build(args, device, world=world,
                                                           profile=winner)
        # the candidates' builds published their own plans' gauges
        planner.log_plan(kfac.plan, kfac.plan_dropped)
        history["plan"] = plan_record(kfac, report)
    # owner-sharded curvature is this rank's rows (a restored checkpoint
    # is re-homed the same way, in auto_resume)
    state.kfac_state = ckpt.rehome_kfac_state(kfac, state.kfac_state)
    resume_from_epoch = 0
    if args.checkpoint_dir:
        t0 = time.perf_counter()
        state, resume_from_epoch = ckpt.auto_resume(args.checkpoint_dir, state, kfac)
        if resume_from_epoch:
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            rank0_print(f"resumed from epoch {resume_from_epoch - 1}")
    # every rank starts from rank 0's state (hvd.broadcast_parameters)
    ckpt.broadcast_state(state, world)
    # [batch, N] contiguous streams (this rank's rows of the global one);
    # segments of seq_len become samples
    stream = rank_rows(splits["train"], args, world)
    max_steps = (stream.shape[1] - 1) // args.seq_len
    steps_per_epoch = min(args.steps_per_epoch or max_steps, max_steps)
    step = state.step
    cadence = refresh_cadence(kfac, lambda: state)
    sup, resume_skip, preempted = elastic_supervisor(args, kfac, cadence, steps_per_epoch), 0, False
    if sup is not None:
        # before the fsdp split: a snapshot holds the one-process layout
        t0 = time.perf_counter()
        hit = sup.scan_resume(state)
        if hit is not None:
            state, _, step = hit
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            resume_from_epoch, resume_skip = divmod(step, steps_per_epoch)
            rank0_print(f"elastic: resumed from snapshot at step {step}")
    if state.fsdp is not None:
        # from here each fsdp slot stores its parts of the split parameters
        state.fsdp.shard_(state.opt_state)
    kfac_sched = None
    if kfac is not None and args.damping_schedule:
        kfac_sched = KFACParamScheduler(
            kfac, damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_schedule, start_epoch=resume_from_epoch,
        )
    eval_step = make_eval_step(model)
    # after the autotune's rebuild: the graphs hold the winning plan's step
    train_step, budget = compiled_step(train_step, kfac, device,
                                       eager_step_reason(args, world, device))
    recompiles = RecompileMonitor(tel)
    recompiles.watch("train_step", train_step, budget)
    # eager in this slice: skipped, as the JAX monitor skips a callable
    # that is not jitted
    recompiles.watch("eval_step", eval_step, 1)
    writer = ScalarWriter(args.log_dir if launch.is_primary() else None)
    svc = curvature_service(args, kfac, cadence, sup, carve)

    for epoch in range(resume_from_epoch, args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        t0 = time.perf_counter()
        loss_m = Metric("train/loss")
        diag: Dict[str, List[float]] = {}
        with profiling.maybe_trace(args.log_dir, args.profile_epoch == epoch, device):
            for i, (toks, tgts) in enumerate(rank_segments(stream, args, world)):
                if i >= steps_per_epoch:
                    break
                if epoch == resume_from_epoch and i < resume_skip:
                    continue  # a mid-epoch snapshot's resume: i keeps the step's phase
                flags = cadence.flags_for_step(step, epoch)
                with tel.span("comm/host_to_device"):
                    batch = device_batch(toks, tgts, device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                ts = time.perf_counter()
                if svc is not None:
                    state.kfac_state = svc.before_step(step, state.kfac_state)
                with step_span(tel, flags) as sp:
                    state, metrics = train_step(
                        state, batch, args.base_lr,
                        kfac.hparams.damping if kfac else 0.0, **flags,
                    )
                    sp.block(metrics)
                if svc is not None:
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
        # the token-count kernel tallies ids outside the vocabulary on the
        # card; read the tally once an epoch, where the host waits anyway
        check_token_ids(device)
        dt = time.perf_counter() - t0
        ppl = math.exp(min(loss_m.avg, 20.0))
        rank0_print(
            f"epoch {epoch}: loss={loss_m.avg:.4f} ppl={ppl:.1f} "
            f"{steps_per_epoch * global_bs * args.seq_len / dt:.0f} tok/s ({dt:.1f}s)"
        )
        writer.add_scalar("train/loss", loss_m.avg, epoch)
        writer.add_scalar("train/ppl", ppl, epoch)
        if diag:
            means = {k: sum(v) / len(v) for k, v in sorted(diag.items())}
            for k, v in means.items():
                writer.add_scalar(f"kfac/{k[5:]}_mean", v, epoch)  # kfac_x -> kfac/x_mean
            rank0_print(f"  kfac: nu={means.get('kfac_nu', 0.0):.4f} "
                        f"cond_max={means.get('kfac_cond_max', 0.0):.3e} "
                        f"upd_cos={means.get('kfac_update_grad_cos', 0.0):.3f}")
        val = rank_rows(splits["valid"], args, world)
        with state.fsdp.gathered() if state.fsdp is not None else contextlib.nullcontext():
            vl = [
                float(eval_step(state, device_batch(toks, tgts, device))["loss"])
                for toks, tgts in rank_segments(val, args, world)
            ]
        if vl:
            v = ranks_mean(sum(vl) / len(vl), world, device)
            history["val_loss"].append(v)
            rank0_print(f"  val: loss={v:.4f} ppl={math.exp(min(v, 20.0)):.1f}")
            writer.add_scalar("val/loss", v, epoch)
            writer.add_scalar("val/ppl", math.exp(min(v, 20.0)), epoch)
        excess = recompiles.check()
        if excess and launch.is_primary():
            print(f"  WARNING: unexpected recompiles (step graphs over budget): {excess}")
        run_tel.end_epoch(epoch)
        if args.checkpoint_dir:
            ckpt.save_checkpoint(args.checkpoint_dir, epoch, state, world)
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
    return history


if __name__ == "__main__":
    main()
