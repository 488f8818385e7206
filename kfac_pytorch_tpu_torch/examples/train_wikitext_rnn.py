"""WikiText RNN/LSTM LM training with K-FAC, one GPU or data-parallel (PyTorch port).

Twin of the JAX package's ``examples/train_wikitext_rnn.py``: the same
flags with the same defaults for what the port carries
(WikiText token files from ``--data-dir`` or the synthetic Zipf corpus; the
four cell types, tying and the K-FAC token embedding; SGD with global-norm
clipping and the lr /4 decay; K-FAC on the decoder, and with
``--kfac-embedding`` on the embedding, which composes with ``--tied``
through the reduce lens; every step's K-FAC flags from
``scheduler.EigenRefreshCadence``: ``--eigh-chunks``,
``--staleness-budget``, the truncated solvers ``--solver rsvd``/
``streaming``), per-epoch validation on the valid split,
``scalars.jsonl`` under ``--log-dir`` and checkpoints with auto-resume
under ``--checkpoint-dir``; ``--profile`` resolves the K-FAC levers left
at their defaults from a planner profile (``planner/``); the CIFAR twin's
``--preempt-save-dir``/``--snapshot-every`` (the elastic runtime). ``--tied`` without
``--kfac-embedding`` leaves
no preconditionable layer and trains with plain SGD, as the JAX trainer
does. ``--service-devices`` runs the curvature service's worker ranks, as
in the CIFAR twin (``history["service"]``). ``--log-dir`` defaults to none
here (``./logs`` in the JAX trainer).

Data-parallel, one process per GPU under ``torchrun`` (NCCL; gloo with
``--device cpu``): ``--batch-size`` is the global batch, as in the JAX
trainer, and must divide by the world size; each rank trains its
contiguous block of the stream's rows and carries their recurrent state,
the gradients and the loss are averaged over the ranks before the clip
(``--grad-comm-dtype bf16`` compresses the gradient mean), the K-FAC
statistics cross the factor comm plane (``--factor-comm-dtype``,
``--factor-comm-freq``), the dropout masks differ per rank, every rank
starts from rank 0's state, rank 0 prints, logs and writes checkpoints,
and validation runs each rank's rows, averaged over the ranks.

    python -m kfac_pytorch_tpu_torch.examples.train_wikitext_rnn \\
        --data-dir /path/to/wikitext-2 --epochs 40
    python -m kfac_pytorch_tpu_torch.examples.train_wikitext_rnn --synthetic \\
        --emsize 16 --nhid 16 --batch-size 4 --bptt 8 --epochs 1 \\
        --steps-per-epoch 4 --device cpu
    torchrun --nproc-per-node 2 -m kfac_pytorch_tpu_torch.examples.train_wikitext_rnn \\
        --data-dir /path/to/wikitext-2 --factor-comm-dtype int8 --factor-comm-freq 4

The dropout masks come from a ``torch.Generator`` seeded with ``--seed``
plus the epoch at each epoch's start, so a resumed epoch draws the masks of
the uninterrupted run (the JAX trainer's key sequence restarts on resume).
A mid-epoch elastic snapshot carries the generator's state in its
manifest's ``extra`` (``dropout_generator``) and each rank's recurrent
carry in its payload (``aux``); the resumed epoch takes both back and
skips the batches already trained, so its draws, carry and data are the
uninterrupted run's (over more than one rank the masks are keyed by the
step and the rank anyway).
It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the history: per step the loss,
the step kind (``training.step.step_kind``), the wall milliseconds around
a synchronized step and each ``kfac_*`` metric (the truncated solvers'
gauges); per
epoch the validation loss and perplexity; the restore milliseconds of a
resume.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List

import torch

from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.device import use_ieee_f32
from kfac_pytorch_tpu_torch.examples.train_cifar10_resnet import (
    add_elastic_flags,
    add_factor_comm_flags,
    add_owner_flags,
    add_planner_flags,
    add_refresh_flags,
    carve_service_world,
    curvature_service,
    elastic_record,
    elastic_supervisor,
    factor_comm_kwargs,
    grad_comm_dtype,
    rank0_print,
    refresh_cadence,
    refresh_kwargs,
    serve_curvature,
    service_record,
)
from kfac_pytorch_tpu_torch.examples.train_transformer_lm import device_batch, ranks_mean
from kfac_pytorch_tpu_torch.models import wikitext_rnn
from kfac_pytorch_tpu_torch.ops.factor_kernels import check_token_ids
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import World, local_rows
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training import data as data_lib
from kfac_pytorch_tpu_torch.training.lm_step import (
    init_carry,
    make_lm_eval_step,
    make_lm_train_step,
)
from kfac_pytorch_tpu_torch.training.metrics import Metric, ScalarWriter
from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, step_kind

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="WikiText RNN K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--data-dir", default=None, help="wikitext token dir")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log-dir", default=None, help="scalars.jsonl dir")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (enables save/resume)")
    add_elastic_flags(p)
    p.add_argument("--model", default="LSTM", choices=list(wikitext_rnn.RNN_TYPES))
    p.add_argument("--emsize", type=int, default=650)
    p.add_argument("--nhid", type=int, default=650)
    p.add_argument("--nlayers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--tied", action="store_true")
    p.add_argument("--kfac-embedding", action="store_true",
                   help="precondition the token embedding too (diagonal-A "
                        "K-FAC; beyond the reference's Linear/Conv2d set); "
                        "composes with --tied — the shared table then "
                        "accumulates ONE set of statistics over both the "
                        "lookup and the decoder use sites (reduce lens)")
    p.add_argument("--batch-size", type=int, default=20,
                   help="global batch (rows of the stream), split over the ranks")
    p.add_argument("--bptt", type=int, default=35)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=20.0)
    p.add_argument("--lr-decay", nargs="+", type=int, default=[20, 30])
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--clip", type=float, default=0.25)
    p.add_argument("--kfac-update-freq", type=int, default=10, help="0 disables K-FAC")
    p.add_argument("--kfac-cov-update-freq", type=int, default=1)
    p.add_argument("--stat-decay", type=float, default=0.95)
    p.add_argument("--damping", type=float, default=0.003)
    p.add_argument("--kl-clip", type=float, default=0.001)
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    add_refresh_flags(p)
    add_factor_comm_flags(p)
    add_owner_flags(
        p,
        "owner: DP-KFAC owner-sharded curvature state — "
                         "O(model/devices) factor memory; embedding diag-A "
                         "factors shard as [vocab] vector slots, so "
                         "--kfac-embedding composes (docs/PERF.md)",
        "fuse the factor-statistics reduction into the "
                         "gradient stream (multi-device only; bitwise-"
                         "identical numerics)",
    )
    p.add_argument("--grad-comm-dtype", default=None, choices=[None, "bf16"],
                   help="downcast the per-step data-parallel gradient mean "
                        "on the wire (the reference's --fp16-allreduce); "
                        "None = exact f32 reduction")
    add_planner_flags(p, autotune=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def load_corpus(args):
    """``(splits, vocab)``: WikiText from ``--data-dir``, else (saying so
    without ``--synthetic``) the synthetic Zipf corpus."""
    wt_dir = None if args.synthetic else data_lib.find_wikitext(args.data_dir)
    if wt_dir:
        splits, vocab = data_lib.build_corpus(wt_dir)
        rank0_print(f"wikitext from {wt_dir}: vocab={len(vocab)}")
        return splits, vocab
    if not args.synthetic:
        rank0_print("no wikitext data found; falling back to --synthetic")
    return data_lib.synthetic_corpus()


def build(args, ntokens: int, device: torch.device, world: World = World()):
    """``(model, kfac, state, train_step)`` for parsed ``args`` on
    ``device`` over ``world``; ``kfac`` is ``None`` at
    ``--kfac-update-freq 0`` and when the model has no preconditionable
    layer."""
    model = wikitext_rnn.get_model(
        args.model, ntokens, args.emsize, args.nhid, args.nlayers, args.dropout,
        args.tied, kfac_embedding=args.kfac_embedding,
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    kfac = None
    if args.kfac_update_freq > 0:
        layers = capture.discover_layers(model)
        if not layers:
            rank0_print("WARNING: no preconditionable layers (tied decoder?); running plain SGD")
        else:
            rank0_print(f"K-FAC layers: {layers}")
            kfac = KFAC(
                layers=layers,
                factor_decay=args.stat_decay,
                damping=args.damping,
                kl_clip=args.kl_clip,
                fac_update_freq=args.kfac_cov_update_freq,
                kfac_update_freq=args.kfac_update_freq,
                apply_kernel=args.apply_kernel,
                **refresh_kwargs(args),
                **factor_comm_kwargs(args),
                profile=args.profile,
                profile_shapes=model if args.profile is not None else None,
                device=device,
                process_group=world.group,
            )
            if kfac.plan is not None:
                rank0_print(kfac.plan.describe() + (
                    f" (dropped: {', '.join(kfac.plan_dropped)})" if kfac.plan_dropped else ""))
    state = TrainState(
        step=0,
        model=model,
        opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=kfac.init(model) if kfac else None,
    )
    train_step = make_lm_train_step(
        model, tx, kfac, grad_clip=args.clip,
        # tx IS make_sgd(momentum, wd): with K-FAC the optimizer step runs
        # through the fused SGD kernel, at momentum 0 too
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
        world=world,
        grad_comm_dtype=grad_comm_dtype(args),
    )
    return model, kfac, state, train_step


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    device = launch.initialize(args.device)
    use_ieee_f32()
    carve = carve_service_world(args)
    world = carve.world
    if carve.worker:
        vocab = load_corpus(args)[1]
        return serve_curvature(build(args, len(vocab), device, world)[1], carve, device)
    if args.batch_size % world.size:
        raise SystemExit(
            f"the data-parallel step splits the batch over {world.size} ranks; "
            f"--batch-size {args.batch_size} must divide evenly"
        )
    splits, vocab = load_corpus(args)
    # this rank's contiguous rows of the global [batch, N] streams
    rows = local_rows(args.batch_size, world)
    train_stream = data_lib.batchify_tokens(splits["train"], args.batch_size)[rows]
    val_stream = data_lib.batchify_tokens(
        splits.get("valid", splits["train"]), args.batch_size)[rows]
    local_bs = train_stream.shape[0]
    model, kfac, state, train_step = build(args, len(vocab), device, world)
    eval_step = make_lm_eval_step(model)
    history: Dict[str, List] = {
        "loss": [], "kind": [], "step_ms": [], "val_loss": [], "val_ppl": [], "restore_ms": [],
    }
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
    max_steps = (train_stream.shape[1] - 1) // args.bptt
    steps_per_epoch = min(args.steps_per_epoch or max_steps, max_steps)
    writer = ScalarWriter(args.log_dir if launch.is_primary() else None)
    generator = torch.Generator(device=device)

    step = state.step
    cadence = refresh_cadence(kfac, lambda: state)
    sup, resume_skip, preempted = elastic_supervisor(args, kfac, cadence, steps_per_epoch), 0, False
    if sup is not None:
        t0 = time.perf_counter()
        hit = sup.scan_resume(state)
        if hit is not None:
            state, manifest, step = hit
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            resume_from_epoch, resume_skip = divmod(step, steps_per_epoch)
            rank0_print(f"elastic: resumed from snapshot at step {step}")
    svc = curvature_service(args, kfac, cadence, sup, carve)
    for epoch in range(resume_from_epoch, args.epochs):
        lr = args.base_lr
        for e in args.lr_decay:
            if epoch >= e:
                lr *= 0.25  # torch LM convention: anneal lr /4 at plateaus
        generator.manual_seed(args.seed + epoch)
        carry = init_carry(model, local_bs, device)
        if epoch == resume_from_epoch and resume_skip:
            # a mid-epoch snapshot's resume: the dropout generator and this
            # rank's recurrent carry as they were after the snapshot's step
            generator.set_state(torch.tensor(manifest["extra"]["dropout_generator"],
                                             dtype=torch.uint8))
            carry = manifest["aux"]["carry"]
        loss_m = Metric("train/loss")
        t0 = time.perf_counter()
        n_steps = 0
        for i, (xb, yb) in enumerate(data_lib.bptt_batches(train_stream, args.bptt)):
            if i >= steps_per_epoch:
                break
            if epoch == resume_from_epoch and i < resume_skip:
                continue  # the data order is kept: i keeps the step's phase
            flags = cadence.flags_for_step(step, epoch)
            batch = device_batch(xb, yb, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ts = time.perf_counter()
            if svc is not None:
                state.kfac_state = svc.before_step(step, state.kfac_state)
            state, carry, metrics = train_step(
                state, batch, carry, generator, lr,
                kfac.hparams.damping if kfac else 0.0, **flags,
            )
            if svc is not None:
                svc.after_step(step, state.kfac_state)
            # one read of every scalar the host logs: waits for the step
            keys = sorted(metrics)
            values = dict(zip(keys, torch.stack(
                [metrics[k].float() for k in keys]).tolist()))
            history["step_ms"].append((time.perf_counter() - ts) * 1e3)
            history["loss"].append(values["loss"])
            history["kind"].append(step_kind(flags))
            for k, v in values.items():
                if k.startswith("kfac_"):
                    history.setdefault(k, []).append(v)
            loss_m.update(values["loss"])
            step += 1
            n_steps += 1
            if sup is not None and sup.on_step(
                step, lambda: state,
                extra={"dropout_generator": generator.get_state().tolist()},
                aux=lambda: {"carry": carry},
            ):
                preempted = True
                break
        if preempted:
            rank0_print(f"elastic: preempted; snapshot at step {step} saved")
            break
        if args.kfac_embedding:
            # the token-count kernel tallies ids outside the vocabulary on
            # the card; read the tally once an epoch
            check_token_ids(device)
        dt = time.perf_counter() - t0
        ppl = math.exp(min(loss_m.avg, 20))
        rank0_print(f"epoch {epoch}: loss={loss_m.avg:.4f} ppl={ppl:.1f} "
                    f"lr={lr:.2f} ({n_steps} steps, {dt:.1f}s)")
        writer.add_scalar("train/loss", loss_m.avg, epoch)
        writer.add_scalar("train/ppl", ppl, epoch)

        vcarry = init_carry(model, local_bs, device)
        vl = Metric("val/loss")
        for xb, yb in data_lib.bptt_batches(val_stream, args.bptt):
            m, vcarry = eval_step(state, device_batch(xb, yb, device), vcarry)
            vl.update(float(m["loss"]))
        val_loss = ranks_mean(vl.avg, world, device)
        vppl = math.exp(min(val_loss, 20))
        history["val_loss"].append(val_loss)
        history["val_ppl"].append(vppl)
        rank0_print(f"  val: loss={val_loss:.4f} ppl={vppl:.1f}")
        writer.add_scalar("val/loss", val_loss, epoch)
        writer.add_scalar("val/ppl", vppl, epoch)
        if args.checkpoint_dir:
            ckpt.save_checkpoint(args.checkpoint_dir, epoch, state, world)
    if sup is not None:
        sup.wait()  # join any in-flight background snapshot write
        history["elastic"] = elastic_record(sup)
    writer.close()
    if svc is not None:
        history["service"] = service_record(svc)
    return history


if __name__ == "__main__":
    main()
