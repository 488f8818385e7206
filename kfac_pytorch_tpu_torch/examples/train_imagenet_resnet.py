"""ImageNet ResNet training with K-FAC on one GPU (PyTorch port).

Twin of the JAX package's ``examples/train_imagenet_resnet.py`` for one
device: the same flags with the same defaults for what the port carries
(the nine architectures, grouped-conv K-FAC for ResNeXt, label smoothing,
the warmup/step LR schedule, the damping and update-frequency schedules of
``KFACParamScheduler``, gradient accumulation ``--batches-per-allreduce``,
``--precond-method``, the bfloat16 modes ``--bf16``, ``--eigen-dtype`` and
``--precond-precision``, ``scalars.jsonl`` under ``--log-dir`` and
checkpoints with auto-resume under ``--checkpoint-dir``), the same
synthetic batches and K-FAC gating (``--kfac-update-freq 0`` is plain
SGD). Only ``--synthetic`` data is ported: the ImageNet data path, its
augmentation and evaluation are ROADMAP queue 1 item 5. Every other flag
of the JAX trainer is accepted with its default and, set to anything else,
raises ``SystemExit`` naming the ROADMAP item that ports it.
``--log-dir`` and ``--checkpoint-dir`` default to none here (the JAX
trainer's defaults are ``./logs`` and ``./checkpoints``): a run writes
nothing it was not asked to.

    python -m kfac_pytorch_tpu_torch.examples.train_imagenet_resnet \\
        --synthetic --model resnext50_32x4d --epochs 1 --steps-per-epoch 30

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the per-step history (loss,
accuracy, step kind, wall milliseconds measured around a synchronized
step), and the restore milliseconds of a resume.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture
from kfac_pytorch_tpu_torch.device import resolve_device, use_ieee_f32
from kfac_pytorch_tpu_torch.examples.train_cifar10_resnet import (
    add_precision_flags,
    precision_kwargs,
)
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.data import synthetic_batches
from kfac_pytorch_tpu_torch.training.metrics import Metric, ScalarWriter
from kfac_pytorch_tpu_torch.training.schedules import create_lr_schedule
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
)

NUM_CLASSES = 1000

# Flags of the JAX trainer this slice does not carry: (flag, type, default,
# ROADMAP queue-1 item that ports it). Store-true flags have type None.
_LATER_FLAGS = (
    ("--data-dir", str, None, "5 (ImageNet data)"),
    ("--val-resize", int, 256, "5 (ImageNet evaluation)"),
    ("--no-augment", None, False, "5 (ImageNet augmentation)"),
    ("--num-workers", int, 4, "9 (runtime/loader.py)"),
    ("--val-batch-size", int, 32, "5 (ImageNet evaluation)"),
    ("--distribute-precondition", None, False, "6 (multi-GPU)"),
    ("--distribute-layer-factors", str, None, "6 (multi-GPU)"),
    ("--init-from-torch", str, None, "5 (--init-from-torch)"),
    ("--precond-comm-dtype", str, None, "6 (multi-GPU)"),
    ("--grad-comm-dtype", str, None, "6 (multi-GPU)"),
    ("--profile-epoch", int, None, "9 (observability/)"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ImageNet K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--synthetic", action="store_true", help="use synthetic data")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--log-dir", default=None, help="scalars.jsonl dir")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (enables save/resume)")
    p.add_argument("--model", default="resnet50", choices=sorted(imagenet_resnet._MODELS))
    p.add_argument("--batch-size", type=int, default=32, help="per-device")
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step")
    p.add_argument("--epochs", type=int, default=55)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--lr-decay", nargs="+", type=int, default=[25, 35, 40, 45, 50])
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--kfac-update-freq", type=int, default=10, help="0 disables K-FAC")
    p.add_argument("--kfac-cov-update-freq", type=int, default=1)
    p.add_argument("--stat-decay", type=float, default=0.95)
    p.add_argument("--damping", type=float, default=0.002)
    p.add_argument("--damping-alpha", type=float, default=0.5)
    p.add_argument("--damping-schedule", nargs="+", type=int, default=[40, 80])
    p.add_argument("--kl-clip", type=float, default=0.001)
    p.add_argument("--diag-blocks", type=int, default=1)
    p.add_argument("--diag-warmup", type=int, default=5)
    p.add_argument("--kfac-update-freq-alpha", type=float, default=10)
    p.add_argument("--kfac-update-freq-schedule", nargs="+", type=int, default=None)
    p.add_argument("--precond-method", default="eigen", choices=["eigen", "inverse"],
                   help="eigen: eigenbasis solve (damping fresh every step); "
                        "inverse: pi-corrected factored damping + Cholesky "
                        "inverses (the dense apply: no fused apply kernel)")
    add_precision_flags(p)
    p.add_argument("--factor-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="conv A-factor statistics: kernel = the CUDA patch-"
                        "covariance kernels (grouped convs: one launch per "
                        "layer), dense = im2col oracle, auto = the kernels on "
                        "CUDA tensors, their plain versions on CPU ones")
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag, kind, default, _ in _LATER_FLAGS:
        if kind is None:
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, type=kind, default=default, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, _, default, item in _LATER_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) != default:
            raise SystemExit(
                f"{flag} is not ported to the PyTorch trainer yet (ROADMAP "
                f"queue 1 item {item})"
            )
    if args.batches_per_allreduce < 1:
        raise SystemExit("--batches-per-allreduce must be at least 1")
    return args


def build(args, device: torch.device):
    """``(model, kfac, state, train_step)`` for parsed ``args`` on
    ``device``; ``kfac`` is ``None`` at ``--kfac-update-freq 0``."""
    model = imagenet_resnet.get_model(
        args.model, num_classes=NUM_CLASSES,
        generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.bfloat16 if args.bf16 else None,
    ).to(device)
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    kfac = None
    if args.kfac_update_freq > 0:
        kfac = KFAC(
            layers=capture.discover_layers(model),
            lr=args.base_lr,
            factor_decay=args.stat_decay,
            damping=args.damping,
            kl_clip=args.kl_clip,
            fac_update_freq=args.kfac_cov_update_freq,
            kfac_update_freq=args.kfac_update_freq,
            diag_blocks=args.diag_blocks,
            diag_warmup=args.diag_warmup,
            precond_method=args.precond_method,
            **precision_kwargs(args),
            factor_kernel=args.factor_kernel,
            apply_kernel=args.apply_kernel,
            device=device,
        )
    state = TrainState(
        step=0,
        model=model,
        opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=kfac.init(model) if kfac else None,
    )
    train_step = make_train_step(
        model, tx, kfac,
        # tx IS make_sgd(momentum, wd): with K-FAC the optimizer step runs
        # through the fused SGD kernel
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
        label_smoothing=args.label_smoothing,
        accum_steps=args.batches_per_allreduce,
    )
    return model, kfac, state, train_step


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit(
            "only --synthetic data is ported so far (ImageNet data, "
            "augmentation and evaluation are ROADMAP queue 1 item 5)"
        )
    device = resolve_device(args.device)
    use_ieee_f32()
    world = 1
    accum = args.batches_per_allreduce
    model, kfac, state, train_step = build(args, device)
    history: Dict[str, List] = {
        "loss": [], "accuracy": [], "kind": [], "step_ms": [], "restore_ms": [],
    }
    resume_from_epoch = 0
    if args.checkpoint_dir:
        t0 = time.perf_counter()
        state, resume_from_epoch = ckpt.auto_resume(args.checkpoint_dir, state)
        if resume_from_epoch:
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            print(f"resumed from epoch {resume_from_epoch - 1}")
    kfac_sched = None
    if kfac is not None:
        kfac_sched = KFACParamScheduler(
            kfac,
            damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_schedule,
            update_freq_alpha=args.kfac_update_freq_alpha,
            update_freq_schedule=args.kfac_update_freq_schedule,
            start_epoch=resume_from_epoch,
        )
    lr_base = args.base_lr * world
    lr_factor = create_lr_schedule(world, args.warmup_epochs, args.lr_decay)
    steps_per_epoch = args.steps_per_epoch or 100
    im = args.image_size
    writer = ScalarWriter(args.log_dir)

    step = state.step
    for epoch in range(resume_from_epoch, args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        batches = synthetic_batches(
            args.batch_size * accum, (3, im, im), NUM_CLASSES, steps_per_epoch,
            seed=args.seed,
        )
        t0 = time.perf_counter()
        loss_m, acc_m = Metric("train/loss"), Metric("train/accuracy")
        for i, (xb, yb) in enumerate(batches):
            lr = lr_base * lr_factor(epoch + i / steps_per_epoch)
            flags = kfac_flags_for_step(step, kfac, epoch)
            images = torch.from_numpy(xb).to(device, non_blocking=True)
            labels = torch.from_numpy(yb).to(device, non_blocking=True)
            if accum > 1:
                images = images.reshape(accum, -1, *images.shape[1:])
                labels = labels.reshape(accum, -1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ts = time.perf_counter()
            state, metrics = train_step(
                state, (images, labels), lr,
                kfac.hparams.damping if kfac else 0.0, **flags,
            )
            # one read of the logged scalars: waits for the step
            loss, acc = torch.stack([metrics["loss"], metrics["accuracy"]]).tolist()
            history["step_ms"].append((time.perf_counter() - ts) * 1e3)
            history["loss"].append(loss)
            history["accuracy"].append(acc)
            history["kind"].append(
                "refresh" if flags.get("update_eigen")
                else "capture" if flags.get("update_factors") else "plain"
            )
            loss_m.update(loss)
            acc_m.update(acc)
            step += 1
        dt = time.perf_counter() - t0
        print(
            f"epoch {epoch}: loss={loss_m.avg:.4f} acc={acc_m.avg:.4f} lr={lr:.4f} "
            f"{steps_per_epoch * args.batch_size * accum / dt:.0f} img/s ({dt:.1f}s)"
        )
        writer.add_scalar("train/loss", loss_m.avg, epoch)
        writer.add_scalar("train/accuracy", acc_m.avg, epoch)
        writer.add_scalar("train/lr", lr, epoch)
        if args.checkpoint_dir:
            ckpt.save_checkpoint(args.checkpoint_dir, epoch, state)
    writer.close()
    return history


if __name__ == "__main__":
    main()
