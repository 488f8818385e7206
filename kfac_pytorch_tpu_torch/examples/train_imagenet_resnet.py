"""ImageNet ResNet training with K-FAC on one GPU (PyTorch port).

Twin of the JAX package's ``examples/train_imagenet_resnet.py`` for one
device: the same flags with the same defaults for what this slice carries
(the nine architectures, grouped-conv K-FAC for ResNeXt, label smoothing,
the warmup/step LR schedule, the damping and update-frequency schedules of
``KFACParamScheduler``), the same synthetic batches and K-FAC gating
(``--kfac-update-freq 0`` is plain SGD). Only ``--synthetic`` data is
ported: the ImageNet data path, its augmentation and evaluation are ROADMAP
queue 1 item 5. Every other flag of the JAX trainer is accepted with its
default and, set to anything else, raises ``SystemExit`` naming the
ROADMAP item that ports it; ``--checkpoint-dir`` defaults to none here
(the JAX trainer's default is ``./checkpoints``).

    python -m kfac_pytorch_tpu_torch.examples.train_imagenet_resnet \\
        --synthetic --model resnext50_32x4d --epochs 1 --steps-per-epoch 30

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the per-step history (loss, step
kind, wall milliseconds measured around a synchronized step).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture
from kfac_pytorch_tpu_torch.device import resolve_device, use_ieee_f32
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.training.data import synthetic_batches
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
    ("--log-dir", str, "./logs", "4 (training/metrics.py)"),
    ("--checkpoint-dir", str, None, "4 (training/checkpoint.py)"),
    ("--batches-per-allreduce", int, 1, "4 (grad accumulation)"),
    ("--val-batch-size", int, 32, "5 (ImageNet evaluation)"),
    ("--distribute-precondition", None, False, "6 (multi-GPU)"),
    ("--distribute-layer-factors", str, None, "6 (multi-GPU)"),
    ("--init-from-torch", str, None, "5 (--init-from-torch)"),
    ("--precond-comm-dtype", str, None, "6 (multi-GPU)"),
    ("--grad-comm-dtype", str, None, "6 (multi-GPU)"),
    ("--precond-method", str, "eigen", "4 (precond_method='inverse')"),
    ("--precond-precision", str, None, "4 (precond_precision)"),
    ("--eigen-dtype", str, "f32", "4 (bf16 eigen_dtype)"),
    ("--bf16", None, False, "4 (bf16 compute)"),
    ("--profile-epoch", int, None, "9 (observability/)"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ImageNet K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--synthetic", action="store_true", help="use synthetic data")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--model", default="resnet50", choices=sorted(imagenet_resnet._MODELS))
    p.add_argument("--batch-size", type=int, default=32, help="per-device")
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
    return args


def build(args, device: torch.device):
    """``(model, kfac, state, train_step)`` for parsed ``args`` on
    ``device``; ``kfac`` is ``None`` at ``--kfac-update-freq 0``."""
    model = imagenet_resnet.get_model(
        args.model, num_classes=NUM_CLASSES,
        generator=torch.Generator().manual_seed(args.seed),
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
    model, kfac, state, train_step = build(args, device)
    kfac_sched = None
    if kfac is not None:
        kfac_sched = KFACParamScheduler(
            kfac,
            damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_schedule,
            update_freq_alpha=args.kfac_update_freq_alpha,
            update_freq_schedule=args.kfac_update_freq_schedule,
        )
    lr_base = args.base_lr * world
    lr_factor = create_lr_schedule(world, args.warmup_epochs, args.lr_decay)
    steps_per_epoch = args.steps_per_epoch or 100
    im = args.image_size

    history: Dict[str, List] = {"loss": [], "kind": [], "step_ms": []}
    step = 0
    for epoch in range(args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        batches = synthetic_batches(
            args.batch_size, (3, im, im), NUM_CLASSES, steps_per_epoch, seed=args.seed
        )
        t0 = time.perf_counter()
        losses = []
        for i, (xb, yb) in enumerate(batches):
            lr = lr_base * lr_factor(epoch + i / steps_per_epoch)
            flags = kfac_flags_for_step(step, kfac, epoch)
            images = torch.from_numpy(xb).to(device, non_blocking=True)
            labels = torch.from_numpy(yb).to(device, non_blocking=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ts = time.perf_counter()
            state, metrics = train_step(
                state, (images, labels), lr,
                kfac.hparams.damping if kfac else 0.0, **flags,
            )
            loss = float(metrics["loss"])  # waits for the step
            history["step_ms"].append((time.perf_counter() - ts) * 1e3)
            history["loss"].append(loss)
            history["kind"].append(
                "refresh" if flags.get("update_eigen")
                else "capture" if flags.get("update_factors") else "plain"
            )
            losses.append(loss)
            step += 1
        dt = time.perf_counter() - t0
        print(
            f"epoch {epoch}: loss={sum(losses) / len(losses):.4f} lr={lr:.4f} "
            f"{steps_per_epoch * args.batch_size / dt:.0f} img/s ({dt:.1f}s)"
        )
    return history


if __name__ == "__main__":
    main()
