"""CIFAR-10 ResNet training with K-FAC on one GPU (PyTorch port).

Twin of the JAX package's ``examples/train_cifar10_resnet.py`` for the
main path: the same flags with the same defaults, the same K-FAC gating
(``--kfac-update-freq 0`` is plain SGD), one device. Only ``--synthetic``
data is ported so far (CIFAR-10 loading is ROADMAP queue 1 item 4).

    python -m kfac_pytorch_tpu_torch.examples.train_cifar10_resnet \\
        --synthetic --model resnet32 --epochs 1 --steps-per-epoch 30

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the per-step history (loss, step
kind, wall milliseconds measured around a synchronized step).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture
from kfac_pytorch_tpu_torch.device import resolve_device, use_ieee_f32
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.training.data import synthetic_batches
from kfac_pytorch_tpu_torch.training.schedules import create_lr_schedule
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
)

NUM_CLASSES = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="CIFAR-10 K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--synthetic", action="store_true", help="use synthetic data")
    p.add_argument("--model", default="resnet32", help="cifar resnet variant")
    p.add_argument("--batch-size", type=int, default=128, help="per-device train batch size")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps-per-epoch", type=int, default=None, help="cap steps (synthetic/smoke)")
    p.add_argument("--base-lr", type=float, default=0.1, help="per-device lr (scaled by world)")
    p.add_argument("--lr-decay", nargs="+", type=int, default=[35, 75, 90])
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--kfac-update-freq", type=int, default=10, help="0 disables K-FAC")
    p.add_argument("--kfac-cov-update-freq", type=int, default=1)
    p.add_argument("--stat-decay", type=float, default=0.95)
    p.add_argument("--damping", type=float, default=0.003)
    p.add_argument("--damping-alpha", type=float, default=0.5)
    p.add_argument("--damping-schedule", nargs="+", type=int, default=[40, 80])
    p.add_argument("--kl-clip", type=float, default=0.001)
    p.add_argument("--factor-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="conv A-factor statistics: kernel = the CUDA patch-"
                        "covariance kernel, dense = im2col oracle, auto = the "
                        "kernel on CUDA tensors, its plain version on CPU ones")
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit(
            "only --synthetic data is ported so far (CIFAR-10 loading is "
            "ROADMAP queue 1 item 4)"
        )
    device = resolve_device(args.device)
    use_ieee_f32()
    world = 1
    model = cifar_resnet.get_model(
        args.model, num_classes=NUM_CLASSES,
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)

    use_kfac = args.kfac_update_freq > 0
    lr_base = args.base_lr * world
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    kfac = None
    kfac_sched = None
    if use_kfac:
        kfac = KFAC(
            layers=capture.discover_layers(model),
            lr=lr_base,
            factor_decay=args.stat_decay,
            damping=args.damping,
            kl_clip=args.kl_clip,
            fac_update_freq=args.kfac_cov_update_freq,
            kfac_update_freq=args.kfac_update_freq,
            factor_kernel=args.factor_kernel,
            apply_kernel=args.apply_kernel,
            device=device,
        )
        kfac_sched = KFACParamScheduler(
            kfac,
            damping_alpha=args.damping_alpha,
            damping_schedule=args.damping_schedule,
        )

    params = dict(model.named_parameters())
    state = TrainState(
        step=0,
        model=model,
        opt_state=tx.init(params),
        kfac_state=kfac.init(model) if kfac else None,
    )
    train_step = make_train_step(
        model, tx, kfac,
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
    )
    lr_factor = create_lr_schedule(world, args.warmup_epochs, args.lr_decay)
    steps_per_epoch = args.steps_per_epoch or 50

    history: Dict[str, List] = {"loss": [], "kind": [], "step_ms": []}
    step = 0
    for epoch in range(args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        batches = synthetic_batches(
            args.batch_size, (3, 32, 32), NUM_CLASSES, steps_per_epoch, seed=args.seed
        )
        t0 = time.perf_counter()
        losses = []
        for i, (xb, yb) in enumerate(batches):
            lr = lr_base * lr_factor(epoch + i / steps_per_epoch)
            damping = kfac.hparams.damping if kfac else 0.0
            flags = kfac_flags_for_step(step, kfac, epoch)
            images = torch.from_numpy(xb).to(device, non_blocking=True)
            labels = torch.from_numpy(yb).to(device, non_blocking=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ts = time.perf_counter()
            state, metrics = train_step(state, (images, labels), lr, damping, **flags)
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
