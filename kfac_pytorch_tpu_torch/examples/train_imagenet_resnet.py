"""ImageNet ResNet training with K-FAC on one GPU or data-parallel (PyTorch port).

Twin of the JAX package's ``examples/train_imagenet_resnet.py``: the same flags with the same defaults for what the port carries
(the nine architectures, grouped-conv K-FAC for ResNeXt, label smoothing,
the warmup/step LR schedule, the damping and update-frequency schedules of
``KFACParamScheduler``, gradient accumulation ``--batches-per-allreduce``,
``--precond-method``, the bfloat16 modes ``--bf16``, ``--eigen-dtype`` and
``--precond-precision``, ``scalars.jsonl`` under ``--log-dir``, checkpoints
with auto-resume under ``--checkpoint-dir``, ``--init-from-torch``), the
same data and K-FAC gating (``--kfac-update-freq 0`` is plain SGD).

Data: numpy shards in ``--data-dir`` (``train_x.npy``/``train_y.npy``/
``val_x.npy``/``val_y.npy``, NHWC uint8 raw pixels stored at e.g. 256×256,
or float32 pre-normalized; ``scripts/make_imagenet_shards.py``'s layout),
read memory-mapped. Training takes RandomResizedCrop + flip (``rrc``);
with ``--no-augment``, shards stored at the crop size pass through
(``none``: uint8 still decodes and normalizes) and others take Resize
(``--val-resize``) + CenterCrop (``centercrop``). The whole val split is
evaluated after each epoch (Resize + CenterCrop, ``--val-batch-size``, the
ragged last batch masked). The transforms run on the native threaded
loader (``runtime/loader.py``, ``--num-workers`` threads, 4 by default, as
in the JAX trainer), or with ``--num-workers 0`` in numpy on the host.
Data-parallel under ``torchrun`` it takes the CIFAR twin's flags and rules
(``--distribute-precondition``, ``--distribute-layer-factors``,
``--precond-comm-dtype``, ``--grad-comm-dtype``; ``--batch-size`` per
device, the learning rate times the world size, each rank its interleaved
shard, rank 0 logging and writing). Without shards (or with ``--synthetic``) it trains on
synthetic batches. ``--profile-epoch N`` writes a ``torch.profiler``
Chrome trace of epoch N into ``--log-dir``; the twin takes every flag of
the JAX trainer. ``--log-dir`` and ``--checkpoint-dir`` default
to none here (the JAX trainer's defaults are ``./logs`` and
``./checkpoints``): a run writes nothing it was not asked to.

    python -m kfac_pytorch_tpu_torch.examples.train_imagenet_resnet \\
        --data-dir /path/to/shards --model resnet50 --epochs 55
    python -m kfac_pytorch_tpu_torch.examples.train_imagenet_resnet \\
        --synthetic --model resnext50_32x4d --epochs 1 --steps-per-epoch 30

On a CUDA device outside any process group the train step runs as CUDA
graphs, one captured per step variant and replayed
(``training.graphs.GraphedTrainStep``, the JAX trainer's jitted step;
``history["compiled_step"]`` records the captures); a process group and
``--precond-method inverse`` run the eager step
(``training.graphs.eager_step_reason``), which it names once. As in the
JAX trainer, no recompile monitor watches it.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns the history: per step the loss,
accuracy, step kind, wall milliseconds measured around a synchronized step
and, on shards, the host milliseconds to get each batch (the numpy
transform, or the wait for the native loader); per
epoch the validation loss, accuracy and image count and the evaluation's
milliseconds; the restore milliseconds of a resume.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture, interop
from kfac_pytorch_tpu_torch.device import use_ieee_f32
from kfac_pytorch_tpu_torch.training import profiling
from kfac_pytorch_tpu_torch.examples.train_cifar10_resnet import (
    add_parallel_flags,
    add_precision_flags,
    grad_comm_dtype,
    parallel_kwargs,
    precision_kwargs,
    rank0_print,
)
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import World, data_parallel_world, put_global_batch
from kfac_pytorch_tpu_torch.runtime import NativeEpochLoader
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training import data as data_lib
from kfac_pytorch_tpu_torch.training.evaluation import run_imagenet_validation
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
    kfac_flags_for_step,
    make_masked_eval_step,
    make_sgd,
    make_train_step,
)

NUM_CLASSES = 1000

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ImageNet K-FAC Example (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--data-dir", default=None, help="numpy-shard data dir")
    p.add_argument("--synthetic", action="store_true", help="use synthetic data")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--val-resize", type=int, default=256,
                   help="eval shorter-side resize before the center crop")
    p.add_argument("--no-augment", action="store_true",
                   help="disable train augmentation (pass shards through)")
    p.add_argument("--log-dir", default=None, help="scalars.jsonl dir")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (enables save/resume)")
    p.add_argument("--model", default="resnet50", choices=sorted(imagenet_resnet._MODELS))
    p.add_argument("--batch-size", type=int, default=32, help="per-device")
    p.add_argument("--batches-per-allreduce", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step")
    p.add_argument("--val-batch-size", type=int, default=32)
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
    p.add_argument("--init-from-torch", default=None,
                   help="initialize model weights from a reference/torchvision "
                        "ResNet checkpoint (.pth/.pth.tar, bare state_dict or "
                        "the reference's {'model': ...} wrapper); optimizer "
                        "and K-FAC state start fresh")
    p.add_argument("--precond-method", default="eigen", choices=["eigen", "inverse"],
                   help="eigen: eigenbasis solve (damping fresh every step); "
                        "inverse: pi-corrected factored damping + Cholesky "
                        "inverses (the dense apply: no fused apply kernel)")
    add_precision_flags(p)
    add_parallel_flags(p)
    p.add_argument("--factor-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="conv A-factor statistics: kernel = the CUDA patch-"
                        "covariance kernels (grouped convs: one launch per "
                        "layer), dense = im2col oracle, auto = the kernels on "
                        "CUDA tensors, their plain versions on CPU ones")
    p.add_argument("--apply-kernel", default="auto", choices=["auto", "kernel", "dense"],
                   help="preconditioned apply + SGD: kernel = the fused CUDA "
                        "kernels, dense = matmul-chain + per-leaf SGD oracle, "
                        "auto = the kernels on CUDA tensors")
    p.add_argument("--profile-epoch", type=int, default=None,
                   help="capture a torch.profiler trace of this epoch into "
                        "--log-dir (profile_trace.json, Chrome format)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.batches_per_allreduce < 1:
        raise SystemExit("--batches-per-allreduce must be at least 1")
    if args.num_workers < 0:
        raise SystemExit("--num-workers must be at least 0")
    return args


def build(args, device: torch.device, world: World = World()):
    """``(model, kfac, state, train_step)`` for parsed ``args`` on
    ``device`` over ``world``; ``kfac`` is ``None`` at
    ``--kfac-update-freq 0``."""
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
            lr=args.base_lr * world.size,
            factor_decay=args.stat_decay,
            damping=args.damping,
            kl_clip=args.kl_clip,
            fac_update_freq=args.kfac_cov_update_freq,
            kfac_update_freq=args.kfac_update_freq,
            diag_blocks=args.diag_blocks,
            diag_warmup=args.diag_warmup,
            precond_method=args.precond_method,
            **precision_kwargs(args),
            **parallel_kwargs(args),
            factor_kernel=args.factor_kernel,
            apply_kernel=args.apply_kernel,
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
        # tx IS make_sgd(momentum, wd): with K-FAC the optimizer step runs
        # through the fused SGD kernel
        sgd_hyper=(args.momentum, args.wd) if kfac is not None else None,
        label_smoothing=args.label_smoothing,
        accum_steps=args.batches_per_allreduce,
        world=world,
        grad_comm_dtype=grad_comm_dtype(args),
    )
    return model, kfac, state, train_step


def _npy_shards(data_dir: str, split: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(x, y)`` of ``{split}_x.npy``/``{split}_y.npy`` (images memory-mapped),
    or ``None`` when either file is missing."""
    xp = os.path.join(data_dir, f"{split}_x.npy")
    yp = os.path.join(data_dir, f"{split}_y.npy")
    if os.path.isfile(xp) and os.path.isfile(yp):
        return np.load(xp, mmap_mode="r"), np.load(yp)
    return None


def train_mode(x_train: np.ndarray, image_size: int, augment: bool) -> str:
    """The train transform: ``rrc`` (RandomResizedCrop + flip) with
    augmentation; without it, ``none`` for shards stored at the crop size
    and ``centercrop`` (Resize + CenterCrop) for others."""
    if augment:
        return "rrc"
    return "none" if tuple(x_train.shape[1:3]) == (image_size, image_size) else "centercrop"


def shard_batches(x_train, y_train, batch: int, steps: int, mode: str, image_size: int,
                  val_resize: int, seed: int, transform_ms: List[float],
                  num_shards: int = 1, shard_index: int = 0, accum: int = 1):
    """One epoch of ``steps`` NCHW float32 batches of ``batch · accum``
    images for rank ``shard_index`` of ``num_shards`` (the JAX trainer's
    numpy path): the seeded permutation of the whole global batches'
    images (``batch · num_shards`` each), the rank's interleaved slice of
    it, each batch's indices sorted (memory-map friendly), then its
    transform with the same ``RandomState``; the host milliseconds of each
    batch's read and transform go to ``transform_ms``."""
    rng = np.random.RandomState(seed)
    global_bs = batch * num_shards
    order = rng.permutation(len(x_train) // global_bs * global_bs)[shard_index::num_shards]
    n = batch * accum
    for b in range(steps):
        t0 = time.perf_counter()
        take = np.sort(order[b * n:(b + 1) * n])
        xb, yb = x_train[take], np.asarray(y_train[take], np.int32)
        if mode == "rrc":
            xb = data_lib.imagenet_train_augment(xb, image_size, rng)
        elif mode == "centercrop":
            xb = data_lib.imagenet_eval_transform(xb, image_size, resize_size=val_resize)
        else:
            xb = data_lib.normalize_imagenet(xb)
        transform_ms.append((time.perf_counter() - t0) * 1e3)
        yield xb, yb


def timed(batches, steps: int, wait_ms: List[float]):
    """The first ``steps`` of ``batches``, the host milliseconds spent
    waiting for each appended to ``wait_ms``."""
    it = iter(batches)
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            return
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        yield batch


def main(argv=None) -> Dict[str, List]:
    args = parse_args(argv)
    if args.val_resize < args.image_size:
        raise SystemExit(
            f"--val-resize ({args.val_resize}) must be >= --image-size "
            f"({args.image_size}): Resize(shorter side) must cover the "
            "CenterCrop (the transform stack replicates borders otherwise, "
            "silently diverging from the reference's torchvision behavior)"
        )
    device = launch.initialize(args.device)
    use_ieee_f32()
    world = data_parallel_world()
    accum = args.batches_per_allreduce
    model, kfac, state, train_step = build(args, device, world)
    if args.init_from_torch:
        interop.init_from_torch_checkpoint(args.init_from_torch, model, args.model)
        rank0_print(f"initialized weights from torch checkpoint {args.init_from_torch}")
    history: Dict[str, List] = {
        "loss": [], "accuracy": [], "kind": [], "step_ms": [], "transform_ms": [],
        "val_loss": [], "val_accuracy": [], "val_count": [], "eval_ms": [], "restore_ms": [],
    }
    resume_from_epoch = 0
    if args.checkpoint_dir:
        t0 = time.perf_counter()
        state, resume_from_epoch = ckpt.auto_resume(args.checkpoint_dir, state)
        if resume_from_epoch and args.init_from_torch:
            raise SystemExit(
                f"--init-from-torch was given but {args.checkpoint_dir} "
                f"holds an epoch-{resume_from_epoch - 1} checkpoint that "
                "auto-resume just restored over the migrated weights; "
                "point --checkpoint-dir at a fresh directory to start from "
                "the torch checkpoint, or drop --init-from-torch to resume"
            )
        if resume_from_epoch:
            history["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            rank0_print(f"resumed from epoch {resume_from_epoch - 1}")
    # every rank starts from rank 0's state (hvd.broadcast_parameters)
    ckpt.broadcast_state(state, world)
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
    eval_step = make_masked_eval_step(model, label_smoothing=args.label_smoothing)
    train_step, budget = compiled_step(train_step, kfac, device,
                                       eager_step_reason(args, world, device))
    lr_base = args.base_lr * world.size
    lr_factor = create_lr_schedule(world.size, args.warmup_epochs, args.lr_decay)
    im = args.image_size
    use_shards = not args.synthetic and args.data_dir
    train_data = _npy_shards(args.data_dir, "train") if use_shards else None
    val_data = _npy_shards(args.data_dir, "val") if use_shards else None
    global_bs = args.batch_size * world.size
    loader = None
    if train_data is not None:
        x_train, y_train = train_data
        mode = train_mode(x_train, im, not args.no_augment)
        steps_per_epoch = len(x_train) // (global_bs * accum)
        if args.num_workers > 0:
            norm = (dict(mean=data_lib.IMAGENET_MEAN, std=data_lib.IMAGENET_STD)
                    if x_train.dtype == np.uint8 else {})
            loader = NativeEpochLoader(
                x_train, y_train, args.batch_size * accum, shuffle=True,
                num_shards=world.size, shard_index=world.rank, mode=mode,
                out_size=(im, im), resize_size=args.val_resize, copy=False,
                num_workers=args.num_workers, **norm,
            )
        rank0_print(
            f"ImageNet shards: {len(x_train)} train / "
            f"{len(val_data[0]) if val_data else 0} val, stored "
            f"{tuple(x_train.shape[1:3])} {x_train.dtype}, train={mode} "
            f"({'native' if loader else 'numpy'} pipeline)"
        )
    else:
        if not args.synthetic:
            rank0_print("no data found; falling back to --synthetic")
        steps_per_epoch = args.steps_per_epoch or 100
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    writer = ScalarWriter(args.log_dir if launch.is_primary() else None)

    step = state.step
    for epoch in range(resume_from_epoch, args.epochs):
        if kfac_sched:
            kfac_sched.step(epoch=epoch)
        if loader is not None:
            batches = timed(loader.epoch(args.seed + epoch), steps_per_epoch,
                            history["transform_ms"])
        elif train_data is not None:
            batches = shard_batches(
                x_train, y_train, args.batch_size, steps_per_epoch, mode, im,
                args.val_resize, args.seed + epoch, history["transform_ms"],
                num_shards=world.size, shard_index=world.rank, accum=accum,
            )
        else:
            batches = data_lib.synthetic_batches(
                args.batch_size * accum, (3, im, im), NUM_CLASSES, steps_per_epoch,
                seed=args.seed,
            )
        t0 = time.perf_counter()
        loss_m, acc_m = Metric("train/loss"), Metric("train/accuracy")
        with profiling.maybe_trace(args.log_dir, args.profile_epoch == epoch, device):
            for i, (xb, yb) in enumerate(batches):
                lr = lr_base * lr_factor(epoch + i / steps_per_epoch)
                flags = kfac_flags_for_step(step, kfac, epoch)
                images, labels = put_global_batch((xb, yb), device, accum)
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
        rank0_print(
            f"epoch {epoch}: loss={loss_m.avg:.4f} acc={acc_m.avg:.4f} lr={lr:.4f} "
            f"{steps_per_epoch * global_bs * accum / dt:.0f} img/s ({dt:.1f}s)"
        )
        writer.add_scalar("train/loss", loss_m.avg, epoch)
        writer.add_scalar("train/accuracy", acc_m.avg, epoch)
        writer.add_scalar("train/lr", lr, epoch)
        if val_data is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            te = time.perf_counter()
            val_loss, val_acc, count = run_imagenet_validation(
                eval_step, state, *val_data, image_size=im, val_resize=args.val_resize,
                batch_size=args.val_batch_size, device=device, world=world,
                num_workers=args.num_workers,
            )
            history["eval_ms"].append((time.perf_counter() - te) * 1e3)
            history["val_loss"].append(val_loss)
            history["val_accuracy"].append(val_acc)
            history["val_count"].append(count)
            rank0_print(f"  val: loss={val_loss:.4f} acc={val_acc:.4f}")
            writer.add_scalar("val/loss", val_loss, epoch)
            writer.add_scalar("val/accuracy", val_acc, epoch)
        if args.checkpoint_dir:
            ckpt.save_checkpoint(args.checkpoint_dir, epoch, state)
    writer.close()
    if loader is not None:
        loader.close()
    if isinstance(train_step, GraphedTrainStep):
        history["compiled_step"] = compiled_record(train_step, budget)
    return history


if __name__ == "__main__":
    main()
