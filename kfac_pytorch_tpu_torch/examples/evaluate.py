"""Evaluate an ImageNet ResNet checkpoint on the full val split (PyTorch port).

Twin of the JAX package's ``examples/evaluate.py``: validate a migrated
reference checkpoint (``--init-from-torch``) or the newest of this port's
checkpoints (``--checkpoint-dir``, the ImageNet trainer's torch-format
``checkpoint-<epoch>`` files, weights only) on ``val_x.npy``/``val_y.npy``
in ``--data-dir``, without a training epoch: Resize(``--val-resize``) +
CenterCrop(``--image-size``) on the native loader's ``--num-workers``
threads (4 by default, as in the JAX package), or in numpy on the host
with ``--num-workers 0`` (shards stored at the crop size pass through),
the ragged last batch masked (``training/evaluation.py``). Under
``torchrun`` each rank evaluates its interleaved shard of the split and
rank 0 prints the sums over the ranks.

    python -m kfac_pytorch_tpu_torch.examples.evaluate --data-dir /path/to/shards \\
        --model resnet50 --init-from-torch checkpoint-54.pth.tar
    python -m kfac_pytorch_tpu_torch.examples.evaluate --data-dir /path/to/shards \\
        --model resnet50 --checkpoint-dir ./checkpoints

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. ``main()`` returns ``(loss, top-1 accuracy)``.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

from kfac_pytorch_tpu_torch import interop
from kfac_pytorch_tpu_torch.device import use_ieee_f32
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.evaluation import run_imagenet_validation
from kfac_pytorch_tpu_torch.training.step import TrainState, make_masked_eval_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True, help="npy shard dir (val_x/val_y)")
    p.add_argument("--model", default="resnet50", choices=sorted(imagenet_resnet._MODELS))
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir (newest epoch is evaluated)")
    p.add_argument("--init-from-torch", default=None,
                   help="reference/torchvision checkpoint (.pth/.pth.tar)")
    p.add_argument("--batch-size", type=int, default=256, help="per-device")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--val-resize", type=int, default=256)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--num-workers", type=int, default=4,
                   help="native loader threads (0 = the numpy transform)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.num_workers < 0:
        raise SystemExit("--num-workers must be at least 0")
    return args


def main(argv=None) -> Tuple[float, float]:
    args = parse_args(argv)
    if bool(args.checkpoint_dir) == bool(args.init_from_torch):
        raise SystemExit("give exactly one of --checkpoint-dir or --init-from-torch")
    if args.val_resize < args.image_size:
        raise SystemExit(
            f"--val-resize ({args.val_resize}) must be >= --image-size "
            f"({args.image_size}): Resize(shorter side) must cover the "
            "CenterCrop (the transform would replicate borders and report "
            "plausible but wrong metrics otherwise)"
        )
    device = launch.initialize(args.device)
    use_ieee_f32()
    world = data_parallel_world()
    x_val = np.load(os.path.join(args.data_dir, "val_x.npy"), mmap_mode="r")
    y_val = np.load(os.path.join(args.data_dir, "val_y.npy"))
    model = imagenet_resnet.get_model(args.model)
    if args.init_from_torch:
        interop.init_from_torch_checkpoint(args.init_from_torch, model, args.model)
        source = args.init_from_torch
    else:
        epoch = ckpt.latest_epoch(args.checkpoint_dir)
        if epoch is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
        model.load_state_dict(ckpt.restore_weights_only(args.checkpoint_dir, epoch))
        source = f"{args.checkpoint_dir} (epoch {epoch})"
    model.to(device)
    # weights only: the eval step reads the model, not the optimizer or K-FAC
    state = TrainState(step=0, model=model, opt_state={})
    eval_step = make_masked_eval_step(model, label_smoothing=args.label_smoothing)
    loss, acc, _ = run_imagenet_validation(
        eval_step, state, x_val, y_val, image_size=args.image_size,
        val_resize=args.val_resize, batch_size=args.batch_size, device=device,
        world=world, num_workers=args.num_workers,
    )
    if launch.is_primary():
        print(f"{args.model} from {source}: "
              f"val loss={loss:.4f} top1={acc:.4f} ({len(y_val)} images)")
    return loss, acc


if __name__ == "__main__":
    main()
