"""Full-split masked validation over ImageNet ``.npy`` shards.

Port of ``kfac_pytorch_tpu/training/evaluation.py::run_imagenet_validation``,
shared by the ImageNet trainer's per-epoch evaluation and
``examples/evaluate.py``. Three input modes, as in the JAX package: shards
stored at the crop size pass through (uint8 is still decoded and
normalized: re-running Resize + CenterCrop would zoom-crop them twice);
others take Resize(``val_resize``) + CenterCrop(``image_size``), the
reference's validation transform, in numpy on the host or, with
``num_workers > 0``, on the native loader's threads
(``runtime.native_transform``). The eval step's masked sums cover the
ragged last batch. Data-parallel, each rank evaluates its interleaved
shard (``data.eval_batches(num_shards, shard_index)``) and the sums are
added up over the ranks.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.runtime import native_transform
from kfac_pytorch_tpu_torch.training import data as data_lib


def evaluate_split(eval_step: Callable, state, batches, device: torch.device,
                   world: World = World()) -> Tuple[float, float, float]:
    """``(loss sum, correct, count)`` of ``eval_step`` (``training.step.
    make_masked_eval_step``'s) over ``batches`` of ``(images, labels,
    mask)``, added up over the ranks, read from the device once."""
    sums = torch.zeros(3, dtype=torch.float32, device=device)
    for xb, yb, mb in batches:
        m = eval_step(state, (
            torch.from_numpy(xb).to(device),
            torch.from_numpy(np.asarray(yb, np.int64)).to(device),
            torch.from_numpy(mb).to(device),
        ))
        sums = sums + torch.stack([m["loss_sum"], m["correct"], m["count"]])
    loss_sum, correct, count = world.all_reduce_sum_(sums).tolist()
    return loss_sum, correct, count


def run_imagenet_validation(
    eval_step: Callable,
    state,
    x_val: np.ndarray,
    y_val: np.ndarray,
    *,
    image_size: int,
    val_resize: int,
    batch_size: int,
    device: torch.device,
    world: World = World(),
    num_workers: int = 0,
) -> Tuple[float, float, float]:
    """Evaluate the whole val split (NHWC shards); returns ``(mean loss,
    top-1 accuracy, images counted)``. ``batch_size`` is per rank;
    ``num_workers > 0`` runs Resize + CenterCrop on the native loader."""
    im = image_size
    passthrough = tuple(x_val.shape[1:3]) == (im, im)
    norm = (
        dict(mean=data_lib.IMAGENET_MEAN, std=data_lib.IMAGENET_STD)
        if x_val.dtype == np.uint8 else {}
    )

    def batches():
        for xb, yb, mb in data_lib.eval_batches(
            x_val, y_val, batch_size, num_shards=world.size, shard_index=world.rank
        ):
            if passthrough:
                xb = data_lib.normalize_imagenet(xb)
            elif num_workers > 0:
                xb = native_transform(xb, (im, im), mode="centercrop",
                                      resize_size=val_resize,
                                      num_workers=num_workers, **norm)
            else:
                xb = data_lib.imagenet_eval_transform(xb, im, resize_size=val_resize)
            yield xb, yb, mb

    loss_sum, correct, count = evaluate_split(eval_step, state, batches(), device, world)
    if count == 0:
        raise ValueError(
            "no validation examples found (empty val split) — check the "
            "--data-dir layout"
        )
    return loss_sum / count, correct / count, count
