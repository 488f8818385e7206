"""Full-split masked validation over ImageNet ``.npy`` shards.

Port of ``kfac_pytorch_tpu/training/evaluation.py::run_imagenet_validation``,
shared by the ImageNet trainer's per-epoch evaluation and
``examples/evaluate.py``. Three input modes, as in the JAX package: shards
stored at the crop size pass through (uint8 is still decoded and
normalized: re-running Resize + CenterCrop would zoom-crop them twice);
others take Resize(``val_resize``) + CenterCrop(``image_size``), the
reference's validation transform, in numpy on the host. The JAX package's
native-loader branch is ROADMAP queue 1 item 9. The eval step's masked sums
cover the ragged last batch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from kfac_pytorch_tpu_torch.training import data as data_lib


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
) -> Tuple[float, float, float]:
    """Evaluate the whole val split (NHWC shards); returns ``(mean loss,
    top-1 accuracy, images counted)``, the sums read from the device once.
    ``eval_step`` is ``training.step.make_masked_eval_step``'s."""
    im = image_size
    passthrough = tuple(x_val.shape[1:3]) == (im, im)
    sums = None
    for xb, yb, mb in data_lib.eval_batches(x_val, y_val, batch_size):
        if passthrough:
            xb = data_lib.normalize_imagenet(xb)
        else:
            xb = data_lib.imagenet_eval_transform(xb, im, resize_size=val_resize)
        m = eval_step(state, (
            torch.from_numpy(xb).to(device),
            torch.from_numpy(np.asarray(yb, np.int64)).to(device),
            torch.from_numpy(mb).to(device),
        ))
        part = torch.stack([m["loss_sum"], m["correct"], m["count"]])
        sums = part if sums is None else sums + part
    loss_sum, correct, count = sums.tolist() if sums is not None else (0.0, 0.0, 0.0)
    if count == 0:
        raise ValueError(
            "no validation examples found (empty val split) — check the "
            "--data-dir layout"
        )
    return loss_sum / count, correct / count, count
