"""CIFAR ResNets (20/32/44/56/110/1202) with option-A shortcuts, NCHW.

Port of ``kfac_pytorch_tpu/models/cifar_resnet.py`` with the reference
zoo's module names (``conv1``/``bn1``, ``layer{s}.{i}.conv{j}``/``bn{j}``,
``linear``), so a state_dict maps one to one onto the JAX tree
(``interop.state_dict_from_jax``): 3×3 stem, three stages of widths
16/32/64 with n blocks each (depth = 6n + 2), parameter-free option-A
shortcuts (stride-2 subsample + zero channel padding), bias-free convs,
a dense head with bias.

BatchNorm follows ``flax.linen.BatchNorm`` as the JAX model uses it:
training normalizes with the biased batch statistics and the running
buffers take ``0.9·running + 0.1·batch`` with the BIASED batch variance
(PyTorch's own update uses the unbiased one), so the module updates its
buffers itself.

Data-parallel, BatchNorm takes the JAX package's two routes:
:func:`global_batchnorm` makes every ``BatchNorm2d`` of a model normalize
over the global batch (the ranks' per-channel sums and sums of squares
added up, the backward carried across the ranks: sync-BN, what flax does
under the JAX package's default GSPMD step), and without it each rank
normalizes over its own batch (its ``grad_comm_dtype`` route, where the
train step averages the running statistics over the ranks).

``dtype`` (the flax model's; ``--bf16`` passes ``torch.bfloat16``) is the
compute type of the convs and BatchNorm: activations flow in it from the
stem conv to the mean pool, the head takes them in float32, and every
parameter and BatchNorm buffer stays float32. BatchNorm in bfloat16
computes its statistics and the normalization in float32 and returns
bfloat16, as flax's does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
from kfac_pytorch_tpu_torch.parallel.mesh import World


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update.

    ``momentum=0.1`` here is flax's ``momentum=0.9`` (the weight on the
    batch, not on history). ``sync_world``, set by :func:`global_batchnorm`,
    makes training normalize over the global batch of that world's ranks.
    """

    sync_world: Optional[World] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bfloat16 x normalizes in float32 (float32 weight and statistics)
        # and comes back bfloat16
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if self.sync_world is not None and self.sync_world.size > 1:
            y, mean, var = self._global_batch_norm(x, self.sync_world)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor, world: World):
        """flax's statistics over the ranks' batches together (each rank's
        batch the same size): ``mean = Σx / N``, ``var = max(0, Σx² / N −
        mean²)``, the sums added up over the ranks with their gradient;
        returns ``(y, mean, var)``."""
        xf = x.float()
        n = xf.numel() // xf.shape[1] * world.size
        sums = world.sum_with_grad(torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        y = y + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


@contextlib.contextmanager
def global_batchnorm(model: nn.Module, world: World) -> Iterator[None]:
    """Inside the block every :class:`BatchNorm2d` of ``model`` normalizes
    in training over the global batch of ``world``'s ranks (no effect on a
    world of one); restored on exit."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.sync_world = world
    try:
        yield
    finally:
        for m in bns:
            m.sync_world = None


class BasicBlock(nn.Module):
    """Two 3×3 convs + BN with an option-A (parameter-free) shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = KFACConv(in_planes, planes, 3, stride=stride, padding=1, bias=False,
                              compute_dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = KFACConv(planes, planes, 3, padding=1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.stride = stride
        self.pad = planes - in_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.stride != 1 or self.pad:
            sc = x[:, :, :: self.stride, :: self.stride]
            sc = F.pad(sc, (0, 0, 0, 0, self.pad // 2, self.pad - self.pad // 2))
        else:
            sc = x
        return F.relu(y + sc)


class CifarResNet(nn.Module):
    """Stem + 3 stages + global-avg-pool + dense head."""

    def __init__(self, num_blocks: int, num_classes: int = 10,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = KFACConv(3, 16, 3, padding=1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(16)
        in_planes = 16
        for stage, planes in enumerate((16, 32, 64)):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(BasicBlock(in_planes, planes, stride, dtype))
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.linear = KFACDense(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = x.mean(dim=(2, 3))
        return self.linear(x.float())


def _he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``he_normal``: truncated normal at ±2σ, variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """He-normal convs and head, zero biases, unit BN scales, drawn from
    ``generator`` (weights are made on the CPU, then moved)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _he_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.Linear):
            _he_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


_DEPTHS = {"resnet20": 3, "resnet32": 5, "resnet44": 7, "resnet56": 9,
           "resnet110": 18, "resnet1202": 200}


def get_model(
    name: str,
    num_classes: int = 10,
    generator: Optional[torch.Generator] = None,
    dtype: Optional[torch.dtype] = None,
) -> CifarResNet:
    """Factory by name (the CLI's ``--model``), built on the CPU from
    ``generator`` (seed 0 when none is given), computing in ``dtype``."""
    if name not in _DEPTHS:
        raise ValueError(f"unknown cifar model {name!r}; options: {sorted(_DEPTHS)}")
    model = CifarResNet(_DEPTHS[name], num_classes, dtype)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model


def resnet20(**kw) -> CifarResNet:
    return get_model("resnet20", **kw)


def resnet32(**kw) -> CifarResNet:
    return get_model("resnet32", **kw)


def resnet44(**kw) -> CifarResNet:
    return get_model("resnet44", **kw)


def resnet56(**kw) -> CifarResNet:
    return get_model("resnet56", **kw)


def resnet110(**kw) -> CifarResNet:
    return get_model("resnet110", **kw)


def resnet1202(**kw) -> CifarResNet:
    return get_model("resnet1202", **kw)
