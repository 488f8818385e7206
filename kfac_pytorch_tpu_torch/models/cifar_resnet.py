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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update.

    ``momentum=0.1`` here is flax's ``momentum=0.9`` (the weight on the
    batch, not on history).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y


class BasicBlock(nn.Module):
    """Two 3×3 convs + BN with an option-A (parameter-free) shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = KFACConv(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = KFACConv(planes, planes, 3, padding=1, bias=False)
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

    def __init__(self, num_blocks: int, num_classes: int = 10):
        super().__init__()
        self.conv1 = KFACConv(3, 16, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(16)
        in_planes = 16
        for stage, planes in enumerate((16, 32, 64)):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(BasicBlock(in_planes, planes, stride))
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
) -> CifarResNet:
    """Factory by name (the CLI's ``--model``), built on the CPU from
    ``generator`` (seed 0 when none is given)."""
    if name not in _DEPTHS:
        raise ValueError(f"unknown cifar model {name!r}; options: {sorted(_DEPTHS)}")
    model = CifarResNet(_DEPTHS[name], num_classes)
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
