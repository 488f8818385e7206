"""ImageNet ResNets: v1.5 ResNet-18/34/50/101/152, ResNeXt, WideResNet, NCHW.

Port of ``kfac_pytorch_tpu/models/imagenet_resnet.py`` with torchvision's
module names (``conv1``/``bn1``, ``layer{s}.{i}.conv{j}``/``bn{j}``,
``layer{s}.{i}.downsample.0``/``.1``, ``fc``), the names the JAX package's
``torch_interop.py`` maps from, so ``interop.imagenet_state_dict_from_jax``
carries a flax tree over one to one:

* 7×7/2 stem, BatchNorm, ReLU, 3×3/2 max pool with padding 1 (PyTorch pads
  a max pool with −inf, as flax does);
* BasicBlock (two 3×3) or Bottleneck (1×1 → 3×3 → 1×1·4, v1.5: the stride
  on the 3×3, which also carries the groups of ResNeXt);
* a 1×1 conv + BatchNorm downsample where the stride or the width changes;
* a global mean pool and a ``KFACDense`` head with bias.

Every conv, grouped included, is a bias-free ``KFACConv``; a grouped conv
is preconditioned as G Kronecker pairs (``capture.py``'s ``#g``
pseudo-layers). BatchNorm is ``cifar_resnet.BatchNorm2d``, flax's
running-statistics update. Weights are drawn on the CPU from an explicit
``torch.Generator``: convs Kaiming-normal with fan-out (the JAX model's
``variance_scaling(2, "fan_out", "normal")``), the head flax's default
LeCun-normal (truncated at ±2σ), zero biases, unit BatchNorm scales.
``dtype`` is the compute type of every conv (grouped included) and
BatchNorm, as in ``cifar_resnet``: the head takes float32, parameters and
buffers stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Type, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.models.cifar_resnet import BatchNorm2d
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense


def _conv(cin, cout, k, stride=1, padding=0, groups=1, dtype=None) -> KFACConv:
    return KFACConv(cin, cout, k, stride=stride, padding=padding, groups=groups, bias=False,
                    compute_dtype=dtype)


def _downsample(cin: int, cout: int, stride: int, dtype=None) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride, dtype=dtype), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """Two 3×3 convs + BN (``base_width``/``groups`` unused, as in JAX)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 64, groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        del base_width, groups
        self.conv1 = _conv(in_planes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(in_planes, planes, stride, dtype) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = self.downsample(x) if self.downsample is not None else x
        return F.relu(y + sc)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride, groups) → 1×1·4; v1.5 puts the stride on the 3×3."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 64, groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = _conv(in_planes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups, dtype=dtype)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, out, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(in_planes, out, stride, dtype) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = self.downsample(x) if self.downsample is not None else x
        return F.relu(y + sc)


Block = Union[Type[BasicBlock], Type[Bottleneck]]


class ImageNetResNet(nn.Module):
    """Stem + ``len(stage_sizes)`` stages of widths 64·2ˢ + mean pool + head."""

    def __init__(self, block: Block, stage_sizes: Sequence[int], num_classes: int = 1000,
                 groups: int = 1, width_per_group: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        in_planes = 64
        for stage, blocks in enumerate(stage_sizes):
            planes = 64 * 2**stage
            layers = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                downsample = stride != 1 or in_planes != planes * block.expansion
                layers.append(block(in_planes, planes, stride, downsample,
                                    width_per_group, groups, dtype))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.num_stages = len(stage_sizes)
        self.fc = KFACDense(in_planes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x.float())


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX model's initializers, drawn from ``generator`` (on the CPU)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            # fan-out = out channels × kernel area, grouped or not
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


# name -> (block, stage sizes, groups, width per group)
_MODELS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


def get_model(
    name: str,
    num_classes: int = 1000,
    generator: Optional[torch.Generator] = None,
    dtype: Optional[torch.dtype] = None,
) -> ImageNetResNet:
    """Factory by name (the CLI's ``--model``), built on the CPU from
    ``generator`` (seed 0 when none is given), computing in ``dtype``."""
    if name not in _MODELS:
        raise ValueError(f"unknown imagenet model {name!r}; options: {sorted(_MODELS)}")
    block, sizes, groups, width = _MODELS[name]
    model = ImageNetResNet(block, sizes, num_classes, groups, width, dtype)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model
