"""Carry CIFAR ResNet weights from the JAX package's trees to the port.

The inverse of ``kfac_pytorch_tpu/torch_interop.py::convert_cifar_state_dict``
(which this module does not import): numpy ``params`` / ``batch_stats``
trees of the flax ``CifarResNet`` become the port's ``state_dict``:

* ``BasicBlock_{b}`` → ``layer{s}.{i}`` (b = s·n + i, same traversal order),
  ``KFACConv_{j}`` / ``BatchNorm_{j}`` → ``conv{j+1}`` / ``bn{j+1}``;
* conv kernels HWIO → OIHW, the dense kernel ``[in, out]`` → ``[out, in]``;
* BatchNorm ``scale`` → ``weight``, ``mean``/``var`` → ``running_mean``/
  ``running_var``, plus a zero ``num_batches_tracked``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

_CIFAR_DEPTHS = {20, 32, 44, 56, 110, 1202}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    """HWIO → OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _put_bn(sd, prefix: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def state_dict_from_jax(
    params: Dict[str, Any], batch_stats: Dict[str, Any], arch: str
) -> "OrderedDict[str, torch.Tensor]":
    """JAX CIFAR ``(params, batch_stats)`` → the port's ``state_dict``."""
    suffix = arch[len("resnet"):] if arch.startswith("resnet") else ""
    if not suffix.isdigit() or int(suffix) not in _CIFAR_DEPTHS:
        raise ValueError(
            f"unsupported cifar arch {arch!r} (supported: "
            f"{sorted('resnet%d' % d for d in _CIFAR_DEPTHS)})"
        )
    n = (int(suffix) - 2) // 6
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["conv1.weight"] = _conv(params["KFACConv_0"]["kernel"])
    _put_bn(sd, "bn1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    for stage in range(3):
        for i in range(n):
            b = stage * n + i
            fp, fs = params[f"BasicBlock_{b}"], batch_stats[f"BasicBlock_{b}"]
            tp = f"layer{stage + 1}.{i}"
            for j in (1, 2):
                sd[f"{tp}.conv{j}.weight"] = _conv(fp[f"KFACConv_{j - 1}"]["kernel"])
                _put_bn(sd, f"{tp}.bn{j}", fp[f"BatchNorm_{j - 1}"], fs[f"BatchNorm_{j - 1}"])
    sd["linear.weight"] = _t(np.asarray(params["KFACDense_0"]["kernel"]).T)
    sd["linear.bias"] = _t(params["KFACDense_0"]["bias"])
    return sd
