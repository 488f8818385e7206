"""Carry weights from the JAX package's trees to the port.

:func:`state_dict_from_jax` is the inverse of
``kfac_pytorch_tpu/torch_interop.py::convert_cifar_state_dict`` (which
this module does not import): numpy ``params`` / ``batch_stats`` trees of
the flax ``CifarResNet`` become the port's ``state_dict``:

* ``BasicBlock_{b}`` → ``layer{s}.{i}`` (b = s·n + i, same traversal order),
  ``KFACConv_{j}`` / ``BatchNorm_{j}`` → ``conv{j+1}`` / ``bn{j+1}``;
* conv kernels HWIO → OIHW, the dense kernel ``[in, out]`` → ``[out, in]``;
* BatchNorm ``scale`` → ``weight``, ``mean``/``var`` → ``running_mean``/
  ``running_var``, plus a zero ``num_batches_tracked``.

:func:`lm_state_dict_from_jax` does the same for the flax ``TransformerLM``
(``models/transformer_lm.py``): ``block_{i}`` → ``blocks.{i}``, ``Dense``
kernels ``[in, out]`` → ``[out, in]``, ``Embed``/``KFACEmbed`` tables
unchanged, LayerNorm ``scale`` → ``weight``.

:func:`imagenet_state_dict_from_jax` is the inverse of
``kfac_pytorch_tpu/torch_interop.py::convert_state_dict`` for the flax
``ImageNetResNet``: ``BasicBlock_{b}``/``Bottleneck_{b}`` → ``layer{s}.{i}``
(same traversal order), a block's last ``KFACConv``/``BatchNorm`` pair
(``_2``/``_3`` when the block has a downsample) → ``downsample.0``/``.1``,
grouped HWIO kernels ``[kh, kw, in/G, out]`` → OIHW ``[out, in/G, kh, kw]``.
All three copy values bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    """HWIO → OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _put_dense(sd, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_ln(sd, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_bn(sd, prefix: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    _put_ln(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def state_dict_from_jax(
    params: Dict[str, Any], batch_stats: Dict[str, Any], arch: str
) -> "OrderedDict[str, torch.Tensor]":
    """JAX CIFAR ``(params, batch_stats)`` → the port's ``state_dict``.

    ``arch`` is ``resnet{6n+2}`` for any ``n >= 1`` blocks per stage, as
    the flax ``CifarResNet`` takes any ``stage_sizes=(n, n, n)`` (the zoo's
    names are resnet20/32/44/56/110/1202; ``resnet8`` is one block per
    stage)."""
    suffix = arch[len("resnet"):] if arch.startswith("resnet") else ""
    if not suffix.isdigit() or int(suffix) < 8 or (int(suffix) - 2) % 6:
        raise ValueError(
            f"unsupported cifar arch {arch!r} (resnet{{6n+2}} for n >= 1 "
            "blocks per stage)"
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
    _put_dense(sd, "linear", params["KFACDense_0"])
    return sd


def lm_state_dict_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX transformer-LM ``params`` → the port's ``TransformerLM`` state_dict
    (the dense-MLP, untied subset the port models)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["tok_embed.weight"] = _t(params["tok_embed"]["embedding"])
    sd["pos_embed.weight"] = _t(params["pos_embed"]["embedding"])
    i = 0
    while f"block_{i}" in params:
        bp, prefix = params[f"block_{i}"], f"blocks.{i}"
        _put_ln(sd, f"{prefix}.ln_attn", bp["ln_attn"])
        _put_dense(sd, f"{prefix}.qkv", bp["qkv"])
        _put_dense(sd, f"{prefix}.out", bp["out"])
        _put_ln(sd, f"{prefix}.ln_mlp", bp["ln_mlp"])
        _put_dense(sd, f"{prefix}.ff1", bp["ff1"])
        _put_dense(sd, f"{prefix}.ff2", bp["ff2"])
        i += 1
    _put_ln(sd, "ln_f", params["ln_f"])
    _put_dense(sd, "decoder", params["decoder"])
    return sd


# stage layouts of the ImageNet zoo (the port's models/imagenet_resnet.py)
_IMAGENET_ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3)),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3)),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3)),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3)),
}


def imagenet_state_dict_from_jax(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    arch: Union[str, Tuple[str, Sequence[int]]],
) -> "OrderedDict[str, torch.Tensor]":
    """JAX ImageNet ``(params, batch_stats)`` → the port's ``state_dict``.

    ``arch`` is a zoo name, or ``(block, stage_sizes)`` with ``block``
    ``"basic"`` or ``"bottleneck"`` for a model outside the zoo.
    """
    if isinstance(arch, str):
        if arch not in _IMAGENET_ARCHS:
            raise ValueError(
                f"unsupported imagenet arch {arch!r} (supported: {sorted(_IMAGENET_ARCHS)})"
            )
        kind, stages = _IMAGENET_ARCHS[arch]
    else:
        kind, stages = arch
    if kind not in ("basic", "bottleneck"):
        raise ValueError(f"block must be 'basic' or 'bottleneck', got {kind!r}")
    block_name = "BasicBlock" if kind == "basic" else "Bottleneck"
    n_convs = 2 if kind == "basic" else 3
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["conv1.weight"] = _conv(params["KFACConv_0"]["kernel"])
    _put_bn(sd, "bn1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    b = 0
    for stage, blocks in enumerate(stages):
        for i in range(blocks):
            fp, fs = params[f"{block_name}_{b}"], batch_stats[f"{block_name}_{b}"]
            tp = f"layer{stage + 1}.{i}"
            for j in range(n_convs):
                sd[f"{tp}.conv{j + 1}.weight"] = _conv(fp[f"KFACConv_{j}"]["kernel"])
                _put_bn(sd, f"{tp}.bn{j + 1}", fp[f"BatchNorm_{j}"], fs[f"BatchNorm_{j}"])
            if f"KFACConv_{n_convs}" in fp:
                sd[f"{tp}.downsample.0.weight"] = _conv(fp[f"KFACConv_{n_convs}"]["kernel"])
                _put_bn(sd, f"{tp}.downsample.1", fp[f"BatchNorm_{n_convs}"],
                        fs[f"BatchNorm_{n_convs}"])
            b += 1
    _put_dense(sd, "fc", params["KFACDense_0"])
    return sd
