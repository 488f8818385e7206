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
and sharded-dense kernels ``[in, out]`` → ``[out, in]`` (a row-sharded
``ff2`` has no bias), an MoE bank's ``[E, a, m]`` kernel as it is and its
router's kernel transposed, ``Embed``/``KFACEmbed`` tables unchanged,
LayerNorm ``scale`` → ``weight``; :func:`lm_layer_name_from_jax` maps its
K-FAC layer names, the suffixes ``#sK``/``#cT``/``#rT``/``#eE`` kept.

:func:`imagenet_state_dict_from_jax` is the inverse of
``kfac_pytorch_tpu/torch_interop.py::convert_state_dict`` for the flax
``ImageNetResNet``: ``BasicBlock_{b}``/``Bottleneck_{b}`` → ``layer{s}.{i}``
(same traversal order), a block's last ``KFACConv``/``BatchNorm`` pair
(``_2``/``_3`` when the block has a downsample) → ``downsample.0``/``.1``,
grouped HWIO kernels ``[kh, kw, in/G, out]`` → OIHW ``[out, in/G, kh, kw]``.
:func:`rnn_state_dict_from_jax` does the same for the flax ``RNNModel``
(``models/wikitext_rnn.py``): per layer, flax's one kernel per gate
(``ii``…``io``, ``hi``…``ho``; GRU ``ir``/``iz``/``in``, ``hr``/``hz``/``hn``;
simple cells ``i``/``h``) is transposed and concatenated in gate order.
All four copy values bit for bit.

:func:`init_from_torch_checkpoint` is the port's ``--init-from-torch``
(the JAX package's ``torch_interop.init_params_from_checkpoint``): the
port's image models already carry the torchvision names (ImageNet) and the
reference zoo's (CIFAR: ``linear``, option-A shortcuts without weights), so
a reference checkpoint's ``state_dict`` loads into the model directly, with
the JAX package's checks.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    """HWIO → OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _put_dense(sd, prefix: str, p: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
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
    (tied or untied; a dense, tensor-parallel or MoE MLP)."""
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
        if "moe" in bp:
            sd[f"{prefix}.moe.weight"] = _t(bp["moe"]["kernel"])
            sd[f"{prefix}.moe.router.weight"] = _t(np.asarray(bp["moe"]["router"]["kernel"]).T)
        else:
            _put_dense(sd, f"{prefix}.ff1", bp["ff1"])
            _put_dense(sd, f"{prefix}.ff2", bp["ff2"])
        i += 1
    _put_ln(sd, "ln_f", params["ln_f"])
    if "decoder" in params:  # a tied model's head is the token table
        _put_dense(sd, "decoder", params["decoder"])
    return sd


# the transformer LM's dense modules, whose ``[out, in]`` weight is the
# transpose of flax's ``[in, out]`` kernel
_LM_DENSE = ("qkv", "out", "ff1", "ff2", "decoder", "router")


def lm_jax_leaf_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax leaf shape of the port's transformer-LM parameter ``name``
    of torch shape ``shape``: a dense weight ``[out, in]`` is flax's
    ``[in, out]`` kernel; embeddings, LayerNorms, biases and an MoE bank
    keep their shape (the layout map of :func:`lm_state_dict_from_jax`)."""
    mod, _, leaf = name.rpartition(".")
    if leaf == "weight" and mod.rpartition(".")[2] in _LM_DENSE and len(shape) == 2:
        return tuple(shape)[::-1]
    return tuple(shape)


def lm_rank_shards_from_jax(params: Dict[str, Any], names: Sequence[str],
                            world) -> "OrderedDict[str, torch.Tensor]":
    """JAX transformer-LM ``params`` → the port's one-process state_dict
    (:func:`lm_state_dict_from_jax`) → ``world``'s rank's part of each
    parameter on the data×fsdp×tensor world
    (``parallel.mesh.data_fsdp_tensor_world``), placed by
    ``shardwise.lm_param_shardings`` over the port's K-FAC layer ``names``:
    its tensor slot's MLP kernel shards, its fsdp slot's flat slice of each
    parameter the JAX rule splits, the rest whole."""
    from kfac_pytorch_tpu_torch.shardwise import lenses

    full = lm_state_dict_from_jax(params)
    placements = lenses.lm_param_shardings(
        {n: tuple(t.shape) for n, t in full.items()}, list(names),
        world.tensor_size, world.fsdp_size)
    return OrderedDict(
        (n, lenses.local_part(t, placements[n], world).clone()) for n, t in full.items())


def lm_layer_name_from_jax(name: str) -> str:
    """A JAX transformer-LM K-FAC layer name → the port's: ``block_{i}`` →
    ``blocks.{i}``, ``/`` → ``.``; a pseudo-layer or shard suffix (``#sK``
    of the QKV expand lens, ``#cT``/``#rT``/``#eE`` of the shard lenses) is
    kept (``"block_0/qkv#s1"`` → ``"blocks.0.qkv#s1"``)."""
    path, sep, suffix = name.partition("#")
    return path.replace("block_", "blocks.").replace("/", ".") + sep + suffix


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


# flax cell parameter names per gate, in the order the port's cells
# concatenate them (PyTorch's gate order): input side, hidden side
_RNN_GATES = {
    "LSTM": ("OptimizedLSTMCell", ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")),
    "GRU": ("GRUCell", ("ir", "iz", "in"), ("hr", "hz", "hn")),
    "RNN_TANH": ("SimpleCell", ("i",), ("h",)),
    "RNN_RELU": ("SimpleCell", ("i",), ("h",)),
}


def rnn_state_dict_from_jax(
    params: Dict[str, Any], rnn_type: str
) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``RNNModel`` ``params`` → the port's ``RNNModel`` state_dict, for
    every ``RNN_TYPES`` entry, tied (no ``decoder``) or untied.

    Cell ``{Cell}_{i}`` → ``rnns.{i}``: ``weight_ih`` ``[gates·h, in]`` and
    ``weight_hh`` ``[gates·h, h]`` (each gate's ``[in, h]`` kernel
    transposed); the biases flax has: the LSTM's hidden-side ``bias_hh``,
    the GRU's input-side ``bias_ih`` and ``bias_hn``, a simple cell's
    ``bias_ih``. The biases flax lacks are zero buffers outside the
    state_dict (``models/wikitext_rnn.py``).
    """
    if rnn_type not in _RNN_GATES:
        raise ValueError(f"unknown rnn_type {rnn_type!r}; options: {tuple(_RNN_GATES)}")
    cell, in_gates, h_gates = _RNN_GATES[rnn_type]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["encoder.weight"] = _t(params["encoder"]["embedding"])
    i = 0
    while f"{cell}_{i}" in params:
        cp, prefix = params[f"{cell}_{i}"], f"rnns.{i}"
        sd[f"{prefix}.weight_ih"] = _t(np.concatenate(
            [np.asarray(cp[g]["kernel"]).T for g in in_gates]))
        sd[f"{prefix}.weight_hh"] = _t(np.concatenate(
            [np.asarray(cp[g]["kernel"]).T for g in h_gates]))
        if rnn_type == "LSTM":
            sd[f"{prefix}.bias_hh"] = _t(np.concatenate([cp[g]["bias"] for g in h_gates]))
        else:
            sd[f"{prefix}.bias_ih"] = _t(np.concatenate([cp[g]["bias"] for g in in_gates]))
        if rnn_type == "GRU":
            sd[f"{prefix}.bias_hn"] = _t(cp["hn"]["bias"])
        i += 1
    if "decoder" in params:
        _put_dense(sd, "decoder", params["decoder"])
    return sd


# ---------------------------------------------------------------------------
# --init-from-torch: a reference/torchvision checkpoint into a port model
# ---------------------------------------------------------------------------


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a reference checkpoint file: the reference's
    ``{'model': state_dict, ...}`` wrapper or a bare ``state_dict``, read
    with ``torch.load(weights_only=True)`` on the CPU. float64 entries come
    back float32, as the JAX package reads them."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k: v.float() if v.dtype == torch.float64 else v for k, v in sd.items()}


def init_from_torch_checkpoint(path: str, model: nn.Module, arch: str) -> nn.Module:
    """Load a reference/torchvision checkpoint's weights into ``model`` in
    place (its optimizer and K-FAC state start fresh) and return it.

    ``num_batches_tracked`` entries are skipped. A weight the model has and
    the file lacks raises ``KeyError``; an entry of the file the model has
    no place for raises ``ValueError`` (a silent partial import would be a
    wrong checkpoint); a shape or dtype that differs from the model's raises
    ``SystemExit`` naming the first differing entries (wrong arch, class
    count, or a checkpoint saved in another dtype).
    """
    def keep(sd):
        return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    loaded, target = keep(load_torch_checkpoint(path)), keep(model.state_dict())
    for key in target:
        if key not in loaded:
            raise KeyError(f"state_dict is missing {key!r} — is this really {arch}?")
    leftover = sorted(set(loaded) - set(target))
    if leftover:
        raise ValueError(
            f"unconsumed state_dict entries (naming mismatch?): "
            f"{leftover[:8]}{' ...' if len(leftover) > 8 else ''}"
        )
    diffs = sorted(
        k for k, v in target.items()
        if (tuple(loaded[k].shape), loaded[k].dtype) != (tuple(v.shape), v.dtype)
    )
    if diffs:
        raise SystemExit(
            f"--init-from-torch mismatch for {arch} (first differing entries: "
            f"{diffs[:4]}) — wrong arch, class count, or checkpoint dtype?"
        )
    with torch.no_grad():
        for k, v in target.items():
            v.copy_(loaded[k])
    return model
