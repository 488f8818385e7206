"""Per-layer K-FAC statistics through module hooks.

Port of the conv/dense subset of ``kfac_pytorch_tpu/capture.py``. The JAX
package computes statistics inside its layers because JAX has no hooks;
the reference it ports kept ``m_a``/``m_g`` hook dicts, and so does this
module:

* forward hook — on capture steps only, under ``no_grad``, the layer's
  input gives its A-factor contribution (conv layers through the
  factor-kernel dispatcher, ``ops/factor_kernels.py``);
* a hook on the layer's output tensor — the gradient of the loss with
  respect to the output gives the G factor.

Layers are keyed by module path (``"layer1.0.conv1"``); their parameter
gradients by parameter name (``"layer1.0.conv1.weight"``), so every
per-layer artifact shares one key, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
from kfac_pytorch_tpu_torch.ops import factor_kernels, factors

KFAC_LAYERS = (KFACConv, KFACDense)


def discover_layers(model: nn.Module) -> List[str]:
    """Module paths of every K-FAC layer of ``model``, in module order."""
    return [n for n, m in model.named_modules() if isinstance(m, KFAC_LAYERS)]


class Capture:
    """Forward/backward hooks that collect A contributions and G factors.

    Inert until :meth:`capturing` opens a capture step; the statistics of
    the last capture step stay in :attr:`a_contribs` / :attr:`g_factor_stats`
    (``{layer: [d, d] tensor}``). :meth:`remove` detaches the hooks.
    """

    def __init__(
        self,
        model: nn.Module,
        layers: Optional[List[str]] = None,
        batch_averaged: bool = True,
    ):
        names = list(layers) if layers is not None else discover_layers(model)
        self.modules = {n: model.get_submodule(n) for n in names}
        self.batch_averaged = batch_averaged
        self.a_contribs: Dict[str, torch.Tensor] = {}
        self.g_factor_stats: Dict[str, torch.Tensor] = {}
        self._kind: Optional[str] = None
        self._handles = [
            m.register_forward_hook(partial(self._forward_hook, n))
            for n, m in self.modules.items()
        ]

    @contextlib.contextmanager
    def capturing(self, factor_kernel: str = "auto"):
        """Collect statistics for the forward/backward run inside the block."""
        self.a_contribs, self.g_factor_stats = {}, {}
        self._kind = factor_kernel
        try:
            yield self
        finally:
            self._kind = None

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _forward_hook(self, name, module, inputs, output):
        if self._kind is None:
            return
        with torch.no_grad():
            x = inputs[0].detach().float()
            if isinstance(module, KFACConv):
                a = factor_kernels.dispatch_compute_a_conv(
                    x,
                    module.kernel_size,
                    module.stride,
                    module.factor_padding(),
                    module.bias is not None,
                    module.dilation,
                    kind=self._kind,
                )
            else:
                a = factors.compute_a_dense(x, module.bias is not None)
        self.a_contribs[name] = a
        if output.requires_grad:
            output.register_hook(
                partial(self._grad_hook, name, isinstance(module, KFACConv))
            )

    def _grad_hook(self, name, is_conv, grad):
        with torch.no_grad():
            g = grad.detach().float()
            if is_conv:
                stat = factors.compute_g_conv(g, self.batch_averaged)
            else:
                stat = factors.compute_g_dense(g, self.batch_averaged)
        self.g_factor_stats[name] = stat


def layer_grads(
    grads: Dict[str, torch.Tensor], names: List[str]
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {'weight': ..., 'bias'?: ...}}`` from a by-parameter-name
    gradient dict (``{n: p.grad for n, p in model.named_parameters()}``)."""
    out = {}
    for name in names:
        entry = {"weight": grads[f"{name}.weight"]}
        if f"{name}.bias" in grads:
            entry["bias"] = grads[f"{name}.bias"]
        out[name] = entry
    return out


def grad_mats(
    lgrads: Dict[str, Dict[str, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """Per-layer factor-space gradient matrices ``[out, in(+1)]``."""
    return {name: factors.grads_to_mat(g) for name, g in lgrads.items()}


def write_back(
    grads: Dict[str, torch.Tensor],
    updates: Dict[str, torch.Tensor],
    nu: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """A new gradient dict with every K-FAC layer's ν-scaled preconditioned
    matrix scattered back; other entries (BatchNorm) pass through untouched."""
    out = dict(grads)
    for name, mat in updates.items():
        weight = grads[f"{name}.weight"]
        has_bias = f"{name}.bias" in grads
        new = factors.mat_to_grads(mat * nu, weight.shape, has_bias)
        out[f"{name}.weight"] = new["weight"].to(weight.dtype)
        if has_bias:
            out[f"{name}.bias"] = new["bias"].to(grads[f"{name}.bias"].dtype)
    return out
