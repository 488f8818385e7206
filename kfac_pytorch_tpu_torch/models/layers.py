"""K-FAC-aware layers: ``nn.Conv2d`` / ``nn.Linear`` / ``nn.Embedding``
subclasses.

Port of ``KFACConv``, ``KFACDense``, ``KFACEmbed``, ``KFACShardedDense``
and ``KFACMoE`` from ``kfac_pytorch_tpu/models/layers.py``. The JAX layers
compute and ``sow`` their own statistics because JAX has no hooks; here
the layers are plain PyTorch modules that mark themselves as
preconditionable, and ``capture.py`` attaches forward and backward hooks
to them — the reference's own design.

``KFACConv`` and ``KFACDense`` take a ``compute_dtype`` (the flax layers'
``dtype``; ``nn.Conv2d``'s own ``dtype`` argument is the parameters'):
the input and the weight are cast to it for the product, as flax's
``promote_dtype`` does, while the parameters stay float32 master weights
and their gradients float32. ``None`` computes in the input's type.

:func:`recomputing` marks a rematerialized forward (the transformer's
``remat``, ``torch.utils.checkpoint``'s recompute in the backward pass):
``capture.py``'s hooks stay inert inside it, since the first forward
already gave the statistics.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Iterator, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.hooks import RemovableHandle


_RECOMPUTE_DEPTH = [0]


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """The block inside recomputes a forward that already ran."""
    _RECOMPUTE_DEPTH[0] += 1
    try:
        yield
    finally:
        _RECOMPUTE_DEPTH[0] -= 1


def in_recompute() -> bool:
    """Whether a :func:`recomputing` block is open."""
    return _RECOMPUTE_DEPTH[0] > 0


class KFACConv(nn.Conv2d):
    """2-D convolution (NCHW/OIHW) that K-FAC preconditions.

    A grouped conv (``groups=G > 1``, ResNeXt's 3×3s) is G independent convs,
    so K-FAC keeps G Kronecker pairs for it: ``capture.py`` expands it into
    the pseudo-layers ``path#g0 … path#g{G-1}``, each with an
    ``(in/G)·kh·kw (+1)`` A side and an ``out/G`` G side.
    """

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.padding_mode != "zeros":
            raise NotImplementedError(
                f"KFACConv supports zero padding only, got {self.padding_mode!r}"
            )
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)

    def factor_padding(self) -> Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]:
        """This conv's padding in the factor functions' form."""
        if isinstance(self.padding, str):
            return self.padding.upper()
        ph, pw = self.padding
        return ((ph, ph), (pw, pw))


class KFACDense(nn.Linear):
    """Dense layer (``y = x Wᵀ + b``) that K-FAC preconditions.

    ``lens_splits = S > 1`` turns on the expand Kronecker lens for a fused
    multi-head projection (one ``[3m, m]`` QKV matmul): ``capture.py``
    expands the layer into S pseudo-layers ``path#s0 … path#s{S-1}``, each
    with the shared input-side A factor and the G factor of its
    ``out/S``-wide slice of the output (arxiv 2311.00636, "expand"). The
    forward matmul stays fused; only the curvature model splits.
    """

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 lens_splits: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        if lens_splits > 1 and self.out_features % lens_splits:
            raise ValueError(
                f"lens_splits={lens_splits} must divide "
                f"features={self.out_features}"
            )
        self.compute_dtype = compute_dtype
        self.lens_splits = lens_splits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = x.to(dt) @ self.weight.to(dt).T
        # the bias is added after the product, in the compute type, as the
        # flax layer adds it
        return y if self.bias is None else y + self.bias.to(dt)


class KFACEmbed(nn.Embedding):
    """Embedding lookup (``y = weight[ids]``) that K-FAC preconditions.

    A lookup is a dense layer over one-hot rows, so its A factor is the
    diagonal of token frequencies, a ``[vocab]`` vector
    (``ops/factors.py::compute_a_embed``), and its eigenbasis is the
    identity: embedding K-FAC costs one ``[d, d]`` G factor plus elementwise
    work on the vocab axis.

    :meth:`attend` is the tied decoder head, ``logits = query @ weightᵀ``.
    It is a method call, which no forward hook sees, so it calls the hooks
    registered with :meth:`register_attend_hook` (``capture.Capture``'s:
    the reduce lens folds the decoder site's statistics into this layer's
    one factor pair).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.padding_idx is not None or self.max_norm is not None or self.sparse:
            raise NotImplementedError(
                "KFACEmbed supports plain lookups only (no padding_idx, "
                "max_norm or sparse gradients)"
            )
        self._attend_hooks: "OrderedDict[int, Callable]" = OrderedDict()

    def register_attend_hook(self, hook: Callable) -> RemovableHandle:
        """``hook(module, query, logits)`` runs after every :meth:`attend`."""
        handle = RemovableHandle(self._attend_hooks)
        self._attend_hooks[handle.id] = hook
        return handle

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """Tied decoder head: ``logits = query @ weightᵀ`` (``[..., d]`` →
        ``[..., vocab]``), flax's ``Embed.attend``."""
        logits = F.linear(query, self.weight)
        for hook in self._attend_hooks.values():
            hook(self, query, logits)
        return logits


class KFACShardedDense(nn.Linear):
    """Dense layer whose weight is SHARDED over a tensor-parallel axis, with
    per-shard K-FAC statistics (``shardwise/``).

    The compute is an ordinary ``y = x Wᵀ (+ b)`` on one process, as in the
    JAX package, where GSPMD splits it only when a trainer places the
    kernel on a mesh with a compute-sharded ``tensor`` axis. What changes
    is the curvature model (the shard lenses of arxiv 2311.00636):

    * ``sharding="column"`` (the ``[m, a]`` weight split along m): A is
      shared, G block-diagonal, a ``[T, m/T, m/T]`` stack;
    * ``sharding="row"`` (split along a): an A stack ``[T, a/T, a/T]`` of
      the input slices and ONE G; no bias (it is not attributable to one
      input shard).

    ``capture.py`` names it ONE layer, ``path#c{T}`` or ``path#r{T}``,
    whose factors stay stacked.

    :meth:`split_` puts the layer on a world with a genuine tensor axis
    (``parallel.mesh.data_fsdp_tensor_world``), as the JAX package's
    ``shardwise.lm_param_shardings`` places its kernel: it keeps only this
    tensor slot's weight shard (column: rows ``m/T`` of dim 0, and the
    bias's; row: columns ``a/T`` of dim 1) and computes with it, the
    collectives of ``parallel/tensor.py`` around the matmul. Its K-FAC
    blocks are then those of its shard: :attr:`local_shards` ``= shards /
    T`` of them (a ``[1, m/T, m/T]`` G stack per slot of a column layer at
    ``shards = T``, a ``[1, a/T, a/T]`` A stack of a row layer).
    """

    def __init__(self, in_features: int, out_features: int, shards: int,
                 sharding: str = "column", bias: bool = True, **kwargs):
        if sharding not in ("column", "row"):
            raise ValueError(f"sharding={sharding!r} must be 'column' or 'row'")
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        if sharding == "column" and out_features % shards:
            raise ValueError(
                f"column sharding needs shards={shards} to divide "
                f"features={out_features}"
            )
        if sharding == "row":
            if in_features % shards:
                raise ValueError(
                    f"row sharding needs shards={shards} to divide the "
                    f"input width {in_features}"
                )
            if bias:
                raise ValueError(
                    "row-sharded layers cannot carry a bias: the bias is "
                    "not attributable to one input shard — set "
                    "use_bias=False"
                )
        super().__init__(in_features, out_features, bias=bias, **kwargs)
        self.shards, self.sharding = shards, sharding
        self.tensor = None  # the world whose tensor slot this layer holds

    @property
    def local_shards(self) -> int:
        """The lens blocks this process holds (all of them unless split)."""
        return self.shards // (self.tensor.tensor_size if self.tensor is not None else 1)

    @property
    def split_dim(self) -> int:
        """The weight dim the tensor axis splits (0 column, 1 row)."""
        return 0 if self.sharding == "column" else 1

    @torch.no_grad()
    def split_(self, world) -> "KFACShardedDense":
        """Keep only ``world``'s tensor slot's shard of the weight (and of a
        column layer's bias), in place; an identity without a tensor axis."""
        t = world.tensor_size
        if t == 1:
            return self
        if self.tensor is not None:
            raise ValueError("the layer is split already")
        if self.shards % t:
            raise ValueError(
                f"a {self.shards}-shard lens does not split over a "
                f"{t}-slot tensor axis"
            )
        k = world.tensor_rank
        self.weight = nn.Parameter(self.weight.chunk(t, dim=self.split_dim)[k].contiguous())
        if self.bias is not None:
            self.bias = nn.Parameter(self.bias.chunk(t)[k].contiguous())
        self.tensor = world
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return super().forward(x)
        from kfac_pytorch_tpu_torch.parallel.tensor import copy_to_tensor, reduce_from_tensor

        if self.sharding == "column":
            return F.linear(copy_to_tensor(x, self.tensor), self.weight, self.bias)
        return reduce_from_tensor(F.linear(x, self.weight), self.tensor)


def tensor_split_params(model: nn.Module) -> dict:
    """``{parameter name: (split dim, world)}`` of ``model``'s parameters
    that a genuine tensor axis splits: the weights and biases of its split
    ``KFACShardedDense`` layers, each with the world whose tensor slot it
    holds."""
    out = {}
    for n, m in model.named_modules():
        if isinstance(m, KFACShardedDense) and m.tensor is not None:
            out[f"{n}.weight"] = (m.split_dim, m.tensor)
            if m.bias is not None:
                out[f"{n}.bias"] = (0, m.tensor)
    return out


class KFACMoE(nn.Module):
    """Toy mixture-of-experts bank with top-1 routing and per-expert K-FAC.

    ``E`` experts share one ``[E, a, m]`` weight bank (the JAX layout); a
    bias-free router picks one expert per token, whose softmax probability
    gates the output, so the router trains by plain SGD through the gate.
    The forward forms the dense per-expert outputs ``h [N, E, m]`` and
    selects each token's row: the gradient of ``h`` is zero outside the
    chosen expert, so it is the expert-masked G statistic as it stands.

    The curvature model is the MoE expert lens: per-expert A and G stacks
    with token-count-weighted EMAs (``shardwise.moe_ema``). Every forward
    calls the hooks of :meth:`register_dispatch_hook` with the flattened
    input, the expert ids and ``h`` (a forward hook sees neither), from
    which ``capture.py`` takes the unnormalized per-expert sums
    (``ops/factors.py::compute_a_moe``, masked with ``[N]`` booleans), the
    expert fractions (kernel 2, ``dispatch_compute_a_moe``) and, from a
    hook on ``h``, G. ``capture.py`` names it ONE layer, ``path#e{E}``.
    """

    def __init__(self, in_features: int, features: int, num_experts: int):
        super().__init__()
        if num_experts < 2:
            raise ValueError(
                f"num_experts={num_experts} must be >= 2 (use KFACDense "
                "for a single expert)"
            )
        self.in_features, self.features, self.num_experts = in_features, features, num_experts
        self.weight = nn.Parameter(torch.empty(num_experts, in_features, features))
        self.router = nn.Linear(in_features, num_experts, bias=False)
        self._dispatch_hooks: "OrderedDict[int, Callable]" = OrderedDict()
        # flax's lecun_normal over the bank: fan_in = E·a
        std = (1.0 / (num_experts * in_features)) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std)

    def register_dispatch_hook(self, hook: Callable) -> RemovableHandle:
        """``hook(module, x [N, a], expert_ids [N], h [N, E, m])`` runs in
        every forward, before the selection."""
        handle = RemovableHandle(self._dispatch_hooks)
        self._dispatch_hooks[handle.id] = hook
        return handle

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.in_features)
        logits = self.router(xf)
        idx = torch.argmax(logits, dim=-1)  # [N] top-1 expert ids
        gate = torch.softmax(logits, dim=-1).gather(-1, idx[:, None])  # [N, 1]
        h = torch.einsum("na,eam->nem", xf, self.weight)
        for hook in self._dispatch_hooks.values():
            hook(self, xf, idx, h)
        sel = h.gather(1, idx[:, None, None].expand(-1, 1, self.features))[:, 0, :]
        return (gate.to(sel.dtype) * sel).reshape(*lead, self.features)
