"""The column/row compute split of a genuine tensor axis.

Port of the collectives GSPMD inserts for the JAX package's
``KFACShardedDense`` kernels placed on a data×fsdp×tensor mesh
(``models/layers.py`` of the JAX package, placed by
``shardwise.lm_param_shardings``): the Megatron pairing of a column-split
layer (its ``[m, a]`` weight split along m: each tensor slot computes its
``m/T`` output features from the whole input) and a row-split layer (the
weight split along a: each slot multiplies its ``a/T`` input slice, and the
partial outputs sum). As ``torch.autograd.Function``s on the world's
tensor subgroup (``parallel.mesh.World.tensor_group``):

* :func:`copy_to_tensor`, before a column layer: identity forward; the
  backward sums the input cotangent over the tensor slots (each slot's
  columns contribute their part of it);
* :func:`reduce_from_tensor`, after a row layer: the forward sums the
  partial outputs; identity backward (the output cotangent is the same on
  every slot);
* :func:`gather_from_tensor`, after a column layer whose output is not
  consumed by a row layer: the forward concatenates the slots' feature
  slices; the backward keeps this slot's slice of the cotangent.

The transformer LM pairs ``ff1`` (column) → GELU → ``ff2`` (row), so its
MLP issues one forward and one backward all-reduce per block and no
gather. The same pattern as ``parallel/context.py``'s ring for the seq
axis. Each is an identity on a world with no tensor axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.parallel.mesh import World


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return world.tensor_all_gather(x, -1)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.world
        per = grad.shape[-1] // w.tensor_size
        return grad[..., w.tensor_rank * per:(w.tensor_rank + 1) * per].contiguous(), None


def copy_to_tensor(x: torch.Tensor, world: World) -> torch.Tensor:
    """A column layer's input: ``x`` forward, its cotangent summed over the
    tensor slots backward."""
    if world.tensor_size == 1:
        return x
    return _CopyToTensor.apply(x, world.tensor_group)


def reduce_from_tensor(x: torch.Tensor, world: World) -> torch.Tensor:
    """A row layer's output: the tensor slots' partial outputs summed
    forward, the cotangent passed through backward."""
    if world.tensor_size == 1:
        return x
    return _ReduceFromTensor.apply(x, world.tensor_group)


def gather_from_tensor(x: torch.Tensor, world: World) -> torch.Tensor:
    """A column layer's output feature slices concatenated over the tensor
    slots (last dim) forward, this slot's slice of the cotangent
    backward."""
    if world.tensor_size == 1:
        return x
    return _GatherFromTensor.apply(x, world)
