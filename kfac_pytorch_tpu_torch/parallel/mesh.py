"""The data-parallel world: the port's counterpart of a 1-D device mesh.

Port of ``kfac_pytorch_tpu/parallel/mesh.py``'s one-axis part
(``data_parallel_mesh``, ``data_axis_size``, ``put_global_batch``). A JAX
mesh of ``world`` devices on one data axis is, in PyTorch, a process group
of ``world`` ranks with one device each: :class:`World` names that group
and carries the collectives the port issues on it (the means of the
gradients, the sums under the factor comm plane's bucket means
(``parallel/comm.py``), the sum-of-zeros exchanges of the sharded refresh
and apply, the BatchNorm sums, the broadcast of the starting state, and the
owner mode's reduce-scatter mean and flat all-gather, and the overlap
plane's asynchronous sum). The
2-D and 3-D meshes and ``split_service_mesh`` wait for ROADMAP queue 1
items 8 and 9.

Which rows of the global batch a rank holds: the global batch of a step is
the concatenation of the ranks' batches in rank order. Each rank draws its
own batch from the interleaved shard ``rank::world`` of the epoch's
permutation (``training.data.epoch_batches(num_shards=world,
shard_index=rank)``), as each host of the JAX package's multi-host trainer
does; :func:`local_rows` is the slice of the concatenation that a rank's
batch fills.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the compressed wire types of the gradient mean and the distributed-
# precondition exchange (the reference's fp16 allreduce; the JAX trainers
# offer bf16)
WIRE_DTYPES = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class World:
    """A process group used as the data axis: ``size`` ranks, this one
    ``rank``. ``distributed`` is False for a process outside any group (a
    world of one with no collectives at all); a group of one still runs its
    collectives, each an identity."""

    group: Optional[Any] = None
    size: int = 1
    rank: int = 0
    distributed: bool = False

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor],
                         comm_dtype: Optional[torch.dtype] = None) -> None:
        """Replace each tensor by its mean over the ranks, in place: one
        flat ``all_reduce`` per tensor dtype, its payload in ``comm_dtype``
        when one is given (each rank's value rounds once; the sum is the
        backend's), back in the tensors' dtype after it."""
        if not self.distributed:
            return
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, ts in by_dtype.items():
            flat = torch.cat([t.reshape(-1) for t in ts])
            if comm_dtype is not None:
                flat = flat.to(comm_dtype)
            dist.all_reduce(flat, group=self.group)
            flat = flat.to(dtype) / self.size
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place; returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, differentiable: the backward sums the
        incoming gradients over the ranks too, so a loss computed from the
        sum on every rank back-propagates across them (BatchNorm over the
        global batch). The autograd-aware ``all_reduce`` of
        ``torch.distributed.nn.functional``, which recent PyTorch deprecates."""
        if not self.distributed:
            return t
        return _SumOverRanks.apply(t, self.group)

    def reduce_scatter_mean(self, buf: torch.Tensor) -> torch.Tensor:
        """Row ``rank`` of the ranks' mean of ``buf [world, width]``: the
        JAX package's ``lax.psum_scatter(buf, tiled=True)[0] / world``. One
        ``reduce_scatter_tensor`` sums in ``buf``'s dtype (the wire's); the
        mean is taken in float32 after it."""
        out = buf.new_empty(buf.shape[1:])
        if not self.distributed:
            out.copy_(buf[0])
        else:
            # gloo takes the input flat; NCCL either way
            dist.reduce_scatter_tensor(out, buf.reshape(-1), group=self.group)
        return out.float() / self.size

    def all_gather_flat(self, buf: torch.Tensor) -> torch.Tensor:
        """Every rank's ``buf`` in one ``[world, *buf.shape]`` tensor, row
        ``r`` rank ``r``'s: one ``all_gather_into_tensor`` (NCCL's list
        ``all_gather`` stages a flat copy)."""
        flat = buf.new_empty(self.size * buf.numel())
        out = flat.view(self.size, *buf.shape)
        if not self.distributed:
            out.copy_(buf[None])
        else:
            # gloo takes the output flat; NCCL either way
            dist.all_gather_into_tensor(flat, buf.reshape(-1), group=self.group)
        return out

    def all_reduce_sum_async(self, t: torch.Tensor):
        """``t`` summed over the ranks, in place, issued asynchronously:
        returns the ``Work`` to wait on (``None`` outside a group)."""
        if not self.distributed:
            return None
        return dist.all_reduce(t, group=self.group, async_op=True)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor with rank ``src``'s, in place."""
        if not self.distributed:
            return
        for t in tensors:
            dist.broadcast(t, src=src, group=self.group)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def data_parallel_world(group: Optional[Any] = None) -> World:
    """The world of ``group`` (default: the default group) when
    ``torch.distributed`` is initialised, else a world of one."""
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("process_group= given but torch.distributed is not initialised")
        return World()
    return World(
        group=group,
        size=dist.get_world_size(group),
        rank=dist.get_rank(group),
        distributed=True,
    )


def data_axis_size(world: World) -> int:
    """The replica count along the batch axis (the K-FAC ``world``)."""
    return world.size


def local_rows(global_batch: int, world: World) -> slice:
    """The rows of a global batch of ``global_batch`` examples (the ranks'
    batches concatenated in rank order) that ``world.rank``'s batch fills."""
    if global_batch % world.size:
        raise ValueError(f"a global batch of {global_batch} does not split over {world.size} ranks")
    per = global_batch // world.size
    return slice(world.rank * per, (world.rank + 1) * per)


def put_global_batch(batch: Sequence[np.ndarray], device: torch.device,
                     accum_steps: int = 1) -> List[torch.Tensor]:
    """This rank's host batch on ``device``: each array as a tensor, with a
    leading ``[accum_steps, microbatch]`` split for gradient accumulation
    (the JAX function's reshape, paired with the transfer so callers cannot
    mismatch them)."""
    out = []
    for a in batch:
        t = torch.from_numpy(np.asarray(a)).to(device, non_blocking=True)
        if accum_steps > 1:
            t = t.reshape(accum_steps, -1, *t.shape[1:])
        out.append(t)
    return out
