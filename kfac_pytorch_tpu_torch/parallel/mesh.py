"""The data-parallel world: the port's counterpart of a 1-D device mesh.

Port of ``kfac_pytorch_tpu/parallel/mesh.py``'s one- and two-axis part
(``data_parallel_mesh``, ``data_tensor_mesh``, ``data_axis_size``,
``put_global_batch``, ``split_service_mesh``). A JAX
mesh of ``world`` devices on one data axis is, in PyTorch, a process group
of ``world`` ranks with one device each: :class:`World` names that group
and carries the collectives the port issues on it (the means of the
gradients, the sums under the factor comm plane's bucket means
(``parallel/comm.py``), the sum-of-zeros exchanges of the sharded refresh
and apply, the BatchNorm sums, the broadcast of the starting state, and the
owner mode's reduce-scatter mean and flat all-gather, and the overlap
plane's asynchronous sum).

The data×seq world (:func:`data_seq_world`) is the JAX trainer's
``Mesh(devices.reshape(dp, sp), ("data", "seq"))``: rank ``r`` is data
slot ``r // sp`` and seq slot ``r % sp``, and the ranks of one data slot
form a seq subgroup, over which the sequence-parallel attention
(``parallel/context.py``) runs its ring hops (:meth:`World.seq_shift`)
and all-to-alls (:meth:`World.seq_all_to_all`). Every other collective
stays on the whole world: every rank holds the same number of tokens, so
the whole-world mean of the gradients, the loss and the K-FAC statistics
is the global batch's. On gloo (two ranks sharing one card, which NCCL
refuses) the ring hop's CUDA tensors cross through host memory
(:attr:`World.seq_staged`): gloo's point-to-point takes a CUDA tensor's
device pointer for host memory and aborts the process (``writev: Bad
address``, torch 2.11 on an H100), while its ``all_to_all_single`` takes
CUDA tensors. The staging is a transport chosen from the backend, never a
fallback; NCCL takes the tensors as they are.

The data×tensor world (:func:`data_tensor_world`) is the JAX package's
``data_tensor_mesh``: rank ``r`` is data slot ``r // tp`` and tensor slot
``r % tp``, and the tensor axis is replicated compute, so the tensor peers
of a data slot hold the same batch rows and the same state. Every
collective the port issues rides the data axis only: the world's group
is this rank's DATA subgroup (the ranks of its tensor slot), its ``size``
the data size and its ``rank`` the data slot, so the gradient and loss
means, the factor buckets, the owner mode's reduce-scatter and gathers and
an owner checkpoint's gathers see the data axis, as the JAX package's
K-FAC planes do (``preconditioner.py``'s ``_non_tensor_world``).

The data×fsdp×tensor world (:func:`data_fsdp_tensor_world`) is the JAX
package's ``data_fsdp_tensor_mesh``, whose axes carry genuine sharding.
Rank ``r`` is laid out row-major ``(data, fsdp, tensor)``: data slot
``r // (F·T)``, fsdp slot ``(r // T) % F``, tensor slot ``r % T`` (tensor
peers are neighbours, fsdp peers next). The world's ``group``, ``size`` and
``rank`` are this rank's data×fsdp subgroup (the ranks of its tensor slot;
the batch slot of rank ``r`` is ``r // T = data·F + fsdp``, as
``P(("data", "fsdp"))`` lays out rows), so the gradient and loss means,
the factor comm plane and the owner mode ride it as on a data axis. Two
more subgroups come with it:

* the tensor subgroup (``tensor_group``, the ``T`` ranks of one data×fsdp
  slot): the column/row compute split's all-reduces
  (``parallel/tensor.py``) and the named scalar sums over the shard
  layers' local blocks (ν, the global-norm clip, the diagnostics);
* the fsdp subgroup (``fsdp_group``, the ``F`` ranks of one data and
  tensor slot): the parameter gather of ``parallel/fsdp.py`` and a
  checkpoint's gather of the parameter slices.

The curvature-service carve (:func:`split_service_mesh`, the JAX
function's counterpart, and :func:`service_world`) takes the TRAILING
ranks as curvature workers, so the training world keeps the dense
low-index prefix: its ranks form one subgroup, which carries every
training collective, and the workers join none of them.

Which rows of the global batch a rank holds: the global batch of a step is
the concatenation of the data slots' batches in slot order (on a world
with no seq axis, a rank is its own data slot); under a seq axis each
rank keeps its slot's rows and the ``[s·T/sp, (s+1)·T/sp)`` slice of
their sequence (:func:`local_seq`). Each rank draws its
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
    # the seq axis: its size and this rank's seq subgroup
    seq_size: int = 1
    seq_group: Optional[Any] = None
    seq_staged: bool = False
    # the genuine tensor axis of a data×fsdp×tensor world: its size, this
    # rank's tensor slot and tensor subgroup
    tensor_size: int = 1
    tensor_rank: int = 0
    tensor_group: Optional[Any] = None
    # the fsdp axis: its size, this rank's fsdp slot and fsdp subgroup
    fsdp_size: int = 1
    fsdp_rank: int = 0
    fsdp_group: Optional[Any] = None

    @property
    def seq_slot(self) -> int:
        return self.rank % self.seq_size

    @property
    def data_slot(self) -> int:
        return self.rank // self.seq_size

    @property
    def data_size(self) -> int:
        return self.size // self.seq_size

    def tensor_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tensor subgroup, in place; returns ``t``
        (an identity without a tensor axis)."""
        if self.tensor_size > 1:
            dist.all_reduce(t, group=self.tensor_group)
        return t

    def tensor_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The tensor slots' ``t`` concatenated along ``dim`` in slot order:
        one flat ``all_gather_into_tensor`` on the tensor subgroup."""
        if self.tensor_size == 1:
            return t
        return _gather_cat(t, dim, self.tensor_size, self.tensor_group)

    def fsdp_all_gather_flat(self, t: torch.Tensor) -> torch.Tensor:
        """The fsdp slots' ``t`` concatenated flat in slot order: one
        ``all_gather_into_tensor`` on the fsdp subgroup."""
        if self.fsdp_size == 1:
            return t.reshape(-1)
        return _gather_cat(t.reshape(-1), 0, self.fsdp_size, self.fsdp_group)

    def _seq_peer(self, slot: int) -> int:
        """The global rank of seq slot ``slot`` in this rank's data slot."""
        return self.data_slot * self.seq_size + slot % self.seq_size

    def seq_shift(self, t: torch.Tensor) -> torch.Tensor:
        """One ring hop on the seq subgroup: ``t`` goes to the next seq slot,
        the previous slot's arrives (``lax.ppermute`` with ``j → j+1``); one
        ``batch_isend_irecv`` of a send and a receive."""
        send = t.cpu() if self.seq_staged else t.contiguous()
        recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._seq_peer(self.seq_slot + 1), self.seq_group),
            dist.P2POp(dist.irecv, recv, self._seq_peer(self.seq_slot - 1), self.seq_group),
        ]):
            work.wait()
        return recv.to(t.device) if self.seq_staged else recv

    def seq_all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t [seq_size, ...]``'s row ``j`` to seq slot ``j``; row ``i`` of
        the result from slot ``i``: one ``all_to_all_single`` on the seq
        subgroup."""
        recv = torch.empty_like(t)
        dist.all_to_all_single(recv, t.contiguous(), group=self.seq_group)
        return recv

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
        """Overwrite each tensor with rank ``src``'s (a rank of this world's
        group), in place."""
        if not self.distributed:
            return
        root = src if self.group is None else dist.get_global_rank(self.group, src)
        for t in tensors:
            dist.broadcast(t, src=root, group=self.group)


def _gather_cat(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """``n`` ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    t = t.contiguous()
    flat = t.new_empty(n * t.numel())
    # gloo takes the output flat; NCCL either way
    dist.all_gather_into_tensor(flat, t.reshape(-1), group=group)
    parts = flat.view(n, *t.shape).unbind(0)
    return torch.cat(parts, dim=dim) if dim else flat.view(n * t.shape[0], *t.shape[1:])


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


def data_seq_world(seq_parallel: int, device: Optional[torch.device] = None) -> World:
    """The default group's world with a seq axis of ``seq_parallel`` slots
    (the JAX trainer's data×seq mesh); a world with no seq axis at 1. Every
    rank creates every seq subgroup, in data-slot order, as
    ``torch.distributed.new_group`` requires. ``device`` is where the
    attention's tensors live: CUDA tensors on a gloo world cross the seq
    ring hops through host memory."""
    world = data_parallel_world()
    if seq_parallel == 1:
        return world
    if not world.distributed or world.size % seq_parallel:
        raise ValueError(
            f"--seq-parallel {seq_parallel} must divide device count {world.size}"
        )
    mine = None
    for d in range(world.size // seq_parallel):
        ranks = list(range(d * seq_parallel, (d + 1) * seq_parallel))
        g = dist.new_group(ranks)
        if world.rank in ranks:
            mine = g
    staged = (device is not None and torch.device(device).type == "cuda"
              and dist.get_backend(mine) == "gloo")
    return dataclasses.replace(world, seq_size=seq_parallel, seq_group=mine, seq_staged=staged)


def data_tensor_world(tensor_parallel: int) -> World:
    """The default group's ranks as a data×tensor world (the JAX
    ``data_tensor_mesh``), laid out row-major: rank ``r`` is data slot
    ``r // tensor_parallel`` and tensor slot ``r % tensor_parallel``. The
    returned world is this rank's data subgroup (the ranks of its tensor
    slot), so every collective on it rides the data axis; a world with no
    tensor axis at 1. Every rank creates every subgroup, in tensor-slot
    order, as ``torch.distributed.new_group`` requires."""
    world = data_parallel_world()
    if tensor_parallel == 1:
        return world
    if tensor_parallel < 1 or not world.distributed or world.size % tensor_parallel:
        raise ValueError(
            f"--tensor-parallel {tensor_parallel} must divide device count {world.size}"
        )
    mine = None
    for t in range(tensor_parallel):
        ranks = list(range(t, world.size, tensor_parallel))
        g = dist.new_group(ranks)
        if world.rank in ranks:
            mine = g
    return World(group=mine, size=world.size // tensor_parallel,
                 rank=world.rank // tensor_parallel, distributed=True)


def data_fsdp_tensor_world(fsdp: int, tensor_parallel: int) -> World:
    """The default group's ranks as a data×fsdp×tensor world (the JAX
    ``data_fsdp_tensor_mesh``), laid out row-major ``(data, fsdp, tensor)``
    (see the module docstring). The returned world is this rank's
    data×fsdp subgroup, with its tensor and fsdp subgroups; at
    ``fsdp = tensor_parallel = 1`` it is the default group's world. Every
    rank creates every subgroup, in one fixed order (the data×fsdp groups by
    tensor slot, then the fsdp groups, then the tensor groups), as
    ``torch.distributed.new_group`` requires."""
    world = data_parallel_world()
    if fsdp < 1 or tensor_parallel < 1:
        raise ValueError(
            f"fsdp={fsdp} and tensor_parallel={tensor_parallel} must be >= 1"
        )
    if world.size % (fsdp * tensor_parallel):
        raise ValueError(
            f"fsdp×tensor_parallel={fsdp}×{tensor_parallel} does not divide "
            f"{world.size} devices"
        )
    if fsdp * tensor_parallel == 1:
        return world
    n, r, f_, t_ = world.size, world.rank, fsdp, tensor_parallel
    data = n // (f_ * t_)
    group = fsdp_group = tensor_group = None

    def make(ranks, mine):
        g = dist.new_group(ranks)
        return g if r in ranks else mine

    if t_ > 1:
        for t in range(t_):
            group = make(list(range(t, n, t_)), group)
    if f_ > 1:
        for d in range(data):
            for t in range(t_):
                fsdp_group = make([d * f_ * t_ + f * t_ + t for f in range(f_)], fsdp_group)
    if t_ > 1:
        for d in range(data):
            for f in range(f_):
                tensor_group = make([(d * f_ + f) * t_ + t for t in range(t_)], tensor_group)
    return World(group=group, size=n // t_, rank=r // t_, distributed=True,
                 tensor_size=t_, tensor_rank=r % t_, tensor_group=tensor_group,
                 fsdp_size=f_, fsdp_rank=(r // t_) % f_, fsdp_group=fsdp_group)


def split_service_mesh(service_devices: int, devices: Sequence[Any]) -> tuple:
    """``(train, workers)``: ``devices`` (devices or ranks) split into the
    leading ``len(devices) - service_devices`` that train and the trailing
    ``service_devices`` curvature workers, both tuples. 0 keeps every one
    training, so call sites thread the lever through unconditionally; at
    least one must remain for training."""
    devices = list(devices)
    n = int(service_devices)
    if n < 0:
        raise ValueError(f"service_devices must be >= 0, got {service_devices}")
    if n >= len(devices):
        raise ValueError(
            f"service_devices={n} leaves no training devices (have {len(devices)})"
        )
    return tuple(devices[: len(devices) - n]), tuple(devices[len(devices) - n:])


def service_world(service_devices: int) -> tuple:
    """``(world, workers)`` of the default group carved by
    :func:`split_service_mesh`: ``workers`` the worker ranks, and ``world``
    this rank's side, the training subgroup's world on a training rank and
    the worker subgroup's on a worker (``launch.rank() in workers``). At 0
    the default group's world and ``()``. Every rank creates both
    subgroups, training first, as ``torch.distributed.new_group``
    requires."""
    world = data_parallel_world()
    train, workers = split_service_mesh(service_devices, range(world.size))
    if not workers:
        return world, ()
    g_train, g_work = dist.new_group(list(train)), dist.new_group(list(workers))
    if world.rank in workers:
        return World(group=g_work, size=len(workers), rank=world.rank - len(train),
                     distributed=True), workers
    return World(group=g_train, size=len(train), rank=world.rank, distributed=True), workers


def batch_axes(world: World) -> tuple:
    """The batch-carrying axes of a world (the JAX ``batch_axes``):
    ``("data",)`` plus ``"fsdp"`` when the fsdp axis has more than one slot.
    The world's own group spans exactly these axes."""
    return ("data", "fsdp") if world.fsdp_size > 1 else ("data",)


def local_seq(seq_len: int, world: World) -> slice:
    """The positions of a ``seq_len`` sequence that ``world.rank``'s seq
    slot holds (all of them without a seq axis)."""
    if seq_len % world.seq_size:
        raise ValueError(f"--seq-len {seq_len} must be divisible by --seq-parallel {world.seq_size}")
    per = seq_len // world.seq_size
    return slice(world.seq_slot * per, (world.seq_slot + 1) * per)


def data_axis_size(world: World) -> int:
    """The replica count along the batch axis."""
    return world.data_size


def local_rows(global_batch: int, world: World) -> slice:
    """The rows of a global batch of ``global_batch`` examples (the data
    slots' batches concatenated in slot order) that ``world.rank``'s data
    slot fills."""
    if global_batch % world.data_size:
        raise ValueError(
            f"a global batch of {global_batch} does not split over {world.data_size} data slots")
    per = global_batch // world.data_size
    return slice(world.data_slot * per, (world.data_slot + 1) * per)


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
