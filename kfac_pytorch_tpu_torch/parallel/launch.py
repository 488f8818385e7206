"""Process bootstrap and topology over ``torch.distributed``.

Port of ``kfac_pytorch_tpu/parallel/launch.py``: the reference's Horovod
world (``hvd.init``, ``rank``/``size``/``local_rank``, broadcasts and
barriers). One process drives one GPU, as under the reference's
``mpiexec``; ``torchrun --nproc-per-node N`` starts them and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. The collectives run on NCCL for CUDA devices and on gloo
for the CPU. A process started without a launcher (no ``WORLD_SIZE`` and
no ``init_method``) stays a single process: :func:`initialize` is then a
no-op and every function here answers for a world of one.

The process group is ``torch.distributed``'s own state. The one thing
this module keeps is the group its functions answer for
(:func:`set_world_group`): the default group, or the training ranks once a
curvature-service carve (``parallel.mesh.service_world``) has taken the
trailing ranks as workers, which join no training collective.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.device import DeviceLike, resolve_device
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry


def initialize(
    device: DeviceLike = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> torch.device:
    """Join the process group (the ``hvd.init`` counterpart); returns this
    process's device.

    ``device`` is resolved as everywhere in the port (default CUDA; raises
    without a GPU unless ``"cpu"``); a bare ``"cuda"`` becomes
    ``cuda:LOCAL_RANK``, an indexed one is kept (two ranks may share a card
    on gloo). ``backend`` defaults to NCCL for CUDA and gloo for the CPU.
    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE``;
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)
    and may be a ``file://`` store. Without a launcher this joins nothing.
    A second call returns the device and joins nothing.
    """
    dev = resolve_device(device)
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized() or (world_size is None and init_method is None):
        return dev
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        rank=rank,
        world_size=1 if world_size is None else world_size,
        device_id=dev if dev.type == "cuda" and backend in (None, "nccl") else None,
    )
    return dev


# the group rank(), size() and the collectives below answer for (None: the
# default group)
_GROUP = None


def set_world_group(group) -> None:
    """Make ``group`` (a subgroup this process belongs to; None for the
    default group) the world of :func:`rank`, :func:`size`,
    :func:`barrier`, :func:`host_min` and :func:`broadcast_host_value`."""
    global _GROUP
    _GROUP = group


def world_group():
    """The group set by :func:`set_world_group` (None: the default group)."""
    return _GROUP


def rank() -> int:
    """This process's rank (``hvd.rank()``)."""
    return dist.get_rank(_GROUP) if dist.is_initialized() else 0


def size() -> int:
    """The number of processes (``hvd.size()``): one per device."""
    return dist.get_world_size(_GROUP) if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among those of its node (``hvd.local_rank()``):
    the launcher's ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def is_primary() -> bool:
    """True on the process that logs and writes checkpoints (rank 0)."""
    return rank() == 0


def _comm_device() -> torch.device:
    """Where host values travel: NCCL takes CUDA tensors only."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Block until every process arrives; the ``comm/barrier`` span is the
    wait for the slowest process."""
    if size() > 1:
        with get_telemetry().span("comm/barrier"):
            dist.barrier(group=_GROUP)


def host_min(value: int) -> int:
    """The minimum of a host-side integer over every process: for decisions
    every rank must make the same way."""
    if size() == 1:
        return int(value)
    with get_telemetry().span("comm/host_min"):
        t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_GROUP)
        return int(t.item())


def broadcast_host_value(value, root: int = 0):
    """Rank ``root``'s host value (a number or a numpy array) on every
    process, as the reference broadcasts the resume epoch."""
    if size() == 1:
        return value
    with get_telemetry().span("comm/broadcast"):
        arr = np.asarray(value)
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
        dist.broadcast(t, src=root if _GROUP is None else dist.get_global_rank(_GROUP, root),
                       group=_GROUP)
        out = t.cpu().numpy()
    return out.item() if arr.ndim == 0 else out
