"""Checkpoint / resume in a torch format, K-FAC curvature state included.

Port of ``kfac_pytorch_tpu/training/checkpoint.py`` (``checkpoint_path``,
``save_checkpoint``, ``latest_epoch``, ``restore_checkpoint``,
``restore_weights_only``, ``auto_resume``): the whole ``TrainState`` (model
parameters and BatchNorm buffers, SGD momentum, K-FAC factors and
eigendecompositions or inverses, the truncated solvers' rectangular bases
and residual masses, the pipelined refresh's pending buffer, the solver
and slip scalars, the deferred flush's ``factor_sync_age`` and the int8
wire's residuals, diagnostics, step counters) round-trips, and resume
picks the newest ``checkpoint-<epoch>``, as the JAX package's scan does.
The refresh cadence (``scheduler.EigenRefreshCadence``) is host state and
is not in the checkpoint, as in the JAX trainers: a resumed run under
``--eigh-chunks`` bootstraps again with a monolithic refresh at its first
boundary. Owner-sharded K-FAC state (``rehome_kfac_state``) is ROADMAP
queue 1 item 7 (7b).

Data-parallel, only rank 0 writes; every rank reads the directory (a
shared file system, as the JAX package's checkpoints need) at the epoch
rank 0 resumes from, which is broadcast, as the reference broadcasts it
(pytorch_imagenet_resnet.py:136-140). :func:`broadcast_state` then makes
every rank's state rank 0's.

Under deferred factor communication (``factor_comm_freq > 1``) the
factors between flushes are each rank's own running averages, and on the
int8 wire each rank carries its own residuals (``wire_error``). A
checkpoint written mid-interval holds rank 0's, as the JAX trainers'
checkpoint holds process 0's copy of its replicated-annotated state; a
resume gives every rank rank 0's factors, residuals and
``factor_sync_age``, so the other ranks' statistics since the last flush
are dropped and the next flush merges from there.

A checkpoint is one file, ``checkpoint-<epoch>``, written by ``torch.save``
under a temporary name and renamed into place, so a run cut mid-write
leaves no file that resume would pick. It holds only tensors, dicts,
numbers and strings, so it loads with ``weights_only=True``. A restore
copies into the target's existing tensors (``copy_``): the storages a kept
``apply_kernels.SGDPlan`` points into stay the parameters' and momentum
buffers', and the plan stays valid.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.training.step import TrainState

_EPOCH_RE = re.compile(r"checkpoint-(\d+)$")
FORMAT = "kfac_pytorch_tpu_torch.checkpoint/1"


def checkpoint_path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"checkpoint-{epoch}")


def _payload(state: TrainState) -> Dict[str, Any]:
    return {
        "format": FORMAT,
        "step": state.step,
        "model": state.model.state_dict(),
        "opt_state": state.opt_state,
        "kfac_state": state.kfac_state,
    }


def save_checkpoint(checkpoint_dir: str, epoch: int, state: TrainState) -> str:
    """Write ``state`` as ``checkpoint-<epoch>`` in ``checkpoint_dir``
    (created if missing); returns the path. Only rank 0 writes."""
    path = checkpoint_path(checkpoint_dir, epoch)
    if not launch.is_primary():
        return path
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_payload(state), tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(checkpoint_dir: str) -> Optional[int]:
    """Newest saved epoch in ``checkpoint_dir``, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    epochs = [
        int(m.group(1)) for m in map(_EPOCH_RE.match, os.listdir(checkpoint_dir)) if m
    ]
    return max(epochs) if epochs else None


def _load(checkpoint_dir: str, epoch: int, device) -> Dict[str, Any]:
    saved = torch.load(
        checkpoint_path(checkpoint_dir, epoch), map_location=device, weights_only=True
    )
    if not isinstance(saved, dict) or saved.get("format") != FORMAT:
        raise ValueError(
            f"{checkpoint_path(checkpoint_dir, epoch)} is not a checkpoint of "
            f"this package (format {FORMAT})"
        )
    return saved


def _copy_into(dst, src, where: str):
    """``src`` into ``dst``'s tensors in place (dicts updated in place);
    numbers and None take the saved value. Raises ``ValueError`` where the
    structure, a shape or a dtype differs."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"checkpoint entry {where}: saved {getattr(src, 'dtype', type(src).__name__)} "
                f"{tuple(getattr(src, 'shape', ()))}, the target holds {dst.dtype} "
                f"{tuple(dst.shape)}"
            )
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(
                f"checkpoint entry {where}: saved keys "
                f"{sorted(src) if isinstance(src, dict) else type(src).__name__}, "
                f"the target's {sorted(dst)}"
            )
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], f"{where}/{k}")
        return dst
    if (dst is None) != (src is None) or isinstance(src, (torch.Tensor, dict)):
        raise ValueError(f"checkpoint entry {where}: saved {type(src).__name__}, "
                         f"the target holds {type(dst).__name__}")
    return src


def restore_checkpoint(checkpoint_dir: str, epoch: int, target: TrainState) -> TrainState:
    """The state saved for ``epoch``, copied into ``target``'s model,
    momentum buffers and K-FAC state (same structure, shapes and dtypes, or
    ``ValueError``). Returns a ``TrainState`` over the same objects."""
    device = next(target.model.parameters()).device
    saved = _load(checkpoint_dir, epoch, device)
    target.model.load_state_dict(saved["model"])
    opt_state = _copy_into(target.opt_state, saved["opt_state"], "opt_state")
    kfac_state = _copy_into(target.kfac_state, saved["kfac_state"], "kfac_state")
    return TrainState(
        step=saved["step"], model=target.model, opt_state=opt_state, kfac_state=kfac_state
    )


def restore_weights_only(checkpoint_dir: str, epoch: int) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (parameters and BatchNorm buffers) saved for
    ``epoch``, on the CPU, for a caller with no optimizer or K-FAC state."""
    return _load(checkpoint_dir, epoch, "cpu")["model"]


def auto_resume(checkpoint_dir: str, target: TrainState) -> Tuple[TrainState, int]:
    """``(state, first epoch to run)``: the newest checkpoint restored into
    ``target`` and the epoch after it, or ``(target, 0)`` when there is none."""
    epoch = latest_epoch(checkpoint_dir)
    epoch = int(launch.broadcast_host_value(-1 if epoch is None else epoch))
    if epoch < 0:
        return target, 0
    return restore_checkpoint(checkpoint_dir, epoch, target), epoch + 1


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def broadcast_state(state: TrainState, world: World) -> None:
    """Overwrite every tensor of ``state`` (parameters, BatchNorm buffers,
    momentum, K-FAC state) with rank 0's, in place: the reference's
    ``hvd.broadcast_parameters`` and ``broadcast_optimizer_state`` at the
    start of a run."""
    with torch.no_grad():
        world.broadcast_([
            *state.model.state_dict().values(),
            *_tensors(state.opt_state),
            *_tensors(state.kfac_state),
        ])
