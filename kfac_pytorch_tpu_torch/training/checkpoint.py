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
boundary.

Owner-sharded K-FAC state (``factor_sharding="owner"``) holds only this
rank's rows of the ``factor_shard``/``eigen_shard``/``eigen_pending_shard``
stacks. Every rank enters :func:`save_checkpoint`, which gathers the stacks
into the JAX package's global form (``[world·rows, ...]``, rank ``r``'s rows
at ``r·rows``) before rank 0 writes, and a restore gives each rank its own
rows back (:func:`restore_checkpoint` with the preconditioner).
:func:`rehome_kfac_state` places a state per the preconditioner's mode: an
owner state passes, a replicated one is re-homed into the owner rows
(``KFAC.owner_state_from_replicated``), and an owner state for a replicated
preconditioner is refused, as in the JAX package.

Shard-lens factor stacks and their form-prefixed eigen entries
(``cQA``/``rdG``/``eQG``…) are ordinary tensors of the state and round-trip
as they are. On a data×tensor world (``parallel.mesh.data_tensor_world``)
the ``world`` of :func:`save_checkpoint` is the data subgroup: its owner
rows gather over the data axis (the tensor peers hold the same rows), and
the global rank 0 writes.

On a data×fsdp×tensor world (``parallel.mesh.data_fsdp_tensor_world``) a
checkpoint holds the GATHERED one-process layout: every rank enters
:func:`save_checkpoint`, which gathers the tensor-split MLP weights, biases
and momentum over the tensor subgroup (``layers.tensor_split_params``), the
fsdp parts of the other parameters and of their momentum over the fsdp
subgroup (the state's ``parallel.fsdp.FsdpParams``), and the split layers' factor and
eigen blocks (a column layer's ``G``/``cQG``/``cdG``, a row layer's
``A``/``rQA``/``rdA``, ``shardwise.factor_leaf_spec``) into the
one-process ``[T, ·, ·]`` stacks; the global rank 0 writes. A restore cuts
them again for this rank's tensor slot (before the fsdp split, which the
trainer makes after the resume), so a 3-D checkpoint resumes in a
one-process lens run and the other way round.

Data-parallel, only rank 0 writes; every rank reads the directory (a
shared file system, as the JAX package's checkpoints need) at the epoch
rank 0 resumes from, which is broadcast, as the reference broadcasts it
(pytorch_imagenet_resnet.py:136-140). :func:`broadcast_state` then makes
every rank's state rank 0's, apart from what each rank holds of its own:
the owner mode's shard rows and its deferred ``factor_local``.

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

from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.models.layers import tensor_split_params
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import World, data_parallel_world
from kfac_pytorch_tpu_torch.shardwise import lenses
from kfac_pytorch_tpu_torch.training.step import TrainState

_EPOCH_RE = re.compile(r"checkpoint-(\d+)$")
FORMAT = "kfac_pytorch_tpu_torch.checkpoint/1"
# the owner mode's stacks of this rank's rows, and what else each rank holds
# of its own (never broadcast)
OWNER_ROW_KEYS = ("factor_shard", "eigen_shard", "eigen_pending_shard")
PER_RANK_KEYS = (*OWNER_ROW_KEYS, "factor_local")


def checkpoint_path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"checkpoint-{epoch}")


def owner_form(kfac_state) -> bool:
    """An owner-sharded K-FAC state (it has ``factor_shard`` stacks)."""
    return isinstance(kfac_state, dict) and "factor_shard" in kfac_state


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tensor_split(kfac_state, world: World, fn):
    """``kfac_state`` with ``fn(tensor)`` applied to every factor/eigen
    leaf a genuine tensor axis of ``world`` splits."""
    if not isinstance(kfac_state, dict) or world.tensor_size == 1:
        return kfac_state
    out = dict(kfac_state)
    for key in ("factors", "eigen"):
        entries = dict(out.get(key, {}))
        for name, entry in entries.items():
            count = capture.split_shard_name(name)[2]
            if count is not None:
                entries[name] = {
                    k: fn(v) if lenses.factor_leaf_spec(name, k, (count,), world.tensor_size)
                    else v for k, v in entry.items()}
        if key in out:
            out[key] = entries
    return out


def global_kfac_state(kfac_state, world: World):
    """An owner state with its row stacks gathered over the ranks into the
    global ``[world·rows, ...]`` form (one ``all_gather`` per stack), and
    on a genuine tensor axis the split layers' blocks gathered into their
    one-process stacks: every rank of ``world`` must call it. Other states
    pass unchanged."""
    kfac_state = _tensor_split(kfac_state, world, lambda t: world.tensor_all_gather(t, 0))
    if not owner_form(kfac_state) or not world.distributed:
        return kfac_state
    out = dict(kfac_state)
    for key in OWNER_ROW_KEYS:
        if key in out:
            out[key] = _map(out[key], lambda t: world.all_gather_flat(t.contiguous()).reshape(
                world.size * t.shape[0], *t.shape[1:]))
    return out


def local_kfac_state(kfac_state, world: World, saved_world: int):
    """This rank's rows of a global-form owner state saved over
    ``saved_world`` ranks (the inverse of :func:`global_kfac_state`)."""
    if saved_world != world.size:
        raise ValueError(
            f"checkpoint holds owner-sharded K-FAC state of {saved_world} ranks; this "
            f"world has {world.size} — restore on the world it was saved on"
        )
    out = dict(kfac_state)
    for key in OWNER_ROW_KEYS:
        if key in out:
            out[key] = _map(out[key], lambda t: t.reshape(world.size, -1, *t.shape[1:])[
                world.rank].contiguous())
    return out


def rehome_kfac_state(kfac: Any, kfac_state: Any) -> Any:
    """A K-FAC state placed per the preconditioner's sharding mode (the
    JAX package's ``rehome_kfac_state``): an owner preconditioner passes an
    owner state (this rank's rows) and re-homes a replicated one
    (``KFAC.owner_state_from_replicated``, deterministic: the plan is a
    function of the layer shapes); a replicated preconditioner passes a
    replicated state and refuses an owner one."""
    if kfac is None or kfac_state is None:
        return kfac_state
    if getattr(kfac, "owner_sharded", False):
        return kfac_state if owner_form(kfac_state) else kfac.owner_state_from_replicated(
            kfac_state)
    if owner_form(kfac_state):
        raise ValueError(
            "checkpoint holds owner-sharded K-FAC state but this "
            "preconditioner runs factor_sharding='replicated'; gather-back "
            "migration is not supported — restore with "
            "factor_sharding='owner' on the same mesh"
        )
    return kfac_state


def global_payload(state: TrainState, world: World) -> Dict[str, Any]:
    """``state`` in the one-process global layout a checkpoint or an
    elastic snapshot holds: the fsdp parts and the tensor-split parameters
    and momentum gathered, the K-FAC state through
    :func:`global_kfac_state`. Every rank of ``world`` must call it (the
    gathers); the tensors may share storage with the live state."""
    model_sd, opt_state, fsdp = state.model.state_dict(), state.opt_state, state.fsdp
    if fsdp is not None:
        model_sd.update(fsdp.whole_params())
        opt_state = fsdp.whole_momentum(opt_state)
    split = tensor_split_params(state.model)
    if split:
        opt_state = dict(opt_state)
        for n, (dim, w) in split.items():
            model_sd[n] = w.tensor_all_gather(model_sd[n], dim)
            opt_state[n] = w.tensor_all_gather(opt_state[n], dim)
    payload = {
        "format": FORMAT,
        "step": state.step,
        "model": model_sd,
        "opt_state": opt_state,
        "kfac_state": global_kfac_state(state.kfac_state, world),
    }
    if owner_form(state.kfac_state):
        payload["kfac_owner_world"] = world.size
    return payload


def save_checkpoint(checkpoint_dir: str, epoch: int, state: TrainState,
                    world: Optional[World] = None) -> str:
    """Write ``state`` as ``checkpoint-<epoch>`` in ``checkpoint_dir``
    (created if missing); returns the path. Only rank 0 writes; with an
    owner-sharded K-FAC state, or on a data×fsdp×tensor world, every rank
    of ``world`` (default: the default group's) must call it, for the
    gathers."""
    path = checkpoint_path(checkpoint_dir, epoch)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        # the overlap plane's side stream may still write the pending buffer
        torch.cuda.synchronize()
    payload = global_payload(state, world if world is not None else data_parallel_world())
    if not launch.is_primary():
        return path
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
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


def restore_checkpoint(checkpoint_dir: str, epoch: int, target: TrainState,
                       kfac: Any = None) -> TrainState:
    """The state saved for ``epoch``, copied into ``target``'s model,
    momentum buffers and K-FAC state (same structure, shapes and dtypes, or
    ``ValueError``). Returns a ``TrainState`` over the same objects.

    An owner-form K-FAC state gives this rank its own rows (saved on a
    world of the same size); with ``kfac``, the saved state is first placed
    per its sharding mode (:func:`rehome_kfac_state`: a replicated
    checkpoint into an owner preconditioner is re-homed, an owner one into
    a replicated preconditioner refused)."""
    device = next(target.model.parameters()).device
    saved = _load(checkpoint_dir, epoch, device)
    return restore_payload(saved, target, local_placement(kfac, saved.get("kfac_owner_world", 1)))


def local_placement(kfac: Any, saved_world: int):
    """The placement of a global-form K-FAC state saved over
    ``saved_world`` ranks: this rank's owner rows (:func:`local_kfac_state`),
    re-homed per ``kfac``'s sharding mode (:func:`rehome_kfac_state`)."""

    def place(saved_kfac):
        if owner_form(saved_kfac):
            world = kfac.world if kfac is not None else data_parallel_world()
            saved_kfac = local_kfac_state(saved_kfac, world, saved_world)
        return rehome_kfac_state(kfac, saved_kfac)

    return place


def restore_payload(saved: Dict[str, Any], target: TrainState, place) -> TrainState:
    """A :func:`global_payload` copied into ``target``: this tensor slot's
    part of the one-process layout, the K-FAC state passed through
    ``place`` (the global-form state → this rank's), every tensor copied
    into ``target``'s own (``copy_``). Returns a ``TrainState`` over the
    same objects."""
    saved_kfac = saved["kfac_state"]
    model_sd, saved_opt = saved["model"], saved["opt_state"]
    split = tensor_split_params(target.model)
    if split:
        # this tensor slot's part of the one-process layout
        w = next(iter(split.values()))[1]
        model_sd, saved_opt = dict(model_sd), dict(saved_opt)
        for n, (dim, _) in split.items():
            model_sd[n] = model_sd[n].chunk(w.tensor_size, dim)[w.tensor_rank]
            saved_opt[n] = saved_opt[n].chunk(w.tensor_size, dim)[w.tensor_rank]
        saved_kfac = _tensor_split(saved_kfac, w, lambda t: t.chunk(w.tensor_size)[w.tensor_rank])
    saved_kfac = place(saved_kfac)
    target.model.load_state_dict(model_sd)
    opt_state = _copy_into(target.opt_state, saved_opt, "opt_state")
    kfac_state = _copy_into(target.kfac_state, saved_kfac, "kfac_state")
    return TrainState(
        step=saved["step"], model=target.model, opt_state=opt_state, kfac_state=kfac_state,
        fsdp=target.fsdp,
    )


def restore_weights_only(checkpoint_dir: str, epoch: int) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (parameters and BatchNorm buffers) saved for
    ``epoch``, on the CPU, for a caller with no optimizer or K-FAC state."""
    return _load(checkpoint_dir, epoch, "cpu")["model"]


def auto_resume(checkpoint_dir: str, target: TrainState,
                kfac: Any = None) -> Tuple[TrainState, int]:
    """``(state, first epoch to run)``: the newest checkpoint restored into
    ``target`` (re-homed per ``kfac``'s sharding mode when given) and the
    epoch after it, or ``(target, 0)`` when there is none."""
    epoch = latest_epoch(checkpoint_dir)
    epoch = int(launch.broadcast_host_value(-1 if epoch is None else epoch))
    if epoch < 0:
        return target, 0
    return restore_checkpoint(checkpoint_dir, epoch, target, kfac), epoch + 1


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
    start of a run. What each rank holds of its own stays its own: the
    owner mode's shard rows and deferred ``factor_local``."""
    kfac_state = state.kfac_state or {}
    shared = {k: v for k, v in kfac_state.items()
              if not (owner_form(kfac_state) and k in PER_RANK_KEYS)}
    with torch.no_grad():
        world.broadcast_([
            *state.model.state_dict().values(),
            *_tensors(state.opt_state),
            *_tensors(shared),
        ])
