"""Versioned, sharding-aware snapshot I/O for the full K-FAC training state.

Port of ``kfac_pytorch_tpu/elastic/state_io.py``: the durability layer of
the elastic runtime. Every state key any lever can create is named in
:data:`KFAC_STATE_KEYS` (the JAX package's table, key for key), and a
snapshot is refused if the live state carries a key outside it.

A snapshot is a directory ``snap-<step>/`` holding ``state.pt``, a
``torch.save`` payload (tensors, dicts, lists, numbers and strings only,
so it loads with ``weights_only=True``; the JAX package writes an orbax
directory there), and ``kfac_manifest.json``, written AFTER the payload
through a ``.tmp`` file and ``os.replace``: a kill mid-write leaves no
manifest, and the scan-resume path (:func:`latest_snapshot`) skips such
incomplete or corrupt directories instead of crashing on them. The
manifest has the JAX manifest's fields and values: the resolved planner
``Plan`` (its ``to_state`` int encoding), the owner-shard plan's
fingerprint, the host-side ``EigenRefreshCadence`` state (without which a
mid-interval resume would bootstrap again and diverge), the K-FAC data
world the shard stacks were sized to (``kfac.world.size``, which excludes
a tensor axis; what the resize replan re-plans from), and the replica-local
packing.

The payload is the epoch checkpoint's one-process global layout
(``training.checkpoint.global_payload``: owner rows gathered into
``[world·rows, …]``, the tensor-split and fsdp parameters gathered, the
split layers' K-FAC blocks gathered), so every rank enters
:func:`capture_snapshot` and rank 0 writes. What the epoch checkpoint
keeps only rank 0's of, a snapshot keeps every rank's: the replica-local
keys :data:`_REPLICA_LOCAL_KEYS` (the owner mode's deferred
``factor_local`` accumulators and the int8 wire's ``wire_error``
residuals) are gathered from every rank into a ``[packed_world, …]``
leading axis in rank order (:func:`pack_replica_local`), and a restore on
the same number of ranks gives each rank its own row back
(:func:`unpack_replica_local`), so a mid-flush-window resume is bitwise
across ranks. A replicated run's deferred ``factors`` are not packed, as
in the JAX package: such a snapshot holds rank 0's running averages.
A trainer's per-rank host-loop tensors (an RNN's recurrent carry) ride the
same way, under the payload's ``aux``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.step import TrainState

MANIFEST_VERSION = 1
MANIFEST_NAME = "kfac_manifest.json"
PAYLOAD_NAME = "state.pt"
_SNAP_PREFIX = "snap-"

#: Every top-level key the K-FAC state dict can carry, by lever (the JAX
#: package's table, with the same keys and texts).
KFAC_STATE_KEYS: Dict[str, str] = {
    "step": "global update counter (int32 scalar)",
    "factors": "per-layer A/A_diag/G running averages "
               "(owner mode: scalar placeholders keeping the name registry)",
    "eigen": "per-layer eigen entries for singleton shapes "
             "(QA/dA[/rhoA], QG/dG[/rhoG] or iA/iG; rsvd tables included)",
    "eigen_stacked": "batched eigen entries for same-shape layer groups "
                     "(<g>x<a> stacks)",
    "eigen_pending": "chunked-refresh double buffer in full per-layer form "
                     "(eigh_chunks > 1, replicated mode)",
    "factor_shard": "owner-sharded factor stacks n<size>/v<size>, leading "
                    "axis world*rows split over the mesh",
    "eigen_shard": "owner-sharded eigen stacks (Q/d[/rho] per size group)",
    "eigen_pending_shard": "owner-sharded pending double buffer "
                           "(eigh_chunks > 1, owner mode)",
    "factor_local": "per-replica local factor accumulators between deferred "
                    "flushes (owner mode, factor_comm_freq > 1)",
    "wire_error": "per-replica int8-wire error-feedback residuals, one flat "
                  "f32 buffer per comm bucket (factor_comm_dtype='int8')",
    "factor_sync_age": "capture steps since the last cross-replica factor "
                       "merge (int32 scalar, 0 = globally synced)",
    "spectrum_mass": "trace fraction the truncated bases captured at the "
                     "last refresh (solver='rsvd'/'streaming')",
    "stream_residual": "drift gauge: curvature mass fraction outside the "
                       "retained bases after the last fold "
                       "(solver='streaming', f32 scalar)",
    "stream_fold_steps": "capture folds since the last re-orthonormalization "
                         "(solver='streaming', int32 scalar)",
    "eigen_swap_slip": "1 while a fully-landed pending basis awaits its "
                       "slipped swap (staleness_budget > 0)",
    "diagnostics": "in-graph health diagnostics (track_diagnostics=True)",
}

#: State keys holding per-RANK data: each rank's copy genuinely differs, so
#: a snapshot packs every rank's (see :func:`pack_replica_local`).
_REPLICA_LOCAL_KEYS: Tuple[str, ...] = ("factor_local", "wire_error")


class SnapshotError(RuntimeError):
    """A snapshot is unreadable, incomplete, or from a different contract."""


def manifest_keys() -> frozenset:
    return frozenset(KFAC_STATE_KEYS)


def kfac_state_of(state: Any) -> Optional[Dict[str, Any]]:
    """The K-FAC state dict inside ``state`` (a ``TrainState`` or the dict
    itself), or None when it carries no curvature state."""
    if isinstance(state, TrainState):
        return state.kfac_state
    if isinstance(state, dict) and "factors" in state:
        return state
    return None


def validate_state_keys(kfac_state: Optional[Dict[str, Any]]) -> List[str]:
    """The sorted key list, refusing keys outside the manifest."""
    if kfac_state is None:
        return []
    unknown = sorted(set(kfac_state) - manifest_keys())
    if unknown:
        raise SnapshotError(
            f"K-FAC state carries keys outside the state_io manifest: "
            f"{unknown} — add them to KFAC_STATE_KEYS (and the docs) before "
            f"they can be snapshot"
        )
    return sorted(kfac_state)


def _plan_encoding(kfac: Any) -> Optional[Dict[str, int]]:
    """The resolved planner Plan's ``to_state`` encoding, as plain ints."""
    plan = getattr(kfac, "plan", None)
    if plan is None:
        return None
    return {k: int(v) for k, v in plan.to_state().items()}


def _shard_fingerprint(kfac: Any) -> Optional[str]:
    """Digest of the owner-shard layout the live state was placed by, once
    ``init`` derived the (single) cached plan."""
    plans = getattr(kfac, "_shard_plans", None)
    if not plans or len(plans) != 1:
        return None
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_fingerprint

    return plan_fingerprint(next(iter(plans.values())))


def _step_of(state: Any) -> Optional[int]:
    step = state.step if isinstance(state, TrainState) else (
        state.get("step") if isinstance(state, dict) else None)
    return None if step is None else int(step)


def build_manifest(
    state: Any,
    kfac: Any = None,
    cadence: Any = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The JSON manifest describing ``state``: everything a restore or a
    replan needs that the payload itself does not carry."""
    kstate = kfac_state_of(state)
    keys = validate_state_keys(kstate)
    sharding = "none"
    if kstate is not None:
        sharding = "owner" if "factor_shard" in kstate else "replicated"
    return {
        "format": "kfac-elastic-snapshot",
        "version": MANIFEST_VERSION,
        "step": _step_of(state),
        "kfac_state_keys": keys,
        "sharding": sharding,
        "world": int(kfac.world.size) if kfac is not None else launch.size(),
        "plan": _plan_encoding(kfac) if kfac is not None else None,
        "shard_plan_fingerprint": _shard_fingerprint(kfac) if kfac is not None else None,
        "cadence": cadence.state_dict() if cadence is not None else None,
        "extra": dict(extra or {}),
    }


def _tree_map(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(v, fn) for v in tree)
    return tree


def _pack(tree: Any) -> Any:
    """Every rank's ``tree``, each tensor stacked ``[ranks, …]`` in rank
    order (one gather per tensor over the default group; every rank must
    call it)."""
    return _tree_map(tree, lambda t: data_parallel_world().all_gather_flat(t.contiguous()))


def _unpack(tree: Any, what: str) -> Any:
    """This rank's row of every ``[ranks, …]`` stack of ``tree``."""
    ranks, rank = launch.size(), launch.rank()

    def row(t):
        if t.shape[0] != ranks:
            raise SnapshotError(
                f"packed {what} world {t.shape[0]} != mesh size {ranks} — "
                f"resize replans drop deferred accumulators"
            )
        return t[rank].contiguous()

    return _tree_map(tree, row)


def pack_replica_local(state: Any) -> Tuple[Any, bool]:
    """``(state, packed)``: every :data:`_REPLICA_LOCAL_KEYS` entry stacked
    into a ``[ranks, …]`` leading axis, row ``r`` rank ``r``'s (one process
    packs its own as row 0, as the JAX package does on one device). Every
    rank must call it."""
    kstate = kfac_state_of(state)
    keys = [k for k in _REPLICA_LOCAL_KEYS if kstate is not None and k in kstate]
    if not keys:
        return state, False
    kstate = {**kstate, **{k: _pack(kstate[k]) for k in keys}}
    if isinstance(state, TrainState):
        return dataclasses.replace(state, kfac_state=kstate), True
    return kstate, True


def unpack_replica_local(kfac_state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`pack_replica_local` on the same number of ranks:
    this rank's row of each packed key; another number of ranks is
    refused."""
    keys = [k for k in _REPLICA_LOCAL_KEYS if k in kfac_state]
    return {**kfac_state, **{k: _unpack(kfac_state[k], "replica-local") for k in keys}}


def snapshot_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{_SNAP_PREFIX}{step}")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of its own (a CPU tensor's too), so that the next step's
    in-place updates (kernel 4, the EMAs) cannot reach a payload being
    written; a CUDA tensor's lands in pinned memory, copied asynchronously
    (the caller synchronizes once after the last)."""
    if t.device.type != "cuda":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t.detach(), non_blocking=True)


def capture_snapshot(
    step: int,
    state: TrainState,
    kfac: Any = None,
    cadence: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    aux: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(payload, manifest)`` of ``state`` at ``step``: every tensor a host
    copy of its own (taken after the device, the overlap plane's side
    stream included, is idle), so a background write may run beside the
    next steps. Every rank must call it (the gathers); ``aux`` is this
    rank's host-loop tensors, packed over the ranks."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    world = kfac.world if kfac is not None else data_parallel_world()
    manifest = build_manifest(state, kfac=kfac, cadence=cadence, extra=extra)
    live, packed = pack_replica_local(state)
    payload = ckpt.global_payload(live, world)
    payload["format"] = "kfac-elastic-snapshot"
    if aux is not None:
        payload["aux"] = _pack(aux)
    manifest["packed_replica_local"] = packed
    if packed:
        # the number of ranks, which a tensor axis makes distinct from
        # "world" (the data×fsdp replicas)
        manifest["packed_world"] = launch.size()
    if manifest["step"] is None:
        manifest["step"] = int(step)
    payload = _tree_map(payload, _host_copy)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return payload, manifest


def write_snapshot(directory: str, step: int, payload: Dict[str, Any],
                   manifest: Dict[str, Any]) -> str:
    """Write a captured snapshot as ``<directory>/snap-<step>`` on rank 0:
    the payload first, the manifest (``"complete": true``) last, each
    through a temporary name and ``os.replace``. Returns the path."""
    snap = snapshot_dir(directory, step)
    if launch.is_primary():
        os.makedirs(snap, exist_ok=True)
        tmp = os.path.join(snap, PAYLOAD_NAME + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(snap, PAYLOAD_NAME))
        manifest = {**manifest, "complete": True}
        tmp = os.path.join(snap, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(tmp, os.path.join(snap, MANIFEST_NAME))
    return snap


def save_snapshot(
    directory: str,
    step: int,
    state: TrainState,
    kfac: Any = None,
    cadence: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    aux: Optional[Dict[str, Any]] = None,
) -> str:
    """Write one complete snapshot ``<directory>/snap-<step>``
    (:func:`capture_snapshot`, then :func:`write_snapshot`); every rank
    must call it."""
    payload, manifest = capture_snapshot(step, state, kfac, cadence, extra, aux)
    return write_snapshot(directory, step, payload, manifest)


def load_manifest(snap: str) -> Dict[str, Any]:
    """The manifest of one snapshot directory, validated."""
    path = os.path.join(snap, MANIFEST_NAME)
    if not os.path.isfile(path):
        raise SnapshotError(f"incomplete snapshot (no manifest): {snap}")
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise SnapshotError(f"unreadable manifest in {snap}: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("format") != "kfac-elastic-snapshot":
        raise SnapshotError(f"not a kfac elastic snapshot: {snap}")
    if manifest.get("version") != MANIFEST_VERSION:
        raise SnapshotError(
            f"snapshot version {manifest.get('version')} != "
            f"{MANIFEST_VERSION}: {snap}"
        )
    if not manifest.get("complete"):
        raise SnapshotError(f"snapshot marked incomplete: {snap}")
    return manifest


def list_snapshots(directory: str) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of COMPLETE snapshots, newest last; incomplete or
    corrupt directories are skipped (scan-resume semantics)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if not name.startswith(_SNAP_PREFIX):
            continue
        tail = name[len(_SNAP_PREFIX):]
        if not tail.isdigit():
            continue
        snap = os.path.join(directory, name)
        try:
            load_manifest(snap)
        except SnapshotError:
            continue
        out.append((int(tail), snap))
    return sorted(out)


def latest_snapshot(directory: str) -> Optional[Tuple[int, str]]:
    snaps = list_snapshots(directory)
    return snaps[-1] if snaps else None


def load_payload(snap: str, device: Any) -> Dict[str, Any]:
    """The payload of one snapshot directory, its tensors on ``device``."""
    try:
        payload = torch.load(os.path.join(snap, PAYLOAD_NAME), map_location=device,
                             weights_only=True)
    except Exception as e:  # noqa: BLE001 — any unreadable payload is one error
        raise SnapshotError(f"unreadable payload in {snap}: {type(e).__name__}: {e}") from e
    if not isinstance(payload, dict) or payload.get("format") != "kfac-elastic-snapshot":
        raise SnapshotError(f"not a kfac elastic snapshot payload: {snap}")
    return payload


def _default_place(kfac: Any, manifest: Dict[str, Any]) -> Callable[[Any], Any]:
    """The same-world placement: this rank's replica-local rows, then the
    epoch checkpoint's (this rank's owner rows, the state re-homed per
    ``kfac``'s mode)."""
    local = ckpt.local_placement(kfac, int(manifest.get("world") or 1))

    def place(kstate):
        validate_state_keys(kstate)
        if kstate is not None and manifest.get("packed_replica_local"):
            kstate = unpack_replica_local(kstate)
        return local(kstate)

    return place


def restore_snapshot(
    snap: str,
    target: TrainState,
    kfac: Any = None,
    cadence: Any = None,
    place: Optional[Callable[[Any], Any]] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """``(state, manifest)`` from one snapshot directory.

    The saved tensors are copied into ``target``'s own (its model, momentum
    buffers and K-FAC state: same structure, shapes and dtypes, or
    ``ValueError``), so a kept ``apply_kernels.SGDPlan`` stays valid. The
    K-FAC state goes through ``place`` (default: this rank's owner rows of
    a snapshot of the same world, re-homed per ``kfac``'s sharding mode by
    ``training.checkpoint.rehome_kfac_state``, and this rank's
    replica-local rows); with ``cadence`` the host-side interval state
    recorded at save time is loaded back, which makes mid-interval resumes
    exact. The returned manifest also holds ``aux``, this rank's row of
    the saved host-loop tensors (None when there are none)."""
    manifest = load_manifest(snap)
    device = next(target.model.parameters()).device
    payload = load_payload(snap, device)
    state = ckpt.restore_payload(payload, target, place or _default_place(kfac, manifest))
    if cadence is not None and manifest.get("cadence") is not None:
        cadence.load_state_dict(manifest["cadence"])
    aux = payload.get("aux")
    manifest["aux"] = None if aux is None else _unpack(aux, "host-loop")
    return state, manifest


def broadcast_latest(directory: str) -> Optional[Tuple[int, str]]:
    """Rank 0's :func:`latest_snapshot`, the same on every rank."""
    found = latest_snapshot(directory) if launch.is_primary() else None
    step = int(launch.broadcast_host_value(-1 if found is None else found[0]))
    return None if step < 0 else (step, snapshot_dir(directory, step))

