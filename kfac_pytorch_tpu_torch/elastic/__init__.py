"""Elastic runtime: preemption-tolerant, resizable K-FAC (PyTorch port).

Port of ``kfac_pytorch_tpu/elastic/``: the full curvature state is durable
(:mod:`~kfac_pytorch_tpu_torch.elastic.state_io`), the owner-shard plan is
re-derived deterministically on a resized world
(:mod:`~kfac_pytorch_tpu_torch.elastic.replan`), the host loop snapshots
on preemption and resumes by scan
(:mod:`~kfac_pytorch_tpu_torch.elastic.supervisor`), and every recovery
path is testable on the CPU through deterministic fault injection
(:mod:`~kfac_pytorch_tpu_torch.elastic.faults`). The CIFAR, transformer
LM and WikiText trainers wire it through ``--preempt-save-dir`` and
``--snapshot-every``.
"""

from kfac_pytorch_tpu_torch.elastic import faults, replan, state_io, supervisor
from kfac_pytorch_tpu_torch.elastic.faults import (
    FaultInjector,
    FaultSpec,
    SimulatedPreemption,
    maybe_injector,
)
from kfac_pytorch_tpu_torch.elastic.replan import replan_state, resize_owner_state
from kfac_pytorch_tpu_torch.elastic.state_io import (
    KFAC_STATE_KEYS,
    SnapshotError,
    latest_snapshot,
    list_snapshots,
    load_manifest,
    restore_snapshot,
    save_snapshot,
)
from kfac_pytorch_tpu_torch.elastic.supervisor import Preempted, Supervisor

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "KFAC_STATE_KEYS",
    "Preempted",
    "SimulatedPreemption",
    "SnapshotError",
    "Supervisor",
    "faults",
    "latest_snapshot",
    "list_snapshots",
    "load_manifest",
    "maybe_injector",
    "replan",
    "replan_state",
    "resize_owner_state",
    "restore_snapshot",
    "save_snapshot",
    "state_io",
    "supervisor",
]
