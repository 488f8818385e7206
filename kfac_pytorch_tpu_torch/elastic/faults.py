"""Deterministic fault injection for the elastic recovery paths.

Port of ``kfac_pytorch_tpu/elastic/faults.py``. Recovery code that only
real preemptions exercise is recovery code that does not work; this
harness makes every failure mode the supervisor handles reproducible on
the CPU, keyed by step so two runs inject identically:

* **kill-at-step** — at step k either deliver a real SIGTERM to this
  process (the installed handler and the emergency snapshot), hard-exit
  without unwinding (``os._exit``, the closest userspace analog of a pod
  eviction: nothing is saved beyond the last periodic snapshot), or raise
  :class:`SimulatedPreemption` for in-process tests;
* **drop-host** — the surviving ranks after one simulated host's are lost,
  for the resized world the replan must serve;
* **truncated / corrupt snapshot** — damage a snapshot directory the way a
  mid-write kill or bitrot would, so tests can pin that scan-resume skips
  it instead of crashing.

Trainers wire the environment's form (``KFAC_FAULT_KILL_AT_STEP=k``,
``KFAC_FAULT_KILL_MODE=signal|exit|raise``, ``KFAC_FAULT_EXIT_CODE=n``)
through :func:`maybe_injector`, which is how a test or ``chip_smoke.py``
kills a real trainer subprocess at a chosen step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
from typing import Any, Optional, Sequence

from kfac_pytorch_tpu_torch.elastic import state_io

ENV_KILL_AT_STEP = "KFAC_FAULT_KILL_AT_STEP"
ENV_KILL_MODE = "KFAC_FAULT_KILL_MODE"
ENV_EXIT_CODE = "KFAC_FAULT_EXIT_CODE"
DEFAULT_EXIT_CODE = 75  # EX_TEMPFAIL: "try again", what a preemption is


class SimulatedPreemption(RuntimeError):
    """In-process kill mode: unwinds to the trainer's resume logic."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic fault schedule (pure data, built from the
    environment or by a test)."""

    kill_at_step: Optional[int] = None
    kill_mode: str = "signal"  # "signal" | "exit" | "raise"
    exit_code: int = DEFAULT_EXIT_CODE

    def __post_init__(self):
        if self.kill_mode not in ("signal", "exit", "raise"):
            raise ValueError(f"unknown kill_mode: {self.kill_mode!r}")

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultSpec"]:
        env = os.environ if env is None else env
        at = env.get(ENV_KILL_AT_STEP)
        if at is None:
            return None
        return cls(
            kill_at_step=int(at),
            kill_mode=env.get(ENV_KILL_MODE, "signal"),
            exit_code=int(env.get(ENV_EXIT_CODE, DEFAULT_EXIT_CODE)),
        )


class FaultInjector:
    """Fires the spec's faults at their steps; idempotent once fired."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.fired = False

    def on_step(self, step: int, supervisor: Any = None) -> None:
        """The supervisor calls this FIRST in its per-step hook, so a
        signal-mode kill is observed by the very same ``on_step`` and the
        emergency snapshot lands at the kill step."""
        spec = self.spec
        if self.fired or spec.kill_at_step is None or step < spec.kill_at_step:
            return
        self.fired = True
        if spec.kill_mode == "signal":
            # a REAL signal through the installed handler, run on this
            # (main) thread before os.kill returns
            os.kill(os.getpid(), signal.SIGTERM)
        elif spec.kill_mode == "exit":
            sys.stderr.write(f"[faults] hard-killing at step {step} (exit {spec.exit_code})\n")
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(spec.exit_code)
        else:
            raise SimulatedPreemption(f"injected preemption at step {step}")


def maybe_injector(env=None) -> Optional[FaultInjector]:
    """The environment's injector, or None when no fault is scheduled."""
    spec = FaultSpec.from_env(env)
    return None if spec is None else FaultInjector(spec)


def drop_hosts(ranks: Sequence[Any], drop: int, ranks_per_host: int) -> list:
    """The surviving ranks after simulated host ``drop`` is lost: hosts
    are consecutive ``ranks_per_host`` slices of ``ranks``, as launchers
    number them. Start the post-loss world from the result and resume
    through the resize replan."""
    n_hosts = len(ranks) // ranks_per_host
    if not 0 <= drop < n_hosts:
        raise ValueError(f"drop={drop} out of range for {n_hosts} simulated hosts")
    lo = drop * ranks_per_host
    hi = lo + ranks_per_host
    return [r for i, r in enumerate(ranks) if not lo <= i < hi]


def truncate_snapshot(snap: str) -> None:
    """Make ``snap`` look killed mid-write: payload present, no manifest."""
    path = os.path.join(snap, state_io.MANIFEST_NAME)
    if os.path.exists(path):
        os.remove(path)


def corrupt_snapshot(snap: str) -> None:
    """Scribble over the manifest the way torn storage would."""
    with open(os.path.join(snap, state_io.MANIFEST_NAME), "wb") as fh:
        fh.write(b"\x00garbage\xff not json")


def mark_incomplete(snap: str) -> None:
    """Flip the manifest's complete flag (a write that never committed)."""
    path = os.path.join(snap, state_io.MANIFEST_NAME)
    with open(path) as fh:
        manifest = json.load(fh)
    manifest["complete"] = False
    with open(path, "w") as fh:
        json.dump(manifest, fh)
