"""Metric accumulation + scalar logging (port of ``training/metrics.py``).

``ScalarWriter`` always writes ``scalars.jsonl`` (one ``{"ts", "tag",
"value", "step"}`` object per line, the JAX trainer's schema) and, where
the ``tensorboard`` package imports, TensorBoard events beside it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class Metric:
    """Running mean of a scalar stream."""

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.n = 0

    def update(self, value: float) -> None:
        self.total += float(value)
        self.n += 1

    @property
    def avg(self) -> float:
        return self.total / max(self.n, 1)


class ScalarWriter:
    """JSONL scalar stream, plus TensorBoard events when importable.

    ``log_dir=None`` writes nothing. ``close()`` closes both streams.
    ``filename`` lets a second stream share a run directory and the schema
    (the telemetry exporter writes ``telemetry.jsonl`` through this class).
    """

    def __init__(self, log_dir: Optional[str], filename: str = "scalars.jsonl"):
        self._tb = None
        self._fh = None
        if not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, filename), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: JSONL only
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._fh is not None:
            self._fh.write(
                json.dumps(
                    {"ts": time.time(), "tag": tag, "value": float(value), "step": step}
                )
                + "\n"
            )
            self._fh.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._fh is not None:
            self._fh.close()
