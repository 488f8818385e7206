"""Flight recorder: per-host append-only structured event log.

Port of ``kfac_pytorch_tpu/observability/trace.py``. Each process gets an
append-only ``trace.jsonl`` of structured events carrying correlation keys
(``basis_version``, ``snapshot_id``, ``plan_fingerprint``) so several
hosts' files can be stitched into one causally ordered timeline after the
fact.

Off by default: every call site then costs one attribute lookup and a
no-op method on a shared ``_NullRecorder`` singleton, and events are
host-side only, so no tensor changes either way.

Record schema (one JSON object per line)::

    {"ts_ns": <time.time_ns()>, "host": <int>, "pid": <os.getpid()>,
     "kind": "<event kind literal>", ...fields}

``kind`` is a string literal at every call site, registered in
docs/OBSERVABILITY.md's event registry. The host id is the caller's
``host=``, else ``KFAC_TRACE_HOST``, else this process's rank
(``parallel.launch.rank()``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, IO, Optional


def _default_host() -> int:
    val = os.environ.get("KFAC_TRACE_HOST")
    if val is not None:
        try:
            return int(val)
        except ValueError:
            pass
    from kfac_pytorch_tpu_torch.parallel import launch

    return launch.rank()


def _coerce(obj: Any) -> Any:
    """JSON fallback for numpy and torch scalars and arrays in event fields."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        return tolist()
    return str(obj)


class _NullRecorder:
    """Shared no-op recorder: the disabled path is a bound-method call."""

    __slots__ = ()

    enabled = False
    path = None
    host = 0

    def event(self, kind: str, **fields: Any) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


_NULL = _NullRecorder()


class TraceRecorder:
    """Append-only JSONL event writer for one process.

    Thread-safe; each event is flushed at once, so a killed process leaves
    a complete record of everything up to the kill.
    """

    enabled = True

    def __init__(self, path: str, host: Optional[int] = None) -> None:
        self.path = str(path)
        self.host = _default_host() if host is None else int(host)
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = open(self.path, "a")

    def event(self, kind: str, **fields: Any) -> None:
        rec = {
            "ts_ns": time.time_ns(),
            "host": self.host,
            "pid": os.getpid(),
            "kind": kind,
        }
        rec.update(fields)
        line = json.dumps(rec, default=_coerce)
        with self._lock:
            fh = self._fh
            if fh is None:
                return
            fh.write(line + "\n")
            fh.flush()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_GLOBAL = _NULL


def get_trace():
    """The process-global recorder (the null singleton unless configured)."""
    return _GLOBAL


def configure_trace(path: Optional[str] = None, host: Optional[int] = None):
    """Install (or tear down) the process-global flight recorder.

    ``configure_trace("<dir>/trace.jsonl", host=rank)`` starts recording;
    ``configure_trace(None)`` closes the current recorder and restores the
    null singleton. Returns the active recorder either way.
    """
    global _GLOBAL
    prev = _GLOBAL
    if isinstance(prev, TraceRecorder):
        prev.close()
    _GLOBAL = _NULL if path is None else TraceRecorder(path, host=host)
    return _GLOBAL
