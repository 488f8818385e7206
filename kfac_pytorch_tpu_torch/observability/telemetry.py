"""Process-wide telemetry registry: spans, counters, gauges, histograms.

Port of ``kfac_pytorch_tpu/observability/telemetry.py``, with the same
names, reservoir and snapshot format, so the exporters' output is
text-equal for the same calls.

* **Near-zero overhead when disabled.** Telemetry is off by default;
  ``span()`` on a disabled registry returns a shared no-op singleton (no
  allocation, no clock read), and counters and gauges return at once.
* **Host-side only.** Nothing here launches device work. The port runs
  eagerly, so a ``trace/...`` span (named as in the JAX package, where it
  times tracing once per compile) times the host dispatch of each call
  without a sync; device-inclusive time comes from the step spans that
  ``block()`` on the step's output.
* **No sync in the hot loop.** A gauge may hold a 0-d tensor (a value that
  lives on the device, such as the int8 wire's quantization-error norm); it
  is read back only by :meth:`Telemetry.snapshot`, that is at export time.
* **Fixed metric names.** Every span, counter and gauge name is a string
  literal registered in docs/OBSERVABILITY.md
  (``tests/test_torch_port_observability.py`` lints the port's sources).

Spans nest freely (each records its own duration into its own histogram)
and are reentrant. Each process owns one registry; rank-aware aggregation
happens at summary time (export.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

# Per-histogram sample cap: one float per observation, so an unbounded run
# cannot grow host memory without bound. At the cap the reservoir keeps the
# FIRST samples (steady-state spans are stationary).
_HIST_CAP = 65536


def _cuda_device(obj) -> Optional[torch.device]:
    """The device of the first CUDA tensor in a nest of dicts, lists and
    tuples (a step's metrics or state), or ``None``."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return None
    for v in obj:
        d = _cuda_device(v)
        if d is not None:
            return d
    return None


class _NullSpan:
    """Shared no-op span for the disabled path: zero allocation per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def block(self, obj) -> None:  # matches Span.block
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """Context-manager timer recording seconds into a named histogram.

    ``block(obj)`` registers a value (typically the step's output) whose
    CUDA device is synchronized on exit, so the recorded duration includes
    the device work an asynchronous launch would otherwise hide; on CPU
    tensors it is a no-op. Without it a span times only the dispatch.
    """

    __slots__ = ("_telemetry", "_name", "_t0", "_sync")

    def __init__(self, telemetry: "Telemetry", name: str):
        self._telemetry = telemetry
        self._name = name
        self._t0 = 0.0
        self._sync = None

    def block(self, obj) -> None:
        self._sync = obj

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None and self._telemetry.block_spans:
            device = _cuda_device(self._sync)
            if device is not None:
                torch.cuda.synchronize(device)
        self._telemetry.observe(self._name, time.perf_counter() - self._t0)
        return False


class Telemetry:
    """One process's metric registry.

    * ``inc(name, by)``: monotonic counters.
    * ``set_gauge(name, v)``: last-value-wins scalars; a tensor is kept as
      given and read at :meth:`snapshot`.
    * ``observe(name, v)``: histogram samples (span durations, in seconds).
    * ``span(name)``: context-manager timer feeding ``observe``.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        # Whether Span.block() registrations synchronize on exit: True gives
        # device-inclusive durations, False dispatch time only (the
        # trainers set False under KFAC(comm_overlap=True), whose side
        # stream a synchronize would serialize).
        self.block_spans = True
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.hists: Dict[str, List[float]] = {}

    # -- write side ------------------------------------------------------

    def inc(self, name: str, by: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0.0) + by

    def set_gauge(self, name: str, value) -> None:
        if not self.enabled:
            return
        self.gauges[name] = value.detach() if isinstance(value, torch.Tensor) else float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = []
        if len(h) < _HIST_CAP:
            h.append(float(value))

    def span(self, name: str):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name)

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()

    # -- read side -------------------------------------------------------

    def percentiles(
        self, name: str, qs: Tuple[float, ...] = (0.5, 0.95)
    ) -> Optional[Tuple[float, ...]]:
        """Sorted-sample percentiles of one histogram; None if empty."""
        h = self.hists.get(name)
        if not h:
            return None
        s = sorted(h)
        n = len(s)
        return tuple(s[min(n - 1, int(q * n))] for q in qs)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Flat point-in-time view: counters verbatim, gauges as floats (a
        tensor gauge is read back here), histograms reduced to
        count/sum/p50/p95; the exporters' input format."""
        out: Dict[str, Dict[str, float]] = {
            "counters": dict(self.counters),
            "gauges": {k: float(v) for k, v in self.gauges.items()},
            "spans": {},
        }
        for name, h in self.hists.items():
            if not h:
                continue
            p50, p95 = self.percentiles(name) or (0.0, 0.0)
            out["spans"][name] = {
                "count": float(len(h)),
                "sum": float(sum(h)),
                "p50": p50,
                "p95": p95,
            }
        return out


_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    """The process-wide registry (disabled until :func:`configure`)."""
    return _GLOBAL


def configure(
    enabled: bool = True, block_spans: Optional[bool] = None
) -> Telemetry:
    """Enable or disable the process-wide registry and return it.

    ``block_spans=False`` turns span ``block()`` synchronizations into
    no-ops; ``None`` leaves the current setting untouched.
    """
    _GLOBAL.enabled = enabled
    if block_spans is not None:
        _GLOBAL.block_spans = bool(block_spans)
    return _GLOBAL
