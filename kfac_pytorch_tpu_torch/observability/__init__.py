"""Structured telemetry for the port's K-FAC training stack.

* :mod:`.telemetry`: spans, counters, gauges, histograms in a process-wide
  registry (no-op when disabled).
* :mod:`.export`: Prometheus textfile, JSONL stream, rank-aware summary.
* :mod:`.diagnostics`: the K-FAC health-key vocabulary.
* :mod:`.trace`: the flight recorder, a per-host append-only structured
  event log with cross-process correlation keys (no-op when disabled).
"""

from kfac_pytorch_tpu_torch.observability.diagnostics import (  # noqa: F401
    LAYER_COND_KEYS,
    SCALAR_KEYS,
    diagnostic_metrics,
)
from kfac_pytorch_tpu_torch.observability.export import (  # noqa: F401
    flush_jsonl,
    prometheus_lines,
    summary_table,
    write_prometheus,
)
from kfac_pytorch_tpu_torch.observability.telemetry import (  # noqa: F401
    Span,
    Telemetry,
    configure,
    get_telemetry,
)
from kfac_pytorch_tpu_torch.observability.trace import (  # noqa: F401
    TraceRecorder,
    configure_trace,
    get_trace,
)
