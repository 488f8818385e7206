"""Telemetry exporters: Prometheus textfile, JSONL stream, summary table.

Port of ``kfac_pytorch_tpu/observability/export.py``; the three sinks
print the same text for the same snapshot:

* :func:`write_prometheus`: the node-exporter textfile-collector contract,
  a ``metrics.prom`` file written whole and renamed into place, so a
  scraper never reads a torn file. Counters export as ``counter``, gauges
  as ``gauge``, span histograms as ``summary`` (p50/p95 plus
  ``_sum``/``_count``).
* :func:`flush_jsonl`: appends the snapshot to a
  :class:`~kfac_pytorch_tpu_torch.training.metrics.ScalarWriter` stream,
  one record per metric, tagged with its kind.
* :func:`summary_table`: the end-of-run view, p50/p95/total per span plus
  counters. Over several processes the ranks' span names are gathered,
  then the raw span reservoirs over their union with two
  ``torch.distributed.all_gather`` calls, and the percentiles are
  recomputed from the merged sample.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.observability.telemetry import Telemetry
from kfac_pytorch_tpu_torch.parallel import launch

_PROM_PREFIX = "kfac"
_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name (``step/plain`` ->
    ``kfac_step_plain``)."""
    return f"{_PROM_PREFIX}_{_SANITIZE.sub('_', name)}"


def prometheus_lines(snapshot: Dict[str, Dict]) -> list:
    """Render a :meth:`Telemetry.snapshot` in Prometheus text format."""
    lines = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v:g}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v:g}")
    for name, s in sorted(snapshot.get("spans", {}).items()):
        pn = prom_name(name) + "_seconds"
        lines.append(f"# TYPE {pn} summary")
        lines.append(f'{pn}{{quantile="0.5"}} {s["p50"]:g}')
        lines.append(f'{pn}{{quantile="0.95"}} {s["p95"]:g}')
        lines.append(f"{pn}_sum {s['sum']:g}")
        lines.append(f"{pn}_count {s['count']:g}")
    return lines


def write_prometheus(path: str, telemetry: Telemetry) -> str:
    """Atomically (re)write ``path`` (e.g. ``<dir>/metrics.prom``):
    write-to-temp + ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write("\n".join(prometheus_lines(telemetry.snapshot())) + "\n")
    os.replace(tmp, path)
    return path


def flush_jsonl(writer, telemetry: Telemetry, step: int) -> None:
    """Append the current snapshot to a ScalarWriter's JSONL stream: one
    record per metric, counters as ``counter/<name>``, gauges as
    ``gauge/<name>``, spans as ``span/<name>/{p50_ms,p95_ms,count}``
    (milliseconds here; Prometheus keeps seconds)."""
    snap = telemetry.snapshot()
    for name, v in sorted(snap["counters"].items()):
        writer.add_scalar(f"counter/{name}", v, step)
    for name, v in sorted(snap["gauges"].items()):
        writer.add_scalar(f"gauge/{name}", v, step)
    for name, s in sorted(snap["spans"].items()):
        writer.add_scalar(f"span/{name}/p50_ms", s["p50"] * 1e3, step)
        writer.add_scalar(f"span/{name}/p95_ms", s["p95"] * 1e3, step)
        writer.add_scalar(f"span/{name}/count", s["count"], step)


def _comm_device() -> torch.device:
    """Where the reservoirs travel: NCCL takes CUDA tensors only; gloo
    stages host tensors (its point-to-point aborts on CUDA pointers)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather(t: torch.Tensor) -> np.ndarray:
    """``[n_proc, *t.shape]``: every process's ``t``."""
    parts = [torch.empty_like(t) for _ in range(launch.size())]
    dist.all_gather(parts, t, group=launch.world_group())
    return torch.stack(parts).cpu().numpy()


def _allgather_span_samples(hists):
    """Merge every rank's raw span-duration reservoirs.

    Returns ``{name: merged sorted 1-D sample array}`` over the union of the
    ranks' span names. Ranks need not record the same spans (an owner-mode
    rank that owns no apply group never opens ``trace/kfac/apply_kernel``),
    so the name lists are gathered first and every rank gathers over their
    sorted union, a span it never recorded counting 0 samples: all ranks
    then make the same collectives with the same shapes. The reservoirs are
    ragged across ranks while ``all_gather`` needs equal shapes, so: gather
    per-span counts, NaN-pad every rank's samples to the global max count,
    gather once more, and slice each rank's real samples back out by its
    count. Every rank reaches every collective.
    """
    lists = [None] * launch.size()
    dist.all_gather_object(lists, sorted(hists), group=launch.world_group())
    names = sorted(set().union(*lists))
    if not names:
        return {}
    device = _comm_device()
    counts = torch.tensor([len(hists.get(n, ())) for n in names], dtype=torch.int64)
    all_counts = _allgather(counts.to(device))  # [n_proc, n_spans]
    cap = max(1, int(all_counts.max()))
    local = np.full((len(names), cap), np.nan, dtype=np.float64)
    for i, n in enumerate(names):
        h = hists.get(n, ())
        local[i, : len(h)] = h
    gathered = _allgather(torch.from_numpy(local).to(device))  # [n_proc, n_spans, cap]
    merged = {}
    for i, n in enumerate(names):
        parts = [gathered[r, i, : int(all_counts[r, i])] for r in range(gathered.shape[0])]
        merged[n] = np.sort(np.concatenate(parts))
    return merged


def _sample_percentile(samples, q: float) -> float:
    """``Telemetry.percentiles``' sorted-sample index rule, so merged
    cross-rank percentiles stay comparable with local ones."""
    n = len(samples)
    if n == 0:
        return 0.0
    return float(samples[min(n - 1, int(q * n))])


def summary_table(telemetry: Telemetry) -> str:
    """Format the end-of-run summary (call on every rank; print on rank 0).

    One process: the local snapshot, and no collective. Several: the raw
    span reservoirs are gathered and p50/p95 recomputed from the merged
    sample (the mean of per-rank medians is not the median, and a
    straggler's tail would vanish into it); counts and sums come from the
    same merged sample, over every span any rank recorded. Every rank must
    call this then, whichever spans it recorded.
    """
    snap = telemetry.snapshot()
    rows = {
        n: (s["count"], s["sum"], s["p50"], s["p95"])
        for n, s in snap["spans"].items()
    }
    n_proc = launch.size()
    if n_proc > 1:
        samples = _allgather_span_samples(telemetry.hists)
        rows = {
            n: (
                float(len(v)),
                float(v.sum()),
                _sample_percentile(v, 0.5),
                _sample_percentile(v, 0.95),
            )
            for n, v in samples.items()
        }
    lines = [
        f"{'span':<40} {'count':>8} {'p50 ms':>10} {'p95 ms':>10} {'total s':>10}"
    ]
    for n in sorted(rows):
        c, tot, p50, p95 = rows[n]
        lines.append(
            f"{n:<40} {int(c):>8} {p50 * 1e3:>10.3f} {p95 * 1e3:>10.3f} "
            f"{tot:>10.2f}"
        )
    for n, v in sorted(snap["counters"].items()):
        lines.append(f"{'counter ' + n:<40} {v:>8g}")
    return "\n".join(lines)
