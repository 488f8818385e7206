"""The port's observability against the JAX package's, on the CPU.

* The registry and its exporters: the same seeded ``inc``/``set_gauge``/
  ``observe`` calls into both registries give equal snapshots and
  percentiles, text-equal Prometheus lines, equal JSONL records and an
  equal one-process summary table; span nesting, the null registry and
  ``configure`` as the JAX unit tests pin them; a tensor gauge is read
  only at snapshot; ``Span.block`` synchronizes a CUDA value's device and
  nothing else.
* The rank-aware summary on two gloo ranks: the merged reservoirs are the
  concatenation of both ranks' ragged samples.
* The flight recorder's schema and round trip, and the cadence's gauges
  and events against the JAX cadence's over one step sequence (deferral,
  chunks with a staleness slip, streaming).
* The metric-name lint: every span, counter, gauge and event name in the
  port's sources is a string literal registered in docs/OBSERVABILITY.md.
* Telemetry, the profiler and ``--profile safe`` on a two-step CIFAR run
  leave the losses bitwise as they were, write registered names only and
  a profiler trace.

Host-only: no JAX train step is jitted here.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import re
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from kfac_pytorch_tpu.observability import export as jexport
from kfac_pytorch_tpu.observability import telemetry as jtelemetry
from kfac_pytorch_tpu.observability import trace as jtrace
from kfac_pytorch_tpu.scheduler import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu.training.metrics import ScalarWriter as JScalarWriter
from kfac_pytorch_tpu_torch.observability import export, telemetry, trace
from kfac_pytorch_tpu_torch.scheduler import EigenRefreshCadence
from kfac_pytorch_tpu_torch.training.metrics import ScalarWriter

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "kfac_pytorch_tpu_torch"
DOC = REPO / "docs" / "OBSERVABILITY.md"

NAMES = ("step/plain", "step/factors", "kfac/damping", "compile/retraces",
         "trace/kfac/eigh", "phase/eigh_ms")


def _registry(marker: str) -> set:
    text = DOC.read_text()
    body = re.search(f"<!-- {marker}:start -->(.*?)<!-- {marker}:end -->", text, re.S).group(1)
    rows = (re.match(r"^\|\s*`([^`]+)`\s*\|", line.strip()) for line in body.splitlines())
    return {m.group(1) for m in rows if m}


@pytest.fixture(autouse=True)
def _quiet_globals():
    """Each test leaves the process-wide registry and recorder off and
    empty, as it found them."""
    yield
    telemetry.configure(enabled=False, block_spans=True).reset()
    trace.configure_trace(None)


def _feed(tel, seed: int) -> None:
    """The same seeded sequence of calls into a registry of either package."""
    r = np.random.RandomState(seed)
    for _ in range(200):
        op, name = r.randint(3), NAMES[r.randint(len(NAMES))]
        value = float(r.choice([r.rand(), r.randint(1, 5), r.rand() * 1e-3]))
        if op == 0:
            tel.inc(name, value)
        elif op == 1:
            tel.set_gauge(name, value)
        else:
            tel.observe(name, value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_exporters_match_jax(seed, tmp_path):
    port, jax_tel = telemetry.Telemetry(enabled=True), jtelemetry.Telemetry(enabled=True)
    _feed(port, seed)
    _feed(jax_tel, seed)
    assert port.snapshot() == jax_tel.snapshot()
    for name in NAMES:
        assert port.percentiles(name, (0.1, 0.5, 0.95)) == jax_tel.percentiles(
            name, (0.1, 0.5, 0.95))
    assert export.prometheus_lines(port.snapshot()) == jexport.prometheus_lines(
        jax_tel.snapshot())
    assert export.summary_table(port) == jexport.summary_table(jax_tel)
    path = export.write_prometheus(str(tmp_path / "port" / "metrics.prom"), port)
    jpath = jexport.write_prometheus(str(tmp_path / "jax" / "metrics.prom"), jax_tel)
    assert open(path).read() == open(jpath).read()
    assert not os.path.exists(path + ".tmp")

    def records(d):
        with open(d / "telemetry.jsonl") as fh:
            return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in fh]

    w = ScalarWriter(str(tmp_path / "pj"), filename="telemetry.jsonl")
    jw = JScalarWriter(str(tmp_path / "jj"), enabled=True, filename="telemetry.jsonl")
    export.flush_jsonl(w, port, step=7)
    jexport.flush_jsonl(jw, jax_tel, step=7)
    w.close()
    jw.close()
    assert records(tmp_path / "pj") == records(tmp_path / "jj") != []


def test_span_nesting_and_counters():
    tel = telemetry.Telemetry(enabled=True)
    with tel.span("step/eigen"):
        with tel.span("trace/kfac/eigh"):
            time.sleep(0.005)
        time.sleep(0.005)
    outer, inner = tel.percentiles("step/eigen")[0], tel.percentiles("trace/kfac/eigh")[0]
    assert outer > inner > 0.0
    assert set(tel.snapshot()["spans"]) == {"step/eigen", "trace/kfac/eigh"}
    tel.inc("compile/retraces")
    tel.inc("compile/retraces", 2)
    tel.set_gauge("kfac/damping", 0.03)
    tel.set_gauge("kfac/damping", 0.01)
    snap = tel.snapshot()
    assert snap["counters"]["compile/retraces"] == 3.0 and snap["gauges"]["kfac/damping"] == 0.01
    assert "counter compile/retraces" in export.summary_table(tel)


def test_disabled_is_null_and_allocation_free():
    tel = telemetry.Telemetry(enabled=False)
    assert tel.span("step/plain") is telemetry._NULL_SPAN
    assert tel.span("step/eigen") is tel.span("step/plain")
    x = torch.ones(3)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with tel.span("step/plain") as sp:
                sp.block(x)
            tel.inc("compile/retraces")
            tel.set_gauge("kfac/damping", 1.0)
            tel.observe("step/plain", 0.5)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename == telemetry.__file__)
    assert grown <= 0
    assert tel.counters == {} and tel.gauges == {} and tel.hists == {}
    assert tel.snapshot() == {"counters": {}, "gauges": {}, "spans": {}}


def test_configure_and_the_block_gate(monkeypatch):
    g = telemetry.get_telemetry()
    assert telemetry.configure(enabled=True) is g and g.enabled
    assert telemetry.configure(enabled=True, block_spans=False) is g and g.block_spans is False
    telemetry.configure(enabled=True)  # None leaves the gate as it is
    assert g.block_spans is False
    telemetry.configure(enabled=False, block_spans=True)
    assert g.span("step/plain") is telemetry._NULL_SPAN
    # block() synchronizes the device of the first CUDA tensor, only with
    # the gate on; a CPU value is never synchronized
    assert telemetry._cuda_device({"a": [torch.ones(1), (torch.zeros(2),)]}) is None
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    tel = telemetry.Telemetry(enabled=True)
    with tel.span("step/plain") as sp:
        sp.block({"loss": torch.ones(())})
    assert calls == [] and tel.percentiles("step/plain")[0] >= 0.0
    monkeypatch.setattr(telemetry, "_cuda_device", lambda obj: torch.device("cuda", 0))
    with tel.span("step/plain") as sp:
        sp.block({"loss": torch.ones(())})
    assert calls == [torch.device("cuda", 0)]
    tel.block_spans = False
    with tel.span("step/plain") as sp:
        sp.block({"loss": torch.ones(())})
    assert len(calls) == 1 and len(tel.hists["step/plain"]) == 3


def test_tensor_gauge_is_read_at_snapshot():
    tel = telemetry.Telemetry(enabled=True)
    norm = torch.tensor(2.5)
    tel.set_gauge("kfac/wire_quant_error_norm", norm)
    assert tel.gauges["kfac/wire_quant_error_norm"] is not None
    assert isinstance(tel.gauges["kfac/wire_quant_error_norm"], torch.Tensor)
    assert tel.snapshot()["gauges"]["kfac/wire_quant_error_norm"] == 2.5


def test_rank_aware_summary_merges_ragged_reservoirs(tmp_path):
    """Two gloo ranks: ragged counts of the same spans, then span sets
    that differ in content but not in size, then a rank with no span."""
    r = np.random.RandomState(3)

    def draw(spec):
        return {n: [float(v) for v in r.rand(k)] for n, k in spec}

    cases = [
        [draw((("step/plain", 5 + 4 * rank), ("trace/kfac/eigh", 3 - rank))) for rank in range(2)],
        [draw((("step/plain", 4), ("trace/kfac/apply_kernel", 3))),
         draw((("step/plain", 6), ("trace/eigh/compute", 2)))],
        [draw((("step/factors", 3), ("trace/eigh/compute", 5))), {}],
    ]
    out = workers.spawn("telemetry", 2, tmp_path, cases=cases)
    for i, samples in enumerate(cases):
        one = telemetry.Telemetry(enabled=True)
        for rank_samples in samples:
            for name, values in rank_samples.items():
                for v in values:
                    one.observe(name, v)
        names = set(samples[0]) | set(samples[1])
        for res in out:
            got = res[i]
            assert set(got["merged"]) == names
            for name in names:
                assert got["merged"][name] == sorted(samples[0].get(name, []) + samples[1].get(name, []))
            assert got["table"] == export.summary_table(one)


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_flight_recorder_schema_and_round_trip(tmp_path):
    tr = trace.get_trace()
    assert tr.enabled is False and tr.path is None
    tr.event("anything", basis_version=1)
    assert trace.get_trace() is tr
    path = str(tmp_path / "trace.jsonl")
    tr = trace.configure_trace(path, host=3)
    assert tr is trace.get_trace() and tr.enabled and tr.path == path
    tr.event("snapshot_begin", snapshot_id="v-0004", step=4, sync=True)
    tr.event("basis_install", basis_version=np.int64(7), slip=torch.tensor(1))
    trace.configure_trace(None)
    assert trace.get_trace().enabled is False
    evs = _events(path)
    assert [e["kind"] for e in evs] == ["snapshot_begin", "basis_install"]
    for e in evs:
        assert e["host"] == 3 and e["pid"] == os.getpid()
        assert isinstance(e["ts_ns"], int) and e["ts_ns"] > 0
    assert evs[0]["snapshot_id"] == "v-0004" and evs[0]["sync"] is True
    assert evs[1]["basis_version"] == 7 and evs[1]["slip"] == 1
    tr.event("basis_install", basis_version=8)  # after close: dropped
    assert len(_events(path)) == 2
    # the host id defaults to the process's rank (0 outside a group)
    assert trace.TraceRecorder(str(tmp_path / "t2.jsonl")).host == 0
    # concurrent writers never tear a line
    rec = trace.TraceRecorder(str(tmp_path / "t3.jsonl"), host=0)
    threads = [threading.Thread(target=lambda i=i: [rec.event("heartbeat", step=i * 100 + j)
                                                    for j in range(50)]) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    rec.close()
    assert {e["step"] for e in _events(tmp_path / "t3.jsonl")} == {
        i * 100 + j for i in range(4) for j in range(50)}


class _Comm:
    """The factor comm plane's face the cadences read: deferral every
    ``comm_freq`` capture steps."""

    defer = True
    overlap_mode = 0

    def __init__(self, comm_freq):
        self.comm_freq = comm_freq

    def flush_due(self, step, fac_update_freq):
        return step % fac_update_freq == 0 and (step // fac_update_freq) % self.comm_freq == 0


def _fake_kfac(solver, chunks, budget, pressure):
    hp = types.SimpleNamespace(fac_update_freq=1, kfac_update_freq=5, damping=0.003)
    drift = iter([0.01, 0.2, 0.03, 0.5] * 4)
    return types.SimpleNamespace(
        hparams=hp, diag_warmup=0, eigh_chunks=chunks, staleness_budget=budget,
        staleness_signal=(lambda: next(pressure)) if budget else None, solver=solver,
        solver_rank=16, stream_drift_threshold=0.1,
        stream_drift_signal=(lambda: next(drift)) if solver == "streaming" else None,
        factor_comm=_Comm(2), service_devices=0)


@pytest.mark.parametrize("solver,chunks,budget", [("eigh", 3, 2), ("streaming", 1, 0),
                                                  ("eigh", 1, 1)])
def test_cadence_gauges_and_events_match_jax(solver, chunks, budget, tmp_path):
    """The two cadences over 16 steps with deferral (a flush every 2nd
    capture step), under a pressure pattern that slips swaps and flushes:
    equal flags, equal gauges after every step and the same events, bar
    their timestamps, host and pid."""
    pattern = [2.0, 2.0, 0.0, 2.0, 0.0, 0.0, 2.0, 2.0] * 4
    runs = []
    for cadence_cls, tel_mod, trace_mod in (
            (EigenRefreshCadence, telemetry, trace),
            (JCadence, jtelemetry, jtrace)):
        tel = tel_mod.configure(enabled=True)
        tel.reset()
        path = tmp_path / f"{cadence_cls.__module__}.jsonl"
        trace_mod.configure_trace(str(path), host=0)
        cadence = cadence_cls(_fake_kfac(solver, chunks, budget, iter(pattern)))
        steps = []
        for step in range(16):
            flags = cadence.flags_for_step(step, 0)
            steps.append((flags, dict(tel.gauges)))
        trace_mod.configure_trace(None)
        tel_mod.configure(enabled=False).reset()
        runs.append((steps, [{k: v for k, v in e.items() if k not in ("ts_ns", "host", "pid")}
                             for e in _events(path)]))
    assert runs[0] == runs[1]
    assert runs[0][1], "the sequence produced no cadence event"


def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            yield node


def test_metric_and_event_names_are_registered_literals():
    """The port's analog of scripts/check_metric_names.py and
    check_trace_events.py: every span/inc/set_gauge/observe name and every
    event kind in the port's sources is a string literal in the docs'
    registries (the registries' own definitions excepted). A gauge family
    the registry marks with ``<...>`` (``compile/cache_size/<fn>``) is the
    one f-string allowed: its literal head then its one placeholder."""
    metrics, events = _registry("metric-registry"), _registry("trace-event-registry")
    families = {re.sub(r"<[^>]*>$", "", n): n for n in metrics if re.search(r"<[^>]*>$", n)}
    emitted, kinds = set(), set()
    defining = {PORT / "observability" / "telemetry.py", PORT / "observability" / "trace.py"}
    for path in sorted(PORT.rglob("*.py")):
        if path in defining:
            continue
        for call in _calls(ast.parse(path.read_text())):
            attr = call.func.attr
            if attr in ("span", "inc", "set_gauge", "observe"):
                args = call.args
                if attr == "span" and not args:
                    continue
                if (attr == "set_gauge" and args and isinstance(args[0], ast.JoinedStr)
                        and len(args[0].values) == 2
                        and isinstance(args[0].values[0], ast.Constant)
                        and args[0].values[0].value in families):
                    emitted.add(families[args[0].values[0].value])
                    continue
                assert args and isinstance(args[0], ast.Constant) and isinstance(
                    args[0].value, str), f"{path}:{call.lineno}: {attr}() needs a literal name"
                emitted.add(args[0].value)
            elif attr == "event" and isinstance(call.func.value, ast.Call) and getattr(
                    call.func.value.func, "id", None) == "get_trace":
                assert isinstance(call.args[0], ast.Constant), f"{path}:{call.lineno}"
                kinds.add(call.args[0].value)
    assert emitted and kinds
    assert emitted <= metrics, sorted(emitted - metrics)
    assert kinds <= events, sorted(kinds - events)


CIFAR = ["--synthetic", "--model", "resnet20", "--batch-size", "2", "--epochs", "1",
         "--steps-per-epoch", "2", "--kfac-update-freq", "2", "--device", "cpu", "--num-workers", "0"]


def test_telemetry_profiler_and_safe_profile_leave_losses_bitwise(tmp_path):
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training import profiling

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = trainer.main(CIFAR)
        on = trainer.main([*CIFAR, "--telemetry-dir", str(tmp_path / "tel"), "--log-dir",
                           str(tmp_path / "log"), "--profile-epoch", "0", "--profile", "safe"])
    finally:
        torch.set_num_threads(threads)
    assert on["loss"] == off["loss"] and len(on["loss"]) == 2
    assert on["plan"]["non_default_levers"] == [] and "telemetry" not in off
    assert {"step/eigen", "step/factors", "trace/kfac/factor_kernel"} <= set(
        on["telemetry"]["spans"])
    metrics = _registry("metric-registry")
    with open(tmp_path / "tel" / "telemetry.jsonl") as fh:
        tags = [json.loads(line)["tag"] for line in fh]
    names = {t.split("/", 1)[1].rsplit("/", 1)[0] if t.startswith("span/") else t.split("/", 1)[1]
             for t in tags}
    assert names and names <= metrics, sorted(names - metrics)
    prom = {export.prom_name(n) for n in metrics}
    families = [line.split()[2] for line in open(tmp_path / "tel" / "metrics.prom")
                if line.startswith("# TYPE")]
    assert families and all(re.sub("_seconds$", "", f) in prom for f in families)
    assert os.path.getsize(tmp_path / "log" / profiling.TRACE_FILE) > 0
