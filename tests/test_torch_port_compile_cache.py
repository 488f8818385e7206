"""The port's ``compile_cache`` against the JAX package's.

``expected_step_variants`` replays each package's cadence over the same
schedule: the port's count must equal the JAX function's on every
configuration the JAX tests pin (``tests/test_factor_comm.py``,
``test_overlap.py``, ``test_fused_apply.py``, ``test_factor_sharding.py``,
``test_streaming.py``, ``test_rsvd_solver.py``, ``test_planner.py``), and
on a diag warmup with a resume and ``--eigh-chunks 3``. The multi-rank
configurations (a deferred flush exists only over more than one rank)
are built on 2 gloo ranks of ``tests/torch_dist_workers.py``, the JAX
ones on the suite's 8-device CPU mesh: the count depends on whether the
world has more than one rank, not on how many. ``RecompileMonitor``
must give the JAX monitor's counter and gauge values over the same
sequence of cache sizes, and skip a callable with no ``_cache_size``.
"""

import jax
import jax.numpy as jnp
import pytest

import torch_dist_workers as workers
from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu.compile_cache import RecompileMonitor as JMonitor
from kfac_pytorch_tpu.compile_cache import expected_step_variants as jax_variants
from kfac_pytorch_tpu.observability.telemetry import Telemetry as JTelemetry
from kfac_pytorch_tpu.parallel.mesh import data_parallel_mesh
from kfac_pytorch_tpu.planner import Plan as JPlan
from kfac_pytorch_tpu_torch import KFAC
from kfac_pytorch_tpu_torch.compile_cache import RecompileMonitor, expected_step_variants
from kfac_pytorch_tpu_torch.observability.telemetry import Telemetry
from kfac_pytorch_tpu_torch.planner import Plan

# (id, JAX kwargs, port kwargs (None: the JAX ones), plan kwargs (JAX, port)
# or None, autotune candidates, the count the JAX tests pin or None)
ONE_PROCESS = [
    ("default", {}, None, None, 0, 3),
    ("chunks3_freq6", dict(eigh_chunks=3, kfac_update_freq=6), None, None, 0, 8),
    ("chunks4", dict(eigh_chunks=4), None, None, 0, 7),
    ("rsvd", dict(solver="rsvd"), None, None, 0, None),
    ("rsvd_chunks3", dict(solver="rsvd", eigh_chunks=3), None, None, 0, None),
    ("rsvd_warmup5", dict(solver="rsvd", diag_warmup=5), None, None, 0, None),
    ("eigh_warmup5", dict(diag_warmup=5), None, None, 0, None),
    ("streaming_freq3", dict(solver="streaming", fac_update_freq=1, kfac_update_freq=3),
     None, None, 0, None),
    ("warmup_resume_chunks3", dict(diag_blocks=2, diag_warmup=2, eigh_chunks=3,
                                   kfac_update_freq=6), None, None, 0, None),
    ("autotune3", {}, None, None, 3, 9),
    ("plan_chunks3", {}, None, (dict(eigh_chunks=3),) * 2, 0, None),
]

_FUSED = dict(fac_update_freq=1, kfac_update_freq=3, factor_comm_freq=2)
MULTI_RANK = [
    ("deferred", dict(factor_comm_freq=2), None, None, 0, 4),
    ("chunks3_freq6_deferred", dict(eigh_chunks=3, kfac_update_freq=6, factor_comm_freq=2),
     None, None, 0, 10),
    ("overlap", dict(comm_overlap=True), None, None, 0, 3),
    ("overlap_deferred", dict(comm_overlap=True, factor_comm_freq=2), None, None, 0, 4),
    ("mesh_chunks3_freq6", dict(eigh_chunks=3, kfac_update_freq=6), None, None, 0, 8),
    ("staleness2", dict(eigh_chunks=3, kfac_update_freq=6, staleness_budget=2),
     None, None, 0, 12),
    ("overlap_staleness2", dict(comm_overlap=True, eigh_chunks=3, kfac_update_freq=6,
                                staleness_budget=2), None, None, 0, 12),
    ("deferred_staleness2", dict(eigh_chunks=3, kfac_update_freq=6, factor_comm_freq=2,
                                 staleness_budget=2), None, None, 0, 16),
    ("flush_slip_only", dict(factor_comm_freq=2, staleness_budget=2), None, None, 0, 4),
    ("fused_base", _FUSED, None, None, 0, None),
    ("fused_apply_kernel", dict(_FUSED, apply_kernel="pallas"),
     dict(_FUSED, apply_kernel="dense"), None, 0, None),
    ("fused_int8_wire", dict(_FUSED, factor_comm_dtype="int8"), None, None, 0, None),
    ("fused_plan", _FUSED, None, (dict(factor_comm_freq=2),) * 2, 0, None),
    ("fused_plan_int8_kernel", _FUSED, None,
     (dict(factor_comm_freq=2, factor_comm_dtype="int8", apply_kernel="pallas"),
      dict(factor_comm_freq=2, factor_comm_dtype="int8", apply_kernel="dense")), 0, None),
    ("mesh_default", {}, None, None, 0, 3),
    ("owner", dict(factor_sharding="owner"), None, None, 0, 3),
    *[(f"plan_arg_{name}", {}, None, (plan,) * 2, 0, None) for name, plan in (
        ("default", {}), ("chunks3", dict(eigh_chunks=3)), ("deferred", dict(factor_comm_freq=2)),
        ("chunks3_deferred", dict(eigh_chunks=3, factor_comm_freq=2)))],
    *[(f"plan_built_{name}", plan, None, None, 0, None) for name, plan in (
        ("chunks3", dict(eigh_chunks=3)), ("deferred", dict(factor_comm_freq=2)),
        ("chunks3_deferred", dict(eigh_chunks=3, factor_comm_freq=2)))],
]


def _jax_count(jax_kw, plans, autotune, mesh=None):
    kfac = JKFAC(damping=0.01, **jax_kw, **({"mesh": mesh} if mesh is not None else {}))
    return jax_variants(kfac, plan=None if plans is None else JPlan(**plans[0]),
                        autotune_candidates=autotune)


@pytest.mark.parametrize("name,jax_kw,port_kw,plans,autotune,pinned", ONE_PROCESS,
                         ids=[c[0] for c in ONE_PROCESS])
def test_one_process_variants_match_jax(name, jax_kw, port_kw, plans, autotune, pinned):
    want = _jax_count(jax_kw, plans, autotune)
    kfac = KFAC(damping=0.01, device="cpu", **(jax_kw if port_kw is None else port_kw))
    got = expected_step_variants(kfac, plan=None if plans is None else Plan(**plans[1]),
                                 autotune_candidates=autotune)
    assert got == want
    if pinned is not None:
        assert got == pinned


def test_solver_and_no_kfac_counts_match_jax():
    """The solver swaps which variants run, never how many; no K-FAC is one
    variant plus the autotune term."""
    for kw in ({}, dict(eigh_chunks=3), dict(diag_warmup=5)):
        dense = expected_step_variants(KFAC(damping=0.003, device="cpu", **kw))
        assert expected_step_variants(KFAC(damping=0.003, solver="rsvd", device="cpu", **kw)) \
            == dense == jax_variants(JKFAC(damping=0.003, **kw))
    for autotune in (0, 2):
        assert expected_step_variants(None, autotune_candidates=autotune) \
            == jax_variants(None, autotune_candidates=autotune) == 1 + 2 * autotune


@pytest.fixture(scope="module")
def multi_rank_counts(tmp_path_factory):
    configs = [(name, kw if port_kw is None else port_kw, None if plans is None else plans[1],
                autotune) for name, kw, port_kw, plans, autotune, _ in MULTI_RANK]
    results = workers.spawn("compile_cache", 2, tmp_path_factory.mktemp("compile_cache"),
                            configs=configs)
    assert results[0] == results[1]
    return results[0]


@pytest.mark.parametrize("name,jax_kw,port_kw,plans,autotune,pinned", MULTI_RANK,
                         ids=[c[0] for c in MULTI_RANK])
def test_multi_rank_variants_match_jax(multi_rank_counts, name, jax_kw, port_kw, plans,
                                       autotune, pinned):
    want = _jax_count(jax_kw, plans, autotune, mesh=data_parallel_mesh())
    assert multi_rank_counts[name] == want
    if pinned is not None:
        assert want == pinned


def test_multi_rank_levers_do_not_widen_the_budget(multi_rank_counts):
    """The apply kernels, the int8 wire and owner sharding swap what a
    variant computes, not how many there are; a plan budgets what the KFAC
    built with it counts."""
    c = multi_rank_counts
    assert c["fused_apply_kernel"] == c["fused_int8_wire"] == c["fused_base"]
    assert c["fused_plan"] == c["fused_plan_int8_kernel"]
    assert c["owner"] == c["mesh_default"]
    for name in ("chunks3", "deferred", "chunks3_deferred"):
        assert c[f"plan_arg_{name}"] == c[f"plan_built_{name}"]


class _Cached:
    """A compiled callable's stand-in: ``_cache_size`` as given."""

    def __init__(self):
        self.size = 1

    def _cache_size(self):
        return self.size


def test_recompile_monitor_counts_as_jax():
    """The JAX test's sequence: a budget of 1, a retrace, a repeated check,
    a second retrace; the port's monitor over a stand-in whose cache grows
    where the jitted function retraced gives the same values."""
    jtel, tel = JTelemetry(enabled=True), Telemetry(enabled=True)
    jmon, mon = JMonitor(jtel), RecompileMonitor(tel)
    f = jax.jit(lambda x: x * 2.0)
    g = _Cached()
    f(jnp.ones((2,)))
    jmon.watch("f", f, expected_variants=1)
    mon.watch("f", g, expected_variants=1)
    seen = []
    for shape in (None, (3,), None, (4,)):
        if shape is not None:
            f(jnp.ones(shape))
            g.size += 1
        got, want = mon.check(), jmon.check()
        assert got == want
        assert tel.counters.get("compile/retraces") == jtel.counters.get("compile/retraces")
        assert tel.gauges["compile/cache_size/f"] == jtel.gauges["compile/cache_size/f"]
        seen.append((got, tel.counters.get("compile/retraces")))
    assert seen == [({}, None), ({"f": 1}, 1.0), ({"f": 1}, 1.0), ({"f": 2}, 2.0)]


def test_recompile_monitor_skips_callables_without_cache():
    """An eager step, like a function JAX did not jit, is watched by nobody."""
    mon = RecompileMonitor(Telemetry(enabled=True))
    mon.watch("plain", lambda x: x)
    assert mon.check() == {}
    jmon = JMonitor(JTelemetry(enabled=True))
    jmon.watch("plain", lambda x: x)
    assert jmon.check() == {}
