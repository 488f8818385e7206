"""The port's planner against the JAX package's, on the CPU.

* The six golden plans of ``scripts/plan_snapshots/``: the port resolves
  each fixture's production plan and cost report exactly (``"pallas"``
  read as ``"kernel"``, ``on_tpu`` as ``on_cuda``); the memory and safe
  profiles equal the JAX package's on the same fixtures.
* The validity matrix: ``violations``, ``check_plan`` and ``fit_plan``
  equal the JAX package's over its lever × environment grid, but for the
  one rule the port enforces in the constructor where the JAX package
  degrades (``apply_pallas_vs_inverse``).
* The constructor refuses exactly the constructor rows ``RULES`` trips,
  with the JAX constructor's messages where it refuses too; the rules the
  port carried early (the seq-axis and shard-lens rows) keep their words.
* ``KFAC(profile=...)``: only default levers are filled, a shape dict and
  a live model are accepted, ``profile=None`` and ``"safe"`` are inert.
* ``autotune``, ``detect_drift`` and ``log_plan`` as the JAX package's.

Host-only: no JAX train step is jitted here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn as nn

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import planner as jplanner
from kfac_pytorch_tpu.observability.telemetry import Telemetry as JTelemetry
from kfac_pytorch_tpu_torch import KFAC, capture, planner
from kfac_pytorch_tpu_torch.models.layers import KFACDense
from kfac_pytorch_tpu_torch.observability.telemetry import Telemetry
from kfac_pytorch_tpu_torch.planner.profiles import REFUSAL_RULES

REPO = pathlib.Path(__file__).resolve().parent.parent
SNAPSHOTS = REPO / "scripts" / "plan_snapshots"
APPLY_RULE = "apply_pallas_vs_inverse"


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "check_plan_snapshot", REPO / "scripts" / "check_plan_snapshot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FIXTURES


FIXTURES = _fixtures()


def _to_port(d):
    """A JAX plan dict in the port's kernel vocabulary."""
    return {k: "kernel" if v == "pallas" else v for k, v in d.items()}


def _facts_env(pkg, name, on_device):
    fx = FIXTURES[name]
    facts = pkg.ModelFacts(
        shapes={k: tuple(v) for k, v in fx["shapes"].items()},
        diag_a=frozenset(fx["diag_a"]), has_conv=fx["has_conv"],
        shard_counts={k: (f, int(c)) for k, (f, c) in fx.get("shard_counts", {}).items()})
    env = dict(
        world=fx["world"], data_world=fx.get("data_world", 0),
        mesh_axes=tuple(fx["mesh_axes"]), has_diag_a_layers=facts.has_diag_a,
        has_conv_layers=facts.has_conv, has_shard_lens_layers=facts.has_shard_lens,
        has_moe_layers=facts.has_moe, fac_update_freq=fx.get("fac_update_freq", 10),
        kfac_update_freq=fx.get("kfac_update_freq", 100),
        service_devices=fx.get("service_devices", 0))
    env["on_cuda" if pkg is planner else "on_tpu"] = on_device
    return facts, pkg.PlanEnv(**env)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_production_plans_match_the_snapshots(name):
    snap = json.loads((SNAPSHOTS / f"{name}.json").read_text())
    facts, env = _facts_env(planner, name, True)
    plan, report, dropped = planner.resolve_profile("production", facts, env)
    assert plan.to_dict() == _to_port(snap["plan"])
    assert report.to_dict() == snap["cost"]
    assert list(dropped) == snap["dropped_rules"]
    assert list(plan.non_default_levers()) == snap["non_default_levers"]


@pytest.mark.parametrize("profile", ["memory", "safe", "production"])
@pytest.mark.parametrize("on_device", [True, False])
def test_profiles_match_jax(profile, on_device):
    for name in sorted(FIXTURES):
        facts, env = _facts_env(planner, name, on_device)
        jfacts, jenv = _facts_env(jplanner, name, on_device)
        plan, report, dropped = planner.resolve_profile(profile, facts, env)
        jplan, jreport, jdropped = jplanner.resolve_profile(profile, jfacts, jenv)
        assert plan.to_dict() == _to_port(jplan.to_dict()), name
        assert report.to_dict() == jreport.to_dict() and dropped == jdropped, name
        # without shapes only the world decides
        plan, report, dropped = planner.resolve_profile(profile, None, env)
        jplan, _, jdropped = jplanner.resolve_profile(profile, None, jenv)
        assert plan.to_dict() == _to_port(jplan.to_dict()) and report is None
        assert dropped == jdropped


# the JAX package's pairwise grid (tests/test_planner.py), levers in the
# port's vocabulary
LEVERS = {
    "chunks": dict(eigh_chunks=2),
    "kernel": dict(factor_kernel="kernel"),
    "comm_dtype": dict(factor_comm_dtype="bf16"),
    "comm_freq": dict(factor_comm_freq=2),
    "rsvd": dict(solver="rsvd"),
    "owner": dict(factor_sharding="owner"),
    "owner+chunks": dict(factor_sharding="owner", eigh_chunks=2),
    "rsvd+comm": dict(solver="rsvd", factor_comm_dtype="bf16"),
    "overlap": dict(comm_overlap=True),
    "overlap+staleness": dict(comm_overlap=True, staleness_budget=1, eigh_chunks=2),
    "staleness_bare": dict(staleness_budget=1),
    "streaming": dict(solver="streaming"),
    "streaming+chunks": dict(solver="streaming", eigh_chunks=2),
    "streaming+staleness": dict(solver="streaming", staleness_budget=1, factor_comm_freq=2),
    "service": dict(service_devices=1),
    "service+staleness": dict(service_devices=1, staleness_budget=1),
    "service+streaming": dict(service_devices=1, solver="streaming"),
    "service+chunks": dict(service_devices=1, eigh_chunks=2),
    "service+owner": dict(service_devices=1, factor_sharding="owner"),
    "wire8": dict(factor_comm_dtype="int8", factor_comm_freq=2),
    "wire8_bare": dict(factor_comm_dtype="int8"),
    "wire8+owner": dict(factor_comm_dtype="int8", factor_comm_freq=2, factor_sharding="owner"),
    "apply_kernel": dict(apply_kernel="kernel"),
}

# environment features: (PlanEnv kwargs, KFAC kwargs of a one-process port
# preconditioner, or None where the environment needs several ranks)
ENVS = {
    "default_dp8": (dict(), None),
    "inverse": (dict(precond_method="inverse"), dict(precond_method="inverse")),
    "diag_blocks": (dict(diag_blocks=2), dict(diag_blocks=2)),
    "dist_precond": (dict(distribute_precondition=True), dict(distribute_precondition=True)),
    "diagnostics": (dict(track_diagnostics=True), dict(track_diagnostics=True)),
    "multi_axis": (dict(axes=("data", "seq")), None),
    "single_device": (dict(world=1), dict()),
    "shard_lens": (dict(has_shard_lens_layers=True),
                   dict(layers=["block_0.ff1#c2", "block_0.ff2#r2"])),
    "moe": (dict(has_moe_layers=True), dict(layers=["block_0.moe#e4"])),
    "shard_lens_inverse": (dict(has_shard_lens_layers=True, precond_method="inverse"),
                           dict(layers=["block_0.ff1#c2"], precond_method="inverse")),
    "shard_lens_diag_blocks": (dict(has_shard_lens_layers=True, diag_blocks=2),
                               dict(layers=["block_0.ff1#c2"], diag_blocks=2)),
}


def _env(pkg, env_kw, world=8):
    kw = dict(env_kw)
    axes = kw.pop("axes", ("data",))
    world = kw.pop("world", world)
    return pkg.PlanEnv(world=world, mesh_axes=axes if world > 1 else (), **kw)


def _jax_plan(levers):
    return jplanner.Plan(**{k: "pallas" if v == "kernel" else v for k, v in levers.items()})


@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_validity_matrix_matches_jax(env_name):
    env_kw = ENVS[env_name][0]
    env, jenv = _env(planner, env_kw), _env(jplanner, env_kw)
    for lever, levers in LEVERS.items():
        plan, jplan = planner.Plan(**levers), _jax_plan(levers)
        apply_refused = plan.apply_kernel == "kernel" and env.precond_method == "inverse"
        names = [r.name for r in planner.violations(plan, env)]
        jnames = [r.name for r in jplanner.violations(jplan, jenv)]
        assert [n for n in names if n != APPLY_RULE] == jnames, lever
        assert (APPLY_RULE in names) == apply_refused, lever
        assert ([r.name for r in planner.violations(plan, env, include_degrades=True)]
                == [r.name for r in jplanner.violations(jplan, jenv, include_degrades=True)])
        fitted, dropped = planner.fit_plan(plan, env)
        jfitted, jdropped = jplanner.fit_plan(jplan, jenv)
        assert fitted.to_dict() == _to_port(jfitted.to_dict()) and dropped == jdropped, lever
        if names:
            with pytest.raises(ValueError) as got:
                planner.check_plan(plan, env)
            if not apply_refused:
                with pytest.raises(ValueError) as want:
                    jplanner.check_plan(jplan, jenv)
                assert str(got.value) == str(want.value).replace("'pallas'", "'kernel'")
        else:
            planner.check_plan(plan, env)


def test_the_grid_trips_every_refusal_rule():
    tripped = {r.name for levers in LEVERS.values() for env_kw, _ in ENVS.values()
               for r in planner.violations(planner.Plan(**levers), _env(planner, env_kw))}
    assert {r.name for r in REFUSAL_RULES} <= tripped
    # the rule rows are the JAX table's, in its order, each with its reason
    assert [r.name for r in planner.RULES] == [r.name for r in jplanner.RULES]
    for rule, jrule in zip(planner.RULES, jplanner.RULES):
        if rule.name != APPLY_RULE:
            assert (rule.drop, rule.message) == (jrule.drop, jrule.message)


@pytest.mark.parametrize("env_name", sorted(n for n, (_, kw) in ENVS.items() if kw is not None))
def test_constructor_refuses_exactly_the_table(env_name, capsys):
    """Every lever of the grid through the port's constructor on one
    process: a ValueError with the text of the first constructor row the
    table trips (the JAX constructor's, word for word, where it refuses
    that lever alone), else ``"kernel"`` refused off CUDA, else a
    preconditioner (the curvature service's plan too, since item 9d)."""
    env_kw, kfac_kw = ENVS[env_name]
    env = _env(planner, {**env_kw, "world": 1})
    for lever, levers in LEVERS.items():
        plan = planner.Plan(**levers)
        bad = planner.constructor_refusals(plan, env)
        if bad:
            with pytest.raises(ValueError) as got:
                KFAC(damping=0.01, device="cpu", **kfac_kw, **levers)
            assert str(got.value) == bad[0].refusal_text(plan, env), lever
            jkw = dict(kfac_kw)
            if "layers" in jkw:
                jkw["layers"] = [n.replace(".", "/") for n in jkw["layers"]]
            if len(bad) == 1 and bad[0].refusal is not None and "kernel" not in levers.values():
                with pytest.raises(ValueError) as want:
                    JKFAC(damping=0.01, **jkw, **levers)
                assert str(got.value) == str(want.value), lever
        elif plan.service_devices:
            kfac = KFAC(damping=0.01, device="cpu", **kfac_kw, **levers)
            assert kfac.service_devices == plan.service_devices, lever
        elif "kernel" in levers.values():
            with pytest.raises(ValueError, match="CUDA"):
                KFAC(damping=0.01, device="cpu", **kfac_kw, **levers)
        else:
            KFAC(damping=0.01, device="cpu", **kfac_kw, **levers)
    capsys.readouterr()


def test_rules_carried_early_keep_their_words():
    """The seq-axis rows raise the JAX planner's reason with the rule's
    name (as the port raised them before the table); the shard-lens rows the JAX
    constructor's words, naming the model's kind."""
    env = planner.PlanEnv(world=2, mesh_axes=("data", "seq"))
    jrules = {r.name: r for r in jplanner.RULES}
    for name in ("owner_vs_multi_axis_mesh", "comm_vs_multi_axis_mesh",
                 "overlap_vs_multi_axis_mesh"):
        rule = next(r for r in planner.RULES if r.name == name)
        assert rule.enforced_by == "constructor" and rule.refusal is None
        assert rule.refusal_text(planner.Plan(), env) == (
            f"{jrules[name].message} (planner rule {name})")
    lens = planner.PlanEnv(has_shard_lens_layers=True, precond_method="inverse")
    rule = next(r for r in planner.RULES if r.name == "shard_lens_vs_inverse")
    assert rule.refusal_text(planner.Plan(), lens).startswith(
        "shard-lens layers precondition per shard block")
    moe = planner.PlanEnv(has_moe_layers=True)
    rule = next(r for r in planner.RULES if r.name == "moe_vs_owner_sharding")
    assert rule.refusal_text(planner.Plan(), moe).startswith("MoE expert banks pin each")


BIG = planner.ModelFacts(
    shapes={**{f"mid{i}": (256, 2304) for i in range(6)},
            **{f"deep{i}": (512, 4608) for i in range(3)}, "fc": (1000, 2049)},
    has_conv=True)


def _mlp():
    return nn.Sequential(nn.Flatten(), KFACDense(12, 16), nn.ReLU(), KFACDense(16, 10))


def test_profile_fills_only_default_levers():
    k = KFAC(damping=0.01, device="cpu", profile="production", profile_shapes=BIG)
    assert k.solver == "streaming" and k.plan.solver == "streaming"
    k2 = KFAC(damping=0.01, device="cpu", profile="production", profile_shapes=BIG,
              solver_rank=64)
    assert k2.solver_rank == 64 and k2.plan.solver_rank == 128
    k3 = KFAC(damping=0.01, device="cpu", profile="production",
              profile_shapes={f"l{i}": (512, 4608) for i in range(6)})
    assert k3.solver == "streaming"
    assert k3.plan_env.world == 1 and not k3.plan_env.on_cuda and k3.plan_report is not None


def test_profile_accepts_a_live_model():
    model = _mlp()
    layers = capture.discover_layers(model)
    facts = planner.model_facts(model, layers=layers)
    state = KFAC(damping=0.01, device="cpu").init(model)
    assert facts.shapes == {n: (int(f["G"].shape[0]), int(f["A"].shape[0]))
                            for n, f in state["factors"].items()}
    assert not facts.has_conv and not facts.has_diag_a
    k = KFAC(layers=layers, damping=0.01, device="cpu", profile="production",
             profile_shapes=model)
    k2 = KFAC(layers=layers, damping=0.01, device="cpu", profile="production",
              profile_shapes=facts)
    assert k.plan is not None and k.plan == k2.plan


def test_explicit_and_unknown_profiles():
    with pytest.raises(ValueError, match="rsvd_vs_diag_blocks"):
        KFAC(damping=0.01, device="cpu", diag_blocks=2, profile=planner.Plan(solver="rsvd"))
    k = KFAC(damping=0.01, device="cpu", profile=planner.Plan(solver="rsvd", solver_rank=96))
    assert k.solver == "rsvd" and k.solver_rank == 96 and k.plan.solver_rank == 96
    with pytest.raises(ValueError, match="unknown profile"):
        KFAC(damping=0.01, device="cpu", profile="turbo")
    assert KFAC(damping=0.01, device="cpu").plan is None


def test_profile_none_and_safe_are_inert():
    torch.manual_seed(0)
    model = _mlp()
    x, y = torch.randn(6, 3, 4), torch.randint(0, 10, (6,))
    outs = []
    for kw in ({}, {"profile": None}, {"profile": "safe", "profile_shapes": model}):
        kfac = KFAC(damping=0.01, device="cpu", **kw)
        cap = capture.Capture(model, capture.discover_layers(model))
        model.zero_grad()
        with cap.capturing("dense"):
            nn.functional.cross_entropy(model(x), y).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        new, _ = kfac.update(grads, kfac.init(model), a_contribs=cap.a_contribs,
                             g_factor_stats=cap.g_factor_stats, lr=0.1,
                             update_factors=True, update_eigen=True)
        cap.remove()
        outs.append(new)
    for other in outs[1:]:
        assert all(torch.equal(outs[0][n], other[n]) for n in outs[0])


def test_autotune_deterministic_under_fixed_timings():
    env = planner.PlanEnv(world=8, mesh_axes=("data",), on_cuda=True)
    plan, _, _ = planner.resolve_profile("production", BIG, env)
    cands = planner.candidate_plans(plan, env)
    assert 2 <= len(cands) <= 3 and cands[0] == plan and cands[-1] == planner.Plan()
    jenv = jplanner.PlanEnv(world=8, mesh_axes=("data",), on_tpu=True)
    jplan, _, _ = jplanner.resolve_profile("production", jplanner.ModelFacts(
        shapes=BIG.shapes, has_conv=True), jenv)
    assert [c.to_dict() for c in cands] == [
        _to_port(c.to_dict()) for c in jplanner.candidate_plans(jplan, jenv)]
    timings = {c: 1.0 + 0.1 * i for i, c in enumerate(cands)}
    tel = Telemetry(enabled=True)
    reports = [planner.autotune(cands, lambda p, s: timings[p], steps=2, telemetry=tel)
               for _ in range(3)]
    assert all(r.winner_index == 0 and r.winner == plan for r in reports)
    assert tel.gauges["kfac/autotune_winner"] == 0.0
    assert planner.autotune(cands, lambda p, s: 1.0, steps=2, telemetry=tel).winner_index == 0
    flipped = planner.autotune(cands, lambda p, s: 0.5 if p == planner.Plan() else 1.0,
                               steps=2, telemetry=tel)
    assert flipped.winner == planner.Plan()
    assert planner.candidate_plans(planner.Plan(), planner.PlanEnv()) == [planner.Plan()]


def test_drift_ratios_exact_on_cpu():
    """The JAX test's inputs (dense layers 8 → 6 → 4): the measured wire
    bytes run the comm plane's bucketing over the live state, so the ratio
    is exact; the refresh self-calibrates; an external calibration and the
    owner layout give the JAX package's ratios."""
    model = nn.Sequential(KFACDense(8, 6), nn.ReLU(), KFACDense(6, 4))
    facts = planner.model_facts(model)
    state = KFAC(damping=0.01, device="cpu").init(model)
    tel = Telemetry(enabled=True)
    report = planner.detect_drift(facts, planner.Plan(),
                                  measured_wire_bytes_f32=planner.measured_wire_bytes_f32(state),
                                  measured_refresh_ms=7.5, telemetry=tel)
    assert report.ratios == {"wire_bytes": 1.0, "refresh_rate": 1.0} and report.self_calibrated
    assert tel.gauges["kfac/plan_drift_wire_bytes"] == 1.0
    jfacts = jplanner.ModelFacts(shapes=facts.shapes)
    jtel = JTelemetry(enabled=True)
    jreport = jplanner.detect_drift(jfacts, jplanner.Plan(), measured_wire_bytes_f32=int(
        report.measured["wire_bytes_f32"]), measured_refresh_ms=7.5, telemetry=jtel)
    assert report.to_dict() == jreport.to_dict()
    assert json.loads(json.dumps(report.to_dict())) == report.to_dict()
    plan = planner.Plan(factor_sharding="owner")
    calib = planner.cost_model.refresh_cost(facts, plan) / 5.0
    kw = dict(measured_refresh_ms=10.0, calibration_macs_per_ms=calib,
              measured_state_bytes_local=1000, factor_world=2)
    report = planner.detect_drift(facts, plan, telemetry=tel, **kw)
    jreport = jplanner.detect_drift(jfacts, jplanner.Plan(factor_sharding="owner"),
                                    telemetry=jtel, **kw)
    assert report.to_dict() == jreport.to_dict() and report.ratios["refresh_rate"] == 2.0
    assert tel.gauges == jtel.gauges


def test_log_plan_and_plan_records_match_jax():
    plan = planner.Plan(eigh_chunks=4, factor_kernel="kernel", apply_kernel="kernel",
                        solver="rsvd", factor_comm_dtype="int8", factor_comm_freq=2)
    jplan = jplanner.Plan(**{k: "pallas" if v == "kernel" else v
                             for k, v in plan.to_dict().items()})
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    planner.log_plan(plan, ("owner_vs_single_device",), telemetry=tel)
    jplanner.log_plan(jplan, ("owner_vs_single_device",), telemetry=jtel)
    assert tel.gauges == jtel.gauges
    assert plan.describe() == jplan.describe().replace("pallas", "kernel")
    state = plan.to_state()
    assert {k: int(v) for k, v in state.items()} == {k: int(v) for k, v in jplan.to_state().items()}
    assert planner.Plan.from_state(state) == plan
    assert planner.Plan.from_dict(plan.to_dict()) == plan
    with pytest.raises(ValueError, match="unknown Plan fields"):
        planner.Plan.from_dict({"warp_speed": 9})
    assert dataclasses.replace(plan, solver="eigh").non_default_levers() == tuple(
        f for f in jplan.non_default_levers() if f != "solver")
    assert np.asarray(state["factor_kernel"]).item() == 1
