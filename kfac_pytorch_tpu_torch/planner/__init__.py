"""planner/ — cost-model-driven composition of the K-FAC perf levers.

Port of ``kfac_pytorch_tpu/planner/``:

* :mod:`profiles` — the :class:`Plan` record, the lever-composition
  validity matrix (every refusal the levers bring, the table ``KFAC``
  refuses through), and the named profile table;
* :mod:`cost_model` — analytic per-lever cost/benefit from layer shapes,
  the LPT slot-cost tables, the world's shape, and bytes on the wire;
* :mod:`autotune` — optional warmup micro-autotune over 2–3 candidate
  plans;
* :mod:`drift` — plan-vs-measured comparison publishing the
  ``kfac/plan_drift_*`` ratio gauges.

Consumed by ``KFAC(profile=...)`` (preconditioner.py) and the trainers'
``--profile``/``--autotune-steps``. See docs/PLANNER.md.
"""

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.planner.autotune import (
    DEFAULT_AUTOTUNE_STEPS,
    AutotuneReport,
    autotune,
    candidate_plans,
)
from kfac_pytorch_tpu_torch.planner.cost_model import (
    CostReport,
    ModelFacts,
    model_facts,
    plan_wire_bytes,
    resolve_profile,
)
from kfac_pytorch_tpu_torch.planner.drift import (
    DriftReport,
    detect_drift,
    measured_wire_bytes_f32,
)
from kfac_pytorch_tpu_torch.planner.profiles import (
    PROFILES,
    RULES,
    Plan,
    PlanEnv,
    Rule,
    check_plan,
    constructor_refusals,
    fit_plan,
    profile_names,
    violations,
)

__all__ = [
    "AutotuneReport",
    "CostReport",
    "DEFAULT_AUTOTUNE_STEPS",
    "DriftReport",
    "ModelFacts",
    "PROFILES",
    "Plan",
    "PlanEnv",
    "RULES",
    "Rule",
    "autotune",
    "candidate_plans",
    "check_plan",
    "constructor_refusals",
    "detect_drift",
    "fit_plan",
    "log_plan",
    "measured_wire_bytes_f32",
    "model_facts",
    "plan_wire_bytes",
    "profile_names",
    "resolve_profile",
    "violations",
]


def log_plan(plan: Plan, dropped=(), telemetry=None) -> None:
    """Publish a resolved plan as the ``kfac/plan_*`` gauge set: one
    numeric gauge per lever (booleans for the categorical ones), plus
    active and dropped counts. The JAX package's names: a ``*_pallas``
    gauge reads 1 when the port's lever is ``"kernel"``."""
    tel = telemetry if telemetry is not None else get_telemetry()
    tel.set_gauge("kfac/plan_eigh_chunks", float(plan.eigh_chunks))
    tel.set_gauge(
        "kfac/plan_factor_kernel_pallas",
        1.0 if plan.factor_kernel == "kernel" else 0.0,
    )
    tel.set_gauge(
        "kfac/plan_factor_comm_bf16",
        1.0 if plan.factor_comm_dtype == "bf16" else 0.0,
    )
    tel.set_gauge(
        "kfac/plan_factor_comm_int8",
        1.0 if plan.factor_comm_dtype == "int8" else 0.0,
    )
    tel.set_gauge(
        "kfac/plan_apply_kernel_pallas",
        1.0 if plan.apply_kernel == "kernel" else 0.0,
    )
    tel.set_gauge("kfac/plan_factor_comm_freq", float(plan.factor_comm_freq))
    tel.set_gauge(
        "kfac/plan_solver_rsvd", 1.0 if plan.solver == "rsvd" else 0.0
    )
    tel.set_gauge("kfac/plan_solver_rank", float(plan.solver_rank))
    tel.set_gauge(
        "kfac/plan_factor_sharding_owner",
        1.0 if plan.factor_sharding == "owner" else 0.0,
    )
    tel.set_gauge(
        "kfac/plan_levers_active", float(len(plan.non_default_levers()))
    )
    tel.set_gauge("kfac/plan_levers_dropped", float(len(dropped)))
