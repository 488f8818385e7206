"""Plan-vs-measured drift detector: does the run match the cost model?

Port of ``kfac_pytorch_tpu/planner/drift.py``. The planner resolves its levers from analytic costs (``cost_model``):
wire bytes per factor exchange, refresh MACs, owner-sharded state bytes.
Nothing ever checked those predictions against what the run actually
measured — a cost-model bug (or a runtime regression) silently produces
plans reasoned from wrong numbers. :func:`detect_drift` closes the loop
after a run: it recomputes the predictions from the same
``ModelFacts``/``Plan`` and divides the measured values by them,
publishing the ratios as ``kfac/plan_drift_*`` gauges — 1.0 means the
model was exact, anything far from it flags the bench round itself.

Ratio semantics: ``measured / predicted`` — > 1 means the run was more
expensive than the model believed.

The refresh-rate check needs a MACs→ms conversion. When the caller has a
calibration (e.g. bench derives dense-MACs-per-ms from its f32 arm's
measured eigh phase), the ratio is a real signal; without one the
detector *self-calibrates* on the measured value, the ratio is exactly
1.0 by construction, and ``self_calibrated`` marks the report as a
schema/plumbing check rather than a perf claim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.parallel.assignment import (
    plan_factor_buckets,
    plan_factor_shards,
    shard_plan_bytes,
)
from kfac_pytorch_tpu_torch.planner.cost_model import (
    ModelFacts,
    _rank_fn_for,
    refresh_cost,
    wire_bytes_f32,
)
from kfac_pytorch_tpu_torch.planner.profiles import Plan


def measured_wire_bytes_f32(kfac_state: Dict[str, Any]) -> int:
    """f32-equivalent wire bytes of one exchange of a live state's factors.

    Runs the comm plane's own bucketing over the actual factor-leaf
    shapes in ``state["factors"]`` (the port's replicated layout; an
    owner-sharded state keeps scalar placeholders there and is measured
    through ``kfac/factor_shard_bytes_local`` instead) — the same primitive the predicted
    side uses on ``ModelFacts``-derived shapes, so when the facts match
    the live model the two agree bit-for-bit. Deliberately WIRE-DTYPE
    INDEPENDENT: the live ``kfac/factor_wire_bytes`` gauge reports the
    compressed payload (bf16 halves it; the int8 wire pays 1 byte per
    element + 4 per block scale, ``comm.quant_wire_bytes``), but drift
    compares shape-level predictions, so both sides normalize to the f32
    element count and ``kfac/plan_drift_wire_bytes`` stays 1.0 whatever
    dtype the plan engaged.
    """
    leaf_shapes = []
    for name in sorted(kfac_state["factors"]):
        sub = kfac_state["factors"][name]
        for key in sorted(sub):
            leaf_shapes.append(tuple(int(d) for d in sub[key].shape))
    buckets = plan_factor_buckets(leaf_shapes)
    return sum(b.size for b in buckets) * 4


@dataclasses.dataclass
class DriftReport:
    """Predicted/measured pairs and their ratios (measured / predicted)."""

    predicted: Dict[str, float]
    measured: Dict[str, float]
    ratios: Dict[str, float]
    self_calibrated: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def detect_drift(
    facts: ModelFacts,
    plan: Plan,
    *,
    measured_wire_bytes_f32: Optional[int] = None,
    measured_refresh_ms: Optional[float] = None,
    calibration_macs_per_ms: Optional[float] = None,
    measured_state_bytes_local: Optional[int] = None,
    factor_world: int = 1,
    telemetry: Any = None,
) -> DriftReport:
    """Compare the cost model's predictions against measured gauges.

    Every measured input is optional — only the checks whose measurement
    arrived are computed and gauged. Inputs map to the existing telemetry
    vocabulary: ``measured_wire_bytes_f32`` from ``kfac/factor_wire_bytes``
    (normalized to f32 if the wire ran bf16), ``measured_refresh_ms`` from
    ``kfac/service_refresh_ms`` or the bench eigh-phase delta,
    ``measured_state_bytes_local`` from ``kfac/factor_shard_bytes_local``.
    """
    tel = get_telemetry() if telemetry is None else telemetry
    predicted: Dict[str, float] = {}
    measured: Dict[str, float] = {}
    ratios: Dict[str, float] = {}
    self_calibrated = False

    pred_wire, _buckets = wire_bytes_f32(facts)
    predicted["wire_bytes_f32"] = float(pred_wire)
    if measured_wire_bytes_f32 is not None and pred_wire > 0:
        measured["wire_bytes_f32"] = float(measured_wire_bytes_f32)
        ratios["wire_bytes"] = float(measured_wire_bytes_f32) / pred_wire
        tel.set_gauge("kfac/plan_drift_wire_bytes", ratios["wire_bytes"])

    pred_macs = refresh_cost(facts, plan)
    predicted["refresh_macs"] = float(pred_macs)
    if (
        measured_refresh_ms is not None
        and measured_refresh_ms > 0
        and pred_macs > 0
    ):
        measured["refresh_ms"] = float(measured_refresh_ms)
        if calibration_macs_per_ms is None or calibration_macs_per_ms <= 0:
            # no external MACs→ms rate: calibrate on this measurement, so
            # the ratio degenerates to exactly 1.0 (plumbing check only)
            calibration_macs_per_ms = pred_macs / float(measured_refresh_ms)
            self_calibrated = True
        pred_ms = pred_macs / float(calibration_macs_per_ms)
        predicted["refresh_ms"] = float(pred_ms)
        ratios["refresh_rate"] = float(measured_refresh_ms) / pred_ms
        tel.set_gauge("kfac/plan_drift_refresh_rate", ratios["refresh_rate"])

    if (
        measured_state_bytes_local is not None
        and plan.factor_sharding == "owner"
        and int(factor_world) > 1
    ):
        shard = plan_factor_shards(
            facts.shapes, int(factor_world), diag_a=set(facts.diag_a)
        )
        info = shard_plan_bytes(shard, rank_fn=_rank_fn_for(plan))
        pred_owner = int(info["total_buffer_local"])
        predicted["owner_bytes_local"] = float(pred_owner)
        if pred_owner > 0:
            measured["owner_bytes_local"] = float(measured_state_bytes_local)
            ratios["owner_bytes"] = (
                float(measured_state_bytes_local) / pred_owner
            )
            tel.set_gauge("kfac/plan_drift_owner_bytes", ratios["owner_bytes"])

    return DriftReport(
        predicted=predicted,
        measured=measured,
        ratios=ratios,
        self_calibrated=self_calibrated,
    )
