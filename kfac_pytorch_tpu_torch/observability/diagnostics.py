"""K-FAC health-diagnostics state: key registry + metric flattening.

Port of ``kfac_pytorch_tpu/observability/diagnostics.py``. The diagnostics
are computed by ``KFAC.update`` (``track_diagnostics=True``) as device
tensors in ``kfac_state['diagnostics']``; this module owns the key names
and reduces the per-layer entries to the flat ``kfac_*`` scalars the
trainers log, without reading anything back to the host.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

# Scalar entries of the diagnostics state (kfac_state['diagnostics'][<key>]).
# 'eigen_stale_steps' is int32; the rest are float32.
SCALAR_KEYS = (
    "nu",
    "min_damped_eig",
    "max_damped_eig",
    "grad_norm",
    "update_norm",
    "update_grad_cos",
    "eigen_stale_steps",
)

# Per-layer entries: kfac_state['diagnostics']['layer_cond'][<layer>][<key>],
# the damped condition numbers of each factor, refreshed on eigen-method
# refresh steps.
LAYER_COND_KEYS = ("cond_A", "cond_G")


def diagnostic_metrics(diag: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a diagnostics state into the ``kfac_*`` metric scalars; the
    per-layer condition numbers reduce to their max (``kfac_cond_max``)."""
    out = {f"kfac_{k}": diag[k] for k in SCALAR_KEYS if k in diag}
    layer_cond = diag.get("layer_cond")
    if layer_cond:
        conds = [
            e[k].float() for e in layer_cond.values() for k in LAYER_COND_KEYS if k in e
        ]
        if conds:
            out["kfac_cond_max"] = torch.max(torch.stack(conds))
    return out
