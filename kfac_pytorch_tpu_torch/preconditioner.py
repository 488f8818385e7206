"""KFAC: the K-FAC gradient preconditioner, single-device eigen method.

Port of ``kfac_pytorch_tpu/preconditioner.py::KFAC`` for the ported
paths: identity-initialized factor running averages, eigendecomposition
refresh every ``kfac_update_freq`` steps, eigenbasis preconditioning of
every K-FAC layer's gradient with the global KL clip, every step.
Embeddings (``KFACEmbed``) keep a diagonal A factor, ``A_diag [vocab]``,
initialized to ones, whose "eigendecomposition" is the floored diagonal
itself. The interface keeps the reference's functional shape:

    kfac = KFAC(...)
    state = kfac.init(model)
    new_grads, state = kfac.update(
        grads, state, a_contribs=..., g_factor_stats=...,
        lr=lr, damping=damping, update_factors=..., update_eigen=...)

``grads`` maps parameter names to gradients
(``{n: p.grad for n, p in model.named_parameters()}``); the returned dict
has every K-FAC layer's entries replaced and BatchNorm's passed through.
Statistics come from ``capture.Capture``. The state is a dict of tensors on
the preconditioner's device.

The constructor takes every argument of the reference with its default and
validation. Levers outside this slice raise ``NotImplementedError`` naming
the ROADMAP queue-1 item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.device import DeviceLike, resolve_device, use_ieee_f32
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACEmbed
from kfac_pytorch_tpu_torch.ops import apply_kernels as apply_kernel_ops
from kfac_pytorch_tpu_torch.ops import factor_kernels as factor_kernel_ops
from kfac_pytorch_tpu_torch.ops import factors as factor_ops
from kfac_pytorch_tpu_torch.ops import precondition as precond_ops
from kfac_pytorch_tpu_torch.parallel.sharded_eigh import replicated_eigen_update

KFACState = Dict[str, Any]


@dataclasses.dataclass
class KFACHParams:
    """Host-side mutable hyperparameters (``KFACParamScheduler`` mutates them)."""

    damping: float = 0.001
    kl_clip: float = 0.001
    fac_update_freq: int = 10
    kfac_update_freq: int = 100


def _validate(name: str, ok: bool, value) -> None:
    if not ok:
        raise ValueError(f"Invalid {name}: {value}")


def _not_ported(lever: str, item: str) -> None:
    raise NotImplementedError(
        f"{lever} is not ported to kfac_pytorch_tpu_torch yet (ROADMAP "
        f"queue 1 item {item})"
    )


class KFAC:
    """K-FAC gradient preconditioner (eigen method, one device).

    Args mirror the reference (kfac_pytorch_tpu/preconditioner.py:142-179)
    plus ``device`` (default CUDA; raises without a GPU unless
    ``device="cpu"``). ``lr`` is validated for API parity only: the KL clip
    always uses the per-step ``update(lr=...)``.
    """

    def __init__(
        self,
        lr: float = 0.1,
        factor_decay: float = 0.95,
        damping: float = 0.001,
        kl_clip: float = 0.001,
        fac_update_freq: int = 10,
        kfac_update_freq: int = 100,
        batch_averaged: bool = True,
        diag_blocks: int = 1,
        diag_warmup: int = 0,
        distribute_layer_factors: Optional[bool] = None,
        distribute_precondition: bool = False,
        precond_comm_dtype: Optional[Any] = None,
        mesh: Optional[Any] = None,
        axis_name: str = "data",
        eps: float = 1e-10,
        layers: Optional[list] = None,
        precond_precision: Optional[Any] = None,
        eigen_dtype: Any = torch.float32,
        precond_method: str = "eigen",
        track_diagnostics: bool = False,
        eigh_chunks: int = 1,
        factor_kernel: str = "auto",
        apply_kernel: str = "auto",
        factor_comm_dtype: Any = "f32",
        factor_comm_freq: int = 1,
        solver: str = "eigh",
        solver_rank: int = 128,
        solver_auto_threshold: int = 512,
        factor_sharding: str = "replicated",
        comm_overlap: bool = False,
        staleness_budget: int = 0,
        stream_drift_threshold: float = 0.05,
        service_devices: int = 0,
        profile: Optional[Any] = None,
        profile_shapes: Optional[Any] = None,
        device: DeviceLike = None,
    ):
        _validate("learning rate", 0.0 <= lr, lr)
        _validate("factor decay rate", 0.0 < factor_decay <= 1, factor_decay)
        _validate("damping", 0.0 < damping, damping)
        _validate("clipping value", 0.0 < kl_clip, kl_clip)
        _validate("factor update frequency", 0 < fac_update_freq, fac_update_freq)
        _validate("K-FAC update frequency", 0 < kfac_update_freq, kfac_update_freq)
        _validate("diagonal block approx count", 0 < diag_blocks, diag_blocks)
        _validate("precond_method", precond_method in ("eigen", "inverse"), precond_method)
        _validate("eigh chunk count", 0 < eigh_chunks, eigh_chunks)
        _validate("solver", solver in ("eigh", "rsvd", "streaming"), solver)
        _validate(
            "factor_sharding", factor_sharding in ("replicated", "owner"), factor_sharding
        )
        if kfac_update_freq % fac_update_freq != 0:
            print(
                "WARNING: kfac_update_freq does not divide evenly by "
                "fac_update_freq; eigendecompositions will sometimes run on "
                "stale factors"
            )

        # Levers of later slices: refuse rather than silently ignore.
        if mesh is not None:
            _not_ported("mesh= (multi-GPU data parallel)", "6")
        if distribute_layer_factors is not None or distribute_precondition:
            _not_ported("distribute_layer_factors/distribute_precondition", "6")
        if precond_comm_dtype is not None:
            _not_ported("precond_comm_dtype", "6")
        if str(factor_comm_dtype).lower() not in ("f32", "float32") or factor_comm_freq != 1:
            _not_ported("factor_comm_dtype/factor_comm_freq (factor comm plane)", "6")
        if comm_overlap:
            _not_ported("comm_overlap", "7")
        if staleness_budget != 0:
            _not_ported("staleness_budget", "7")
        if eigh_chunks > 1:
            _not_ported("eigh_chunks > 1 (pipelined refresh)", "7")
        if solver != "eigh":
            _not_ported(f"solver={solver!r}", "7")
        if factor_sharding == "owner":
            _not_ported("factor_sharding='owner'", "7")
        if precond_method == "inverse":
            _not_ported("precond_method='inverse'", "4")
        # diag_warmup only picks between diag_blocks and 1 block, so with
        # diag_blocks == 1 it changes nothing (the JAX package accepts it)
        if diag_blocks != 1:
            _not_ported("diag_blocks > 1", "4")
        if eigen_dtype != torch.float32:
            _not_ported("eigen_dtype other than float32", "4")
        if track_diagnostics:
            _not_ported("track_diagnostics", "4")
        if precond_precision is not None:
            _not_ported("precond_precision (the port is float32 throughout)", "4")
        if service_devices != 0:
            _not_ported("service_devices (curvature service)", "9")
        if profile is not None or profile_shapes is not None:
            _not_ported("profile= (planner)", "9")

        self.device = resolve_device(device)
        use_ieee_f32()
        self.factor_decay = factor_decay
        self.batch_averaged = batch_averaged
        self.diag_warmup = diag_warmup
        self.eps = eps
        self.layers = list(layers) if layers is not None else None
        # "auto": the CUDA kernels for CUDA tensors, their plain versions for
        # CPU tensors; "kernel": the CUDA kernels or an error; "dense": the
        # oracle paths (im2col factors, einsum-chain apply, per-leaf SGD).
        self.factor_kernel = factor_kernel_ops.resolve_factor_kernel(
            factor_kernel, self.device
        )
        self.apply_kernel = apply_kernel_ops.resolve_apply_kernel(
            apply_kernel, self.device
        )
        self.hparams = KFACHParams(
            damping=damping,
            kl_clip=kl_clip,
            fac_update_freq=fac_update_freq,
            kfac_update_freq=kfac_update_freq,
        )

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _identity_factors(self, model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
        """Identity-initialized ``{layer: {A, G}}`` — the shape oracle.
        Embeddings get ``{A_diag, G}``: ones (the diagonal of I) over the
        vocab and an identity over the features. A grouped conv's
        pseudo-layer ``path#gK`` gets an ``(in/G)·kh·kw (+1)`` A side and an
        ``out/G`` G side."""
        facs = {}
        names = self.layers if self.layers is not None else capture.discover_layers(model)
        modules: Dict[str, nn.Module] = {}
        for name in names:
            base, group = capture.split_group_name(name)
            m = modules.get(base)
            if m is None:
                m = modules[base] = model.get_submodule(base)
            groups = m.groups if isinstance(m, KFACConv) else 1
            if (group is None) != (groups == 1):
                raise ValueError(
                    f"K-FAC layer {name!r}: a grouped conv is listed as its "
                    f"pseudo-layers '{base}{capture.GROUP_SEP}K', any other "
                    "layer by its module path"
                )
            if isinstance(m, KFACEmbed):
                vocab, feats = m.weight.shape
                facs[name] = {
                    "A_diag": torch.ones(vocab, dtype=torch.float32, device=self.device),
                    "G": torch.eye(feats, dtype=torch.float32, device=self.device),
                }
                continue
            has_bias = m.bias is not None
            if isinstance(m, KFACConv):
                cout, cin, kh, kw = m.weight.shape  # cin: in/G already
                cout //= groups
                a_side = cin * kh * kw + int(has_bias)
            else:
                cout, cin = m.weight.shape
                a_side = cin + int(has_bias)
            facs[name] = {
                "A": torch.eye(a_side, dtype=torch.float32, device=self.device),
                "G": torch.eye(cout, dtype=torch.float32, device=self.device),
            }
        return facs

    def init(self, model: nn.Module) -> KFACState:
        """Identity factors + zero eigen state; same-shape groups pre-stacked."""
        facs = self._identity_factors(model)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        eigen = {}
        for name, f in facs.items():
            if "A_diag" in f:
                g_side = f["G"].shape[0]
                eigen[name] = {
                    "dA": z(f["A_diag"].shape[0]), "QG": z(g_side, g_side), "dG": z(g_side),
                }
                continue
            a_side, g_side = f["A"].shape[0], f["G"].shape[0]
            eigen[name] = {
                "QA": z(a_side, a_side), "dA": z(a_side),
                "QG": z(g_side, g_side), "dG": z(g_side),
            }
        singles, stacked = precond_ops.split_eigen_state(eigen)
        return {"step": 0, "factors": facs, "eigen": singles, "eigen_stacked": stacked}

    # ------------------------------------------------------------------
    # Update
    # ------------------------------------------------------------------

    def update(
        self,
        grads: Dict[str, torch.Tensor],
        state: KFACState,
        *,
        a_contribs: Optional[Dict[str, torch.Tensor]] = None,
        g_factor_stats: Optional[Dict[str, torch.Tensor]] = None,
        lr=None,
        damping=None,
        update_factors: bool,
        update_eigen: bool,
    ) -> Tuple[Dict[str, torch.Tensor], KFACState]:
        """One K-FAC step: factor EMA (capture steps), eigen refresh
        (``update_eigen``), precondition + KL clip (every step)."""
        if lr is None:
            raise ValueError(
                "KFAC.update() requires lr= (the KL clip scales with the "
                "trainer's current learning rate)"
            )
        if damping is None:
            damping = self.hparams.damping
        names = list(state["factors"].keys())
        facs = state["factors"]
        if update_factors:
            if a_contribs is None or g_factor_stats is None:
                raise ValueError(
                    "update_factors=True requires a_contribs and g_factor_stats"
                )
            missing = [n for n in names if n not in a_contribs or n not in g_factor_stats]
            if missing:
                raise ValueError(
                    f"no captured statistics for layers {missing}; build the "
                    "Capture with the same layer list as KFAC"
                )
            # elementwise EMA: the same update serves A matrices and the
            # embeddings' A_diag vectors
            old_facs, facs = facs, {}
            for name in names:
                a_key = "A_diag" if "A_diag" in old_facs[name] else "A"
                facs[name] = {
                    a_key: factor_ops.update_running_avg(
                        a_contribs[name], old_facs[name][a_key], self.factor_decay
                    ),
                    "G": factor_ops.update_running_avg(
                        g_factor_stats[name], old_facs[name]["G"], self.factor_decay
                    ),
                }
        eigen, stacked = state["eigen"], state["eigen_stacked"]
        if update_eigen:
            eigen = replicated_eigen_update(facs, {n: 1 for n in names}, self.eps)
            # diagonal A: the eigenvectors are the identity, so no eigh — the
            # eigenvalues are the diagonal under the reference's floor
            for name in names:
                if "A_diag" in facs[name]:
                    d = facs[name]["A_diag"]
                    eigen[name]["dA"] = d * (d > self.eps)
            eigen, stacked = precond_ops.split_eigen_state(eigen)

        new_grads, _, _, _ = self._precondition_replicated(
            grads, names, eigen, stacked, lr, damping
        )
        new_state = {
            "step": state["step"] + 1,
            "factors": facs,
            "eigen": eigen,
            "eigen_stacked": stacked,
        }
        return new_grads, new_state

    def _precondition_replicated(self, grads, names, eigen, stacked, lr, damping):
        """Every-step precondition + KL clip; returns
        ``(new_grads, gmats, updates, nu)``."""
        embeddings = precond_ops.diag_a_names(eigen)
        lgrads = capture.layer_grads(grads, names, embeddings)
        gmats = {n: m.float() for n, m in capture.grad_mats(lgrads).items()}
        updates, vg_terms = precond_ops.precondition_all_with_vg(
            gmats, eigen, damping, stacked=stacked, kind=self.apply_kernel
        )
        if vg_terms is not None:
            nu = precond_ops.kl_clip_from_vg(vg_terms, lr, self.hparams.kl_clip)
        else:
            nu = precond_ops.kl_clip_coefficient(updates, gmats, lr, self.hparams.kl_clip)
        return capture.write_back(grads, updates, nu, embeddings), gmats, updates, nu
