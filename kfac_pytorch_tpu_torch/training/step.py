"""The train step: forward → CE loss → backward → K-FAC → SGD.

Port of ``kfac_pytorch_tpu/training/step.py`` for one device without
gradient accumulation (``make_train_step``, ``make_sgd``,
``softmax_cross_entropy``, ``kfac_flags_for_step``). PyTorch runs eagerly,
so the JAX package's compiled step variants become plain keyword flags;
the statistics capture is ``capture.Capture``'s hooks, open only on
capture steps.

The step updates the model's parameters and the momentum buffers in
place: the declared ``sgd_hyper`` with a K-FAC preconditioner routes the
optimizer through the fused SGD kernel wrapper (``ops/apply_kernels.py``),
otherwise the per-leaf ``make_sgd`` step runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.capture import Capture
from kfac_pytorch_tpu_torch.ops import apply_kernels
from kfac_pytorch_tpu_torch.preconditioner import KFAC


@dataclasses.dataclass
class TrainState:
    """Training state: the model holds params and BN buffers; ``opt_state``
    the momentum buffers by parameter name."""

    step: int
    model: nn.Module
    opt_state: Dict[str, torch.Tensor]
    kfac_state: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class SGD:
    """``torch.optim.SGD`` semantics (dampening 0): weight decay is added to
    the (preconditioned) gradient, then momentum, then ``−lr``."""

    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for n, p in params.items()}

    def apply(self, params, grads, trace, lr: float) -> None:
        names = list(params)
        apply_kernels.fused_sgd_apply_plain(
            [params[n].detach() for n in names], [grads[n] for n in names],
            [trace[n] for n in names], lr, self.momentum, self.weight_decay,
        )


def make_sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> SGD:
    return SGD(momentum, weight_decay)


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean CE with optional label smoothing."""
    return F.cross_entropy(
        logits.float(), labels.long(), label_smoothing=label_smoothing
    )


def make_train_step(
    model: nn.Module,
    tx: SGD,
    kfac: Optional[KFAC] = None,
    sgd_hyper: Optional[Tuple[float, float]] = None,
) -> Callable:
    """Build ``step_fn(state, batch, lr, damping, update_factors=...,
    update_eigen=...) -> (state, metrics)``.

    ``sgd_hyper=(momentum, weight_decay)`` declares that ``tx`` is exactly
    ``make_sgd(momentum, weight_decay)``; with a preconditioner, the
    optimizer step then runs through the fused SGD kernel wrapper (unless
    ``apply_kernel="dense"``). ``kfac=None`` is the plain-SGD baseline
    (``--kfac-update-freq 0``).
    """
    if sgd_hyper is not None and (
        sgd_hyper[0] != tx.momentum or sgd_hyper[1] != tx.weight_decay
    ):
        raise ValueError(
            f"sgd_hyper={sgd_hyper} does not describe tx (momentum="
            f"{tx.momentum}, weight_decay={tx.weight_decay})"
        )
    capture = None
    if kfac is not None:
        capture = Capture(model, kfac.layers, batch_averaged=kfac.batch_averaged)

    def train_step(
        state: TrainState,
        batch: Tuple[torch.Tensor, torch.Tensor],
        lr: float,
        damping: float,
        *,
        update_factors: bool = False,
        update_eigen: bool = False,
        diag_warmup_done: bool = True,
    ):
        # diag_warmup_done gates diag_blocks > 1, which is not ported (KFAC
        # refuses it), so it changes nothing here; it is accepted so the
        # flags of kfac_flags_for_step pass through as in the JAX package.
        del diag_warmup_done
        images, labels = batch
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        capture_stats = kfac is not None and update_factors
        ctx = (
            capture.capturing(kfac.factor_kernel)
            if capture_stats
            else contextlib.nullcontext()
        )
        with ctx:
            logits = model(images)
            loss = softmax_cross_entropy(logits, labels)
            loss.backward()
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        kfac_state = state.kfac_state
        if kfac is not None:
            grads, kfac_state = kfac.update(
                grads,
                kfac_state,
                a_contribs=capture.a_contribs if capture_stats else None,
                g_factor_stats=capture.g_factor_stats if capture_stats else None,
                lr=lr,
                damping=damping,
                update_factors=update_factors,
                update_eigen=update_eigen,
            )
        fused = None
        if sgd_hyper is not None and kfac is not None:
            fused = apply_kernels.dispatch_sgd_apply(
                params, grads, state.opt_state, lr, sgd_hyper[0], sgd_hyper[1],
                kind=kfac.apply_kernel,
            )
        if fused is None:
            tx.apply(params, grads, state.opt_state, lr)
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == labels).float().mean()
        metrics = {"loss": loss.detach(), "accuracy": acc}
        new_state = TrainState(
            step=state.step + 1,
            model=model,
            opt_state=state.opt_state,
            kfac_state=kfac_state,
        )
        return new_state, metrics

    return train_step


def kfac_flags_for_step(
    step: int, kfac: Optional[KFAC], epoch: Optional[int] = None
) -> dict:
    """Host-side step gating: capture every ``fac_update_freq`` steps, refresh
    the eigenbases every ``kfac_update_freq`` steps (so step 0 refreshes)."""
    if kfac is None:
        return {"update_factors": False, "update_eigen": False}
    hp = kfac.hparams
    return {
        "update_factors": step % hp.fac_update_freq == 0,
        "update_eigen": step % hp.kfac_update_freq == 0,
        "diag_warmup_done": epoch is None or epoch >= kfac.diag_warmup,
    }
