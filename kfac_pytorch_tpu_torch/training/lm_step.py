"""The recurrent LM's train step: truncated BPTT + grad clip + K-FAC + SGD.

Port of ``kfac_pytorch_tpu/training/lm_step.py`` for one device
(``make_lm_train_step``, ``make_lm_eval_step``, ``init_carry``), the RNN
analog of ``training/step.py``: the incoming carry is detached at each
segment (truncated BPTT), the statistics are captured on K-FAC capture
steps, the loss is the float32 cross-entropy over all ``B·T`` tokens, the
gradients are clipped by their global norm before ``KFAC.update``, then SGD
runs through the fused SGD kernel (kernel 4) when ``sgd_hyper`` declares
the optimizer: also at the recipe's momentum 0, as the JAX package fuses
``optax.trace(decay=0)``. Metrics are ``loss`` and ``ppl`` (and the
``kfac_*`` diagnostics with ``track_diagnostics``, and the truncated
solvers' gauges). The JAX package's
compressed multi-device gradient mean (``_compute_compressed``) is ROADMAP
queue 1 item 6 (6b).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch.capture import Capture
from kfac_pytorch_tpu_torch.observability.diagnostics import diagnostic_metrics
from kfac_pytorch_tpu_torch.preconditioner import KFAC
from kfac_pytorch_tpu_torch.training.step import (
    SGD,
    TrainState,
    clip_by_global_norm,
    precondition_and_step,
    softmax_cross_entropy,
    solver_metrics,
)


def init_carry(model: nn.Module, batch_size: int, device) -> List[Any]:
    """Zero recurrent carry of ``model`` (a ``models.wikitext_rnn.RNNModel``)
    for a batch: an epoch's start."""
    return [rnn.zero_carry(batch_size, device) for rnn in model.rnns]


def detach_carry(carry: List[Any]) -> List[Any]:
    """The carry cut from the graph that made it: truncated BPTT."""
    return [tuple(c.detach() for c in x) if isinstance(x, tuple) else x.detach()
            for x in carry]


def make_lm_train_step(
    model: nn.Module,
    tx: SGD,
    kfac: Optional[KFAC] = None,
    grad_clip: float = 0.25,
    sgd_hyper: Optional[Tuple[float, float]] = None,
) -> Callable:
    """Build ``step_fn(state, (tokens, targets), carry, generator, lr,
    damping, update_factors=..., update_eigen=..., diag_warmup_done=...,
    eigen_chunk=..., swap_eigen=...)``
    ``-> (state, new_carry, metrics)``; ``generator`` draws the dropout
    masks. Updates the model's parameters and the momentum in place."""
    capture = None
    if kfac is not None:
        capture = Capture(model, kfac.layers, batch_averaged=kfac.batch_averaged)
    sgd_plans: Dict[str, Any] = {}

    def train_step(
        state: TrainState,
        batch: Tuple[torch.Tensor, torch.Tensor],
        carry: List[Any],
        generator: Optional[torch.Generator],
        lr: float,
        damping: float,
        *,
        update_factors: bool = False,
        update_eigen: bool = False,
        diag_warmup_done: bool = True,
        eigen_chunk: Optional[Tuple[int, int]] = None,
        swap_eigen: bool = False,
    ):
        tokens, targets = batch
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        capture_stats = kfac is not None and update_factors
        ctx = capture.capturing(kfac.factor_kernel) if capture_stats else contextlib.nullcontext()
        with ctx:
            logits, new_carry = model(tokens, detach_carry(carry), generator)
            loss = softmax_cross_entropy(logits, targets)
            loss.backward()
        a_c = g_s = None
        if capture_stats:
            a_c, g_s = capture.a_contribs, capture.g_factor_stats
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        new_state = precondition_and_step(
            state, params, grads, a_c, g_s, lr, damping, kfac, tx, sgd_hyper, sgd_plans,
            update_factors=update_factors, update_eigen=update_eigen,
            diag_warmup_done=diag_warmup_done, eigen_chunk=eigen_chunk, swap_eigen=swap_eigen,
        )
        loss = loss.detach()
        metrics = {"loss": loss, "ppl": torch.exp(loss)}
        if kfac is not None and kfac.track_diagnostics:
            metrics.update(diagnostic_metrics(new_state.kfac_state["diagnostics"]))
        metrics.update(solver_metrics(new_state.kfac_state))
        return new_state, detach_carry(new_carry), metrics

    return train_step


def make_lm_eval_step(model: nn.Module) -> Callable:
    """``eval_step(state, (tokens, targets), carry) -> (metrics, new_carry)``:
    the carry threaded, no dropout, ``{'loss', 'ppl'}`` device tensors."""

    def eval_step(state: TrainState, batch, carry):
        del state  # the model holds the parameters
        tokens, targets = batch
        model.eval()
        with torch.no_grad():
            logits, new_carry = model(tokens, carry)
            loss = softmax_cross_entropy(logits, targets)
        return {"loss": loss, "ppl": torch.exp(loss)}, new_carry

    return eval_step
