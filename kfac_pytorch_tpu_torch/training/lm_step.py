"""The recurrent LM's train step: truncated BPTT + grad clip + K-FAC + SGD.

Port of ``kfac_pytorch_tpu/training/lm_step.py`` (``make_lm_train_step``,
``make_lm_eval_step``, ``init_carry``), the RNN analog of
``training/step.py``: the incoming carry is detached at each segment
(truncated BPTT), the statistics are captured on K-FAC capture steps, the
loss is the float32 cross-entropy over all ``B·T`` tokens, the gradients
are clipped by their global norm before ``KFAC.update``, then SGD runs
through the fused SGD kernel (kernel 4) when ``sgd_hyper`` declares the
optimizer: also at the recipe's momentum 0, as the JAX package fuses
``optax.trace(decay=0)``. Metrics are ``loss`` and ``ppl`` (and the
``kfac_*`` diagnostics with ``track_diagnostics``, and the truncated
solvers' gauges).

Data-parallel (the JAX package's ``_compute_compressed``): each rank runs
its own rows of the global batch and carries their recurrent state; the
gradients are averaged over the ranks before the global-norm clip, in
float32 or, over more than one rank, with the payload in
``grad_comm_dtype`` (``pmean_compressed``), and the loss is averaged too.
The K-FAC statistics cross the wire inside ``KFAC.update``, or under
``KFAC(comm_overlap=True)`` start before the gradient mean
(``KFAC.start_exchange``, the JAX step's overlap mechanism (a)). Over more than
one rank the dropout masks differ per rank, as the JAX step folds the axis
index into its key: each step draws them from a generator seeded from the
caller's generator's seed, the step and the rank, and at world one from
the caller's generator itself, as on one device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch.capture import Capture
from kfac_pytorch_tpu_torch.observability.diagnostics import diagnostic_metrics
from kfac_pytorch_tpu_torch.parallel.mesh import WIRE_DTYPES, World, data_parallel_world
from kfac_pytorch_tpu_torch.preconditioner import KFAC
from kfac_pytorch_tpu_torch.training.step import (
    SGD,
    TrainState,
    clip_by_global_norm,
    pmean_compressed,
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
    world: Optional[World] = None,
    grad_comm_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """Build ``step_fn(state, (tokens, targets), carry, generator, lr,
    damping, update_factors=..., update_eigen=..., diag_warmup_done=...,
    eigen_chunk=..., swap_eigen=..., flush_factors=...)``
    ``-> (state, new_carry, metrics)``; ``generator`` draws the dropout
    masks. Updates the model's parameters and the momentum in place.

    ``world`` (default: the preconditioner's, else the default process
    group's, else one process) is the data-parallel world: ``tokens``,
    ``targets`` and ``carry`` are this rank's rows. ``grad_comm_dtype``
    (``torch.bfloat16``) compresses the gradient mean over more than one
    rank and is inert on one, as in the JAX package."""
    if grad_comm_dtype is not None and grad_comm_dtype not in WIRE_DTYPES:
        raise ValueError(f"Invalid grad_comm_dtype: {grad_comm_dtype}")
    if world is None:
        world = kfac.world if kfac is not None else data_parallel_world()
    compressed = grad_comm_dtype is not None and world.size > 1
    capture = None
    if kfac is not None:
        capture = Capture(model, kfac.layers, batch_averaged=kfac.batch_averaged)
    sgd_plans: Dict[str, Any] = {}
    rank_generators: Dict[Any, torch.Generator] = {}

    def masks_of(generator: Optional[torch.Generator], step: int):
        """The generator this rank draws the step's dropout masks from."""
        if generator is None or world.size == 1:
            return generator
        gen = rank_generators.get(generator.device)
        if gen is None:
            gen = rank_generators[generator.device] = torch.Generator(device=generator.device)
        seed = (generator.initial_seed() * 1_000_003 + step) * 1_000_003 + world.rank
        return gen.manual_seed(seed % (1 << 63))

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
        flush_factors: bool = False,
    ):
        tokens, targets = batch
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        capture_stats = kfac is not None and update_factors
        ctx = capture.capturing(kfac.factor_kernel) if capture_stats else contextlib.nullcontext()
        with ctx:
            logits, new_carry = model(tokens, detach_carry(carry),
                                      masks_of(generator, state.step))
            loss = softmax_cross_entropy(logits, targets)
            loss.backward()
        a_c = g_s = None
        if capture_stats:
            a_c, g_s = capture.a_contribs, capture.g_factor_stats
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        loss = loss.detach()
        # the overlap plane: the factor bucket means before the gradient mean
        exchange = kfac.start_exchange(state.kfac_state, a_c, g_s) if capture_stats else None
        if world.distributed:
            # the ranks' mean before the clip, as the JAX step takes it
            pmean_compressed(grads.values(), world, grad_comm_dtype if compressed else None)
            loss = loss.clone()
            world.all_reduce_mean_([loss])
        if exchange is not None:
            a_c, g_s = exchange()
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        new_state = precondition_and_step(
            state, params, grads, a_c, g_s, lr, damping, kfac, tx, sgd_hyper, sgd_plans,
            update_factors=update_factors, update_eigen=update_eigen,
            diag_warmup_done=diag_warmup_done, eigen_chunk=eigen_chunk, swap_eigen=swap_eigen,
            flush_factors=flush_factors, exchanged=exchange is not None,
        )
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
