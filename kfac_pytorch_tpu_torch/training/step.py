"""The train step: forward → CE loss → backward → K-FAC → SGD, and evaluation.

Port of ``kfac_pytorch_tpu/training/step.py`` (``make_train_step`` with
gradient accumulation and global-norm clipping, ``make_eval_step``,
``make_masked_eval_step``, ``make_bn_recal_step``, ``make_sgd``,
``per_sample_cross_entropy``, ``softmax_cross_entropy``,
``clip_by_global_norm``, ``kfac_flags_for_step``, ``pmean_compressed``),
on one device or data-parallel over the ranks of a ``parallel.mesh.World``
(one data axis, so the JAX package's ``require_pure_dp_mesh`` check has
nothing to refuse). PyTorch runs eagerly,
so the JAX package's compiled step variants become plain keyword flags;
the statistics capture is ``capture.Capture``'s hooks, open only on
capture steps.

The step updates the model's parameters and the momentum buffers in
place: the declared ``sgd_hyper`` with a K-FAC preconditioner routes the
optimizer through the fused SGD kernel wrapper (``ops/apply_kernels.py``,
with a launch plan the step keeps between calls), otherwise the per-leaf
``make_sgd`` step runs.

Data-parallel, each rank runs its own batch, and the gradients, the loss
and the accuracy are averaged over the ranks (float32 ``all_reduce``s).
Under a seq axis (``parallel.mesh.data_seq_world``, the transformer with
sequence-parallel attention) each rank's batch is its data slot's rows
cut to its seq slot's positions: it backpropagates the mean loss over its
own tokens, the ring or Ulysses backward sends the cross-rank parts back,
and since every rank holds as many tokens the world mean of the gradients
is the gradient of the global mean loss; the G statistics, taken over the
local tokens with ``compute_g_dense``'s ×N, average over the world into
the global batch's (``grad_comm_dtype`` is refused there, as in the JAX
package);
the K-FAC statistics cross the wire inside ``KFAC.update`` (its factor
comm plane, ``parallel/comm.py``; owner-sharded, its reduce-scatter), or,
under ``KFAC(comm_overlap=True)`` on a capture step, their bucket means
start before the gradient mean and are waited on before ``KFAC.update``
(``KFAC.start_exchange``, the JAX step's overlap mechanism (a)). BatchNorm takes
the JAX step's two routes: by default (the JAX package's GSPMD step) it
normalizes over the global batch (``models.cifar_resnet.global_batchnorm``);
under ``grad_comm_dtype`` (the JAX package's ``_compressed_grads``, the
reference's ``--fp16-allreduce``) each rank normalizes over its own batch,
the gradient mean crosses the wire in ``grad_comm_dtype``
(:func:`pmean_compressed`) and the BatchNorm running statistics are
averaged after the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.capture import Capture
from kfac_pytorch_tpu_torch.models.cifar_resnet import BatchNorm2d, global_batchnorm
from kfac_pytorch_tpu_torch.models.layers import tensor_split_params
from kfac_pytorch_tpu_torch.observability.diagnostics import diagnostic_metrics
from kfac_pytorch_tpu_torch.ops import apply_kernels
from kfac_pytorch_tpu_torch.parallel.mesh import WIRE_DTYPES, World, data_parallel_world
from kfac_pytorch_tpu_torch.preconditioner import KFAC


@dataclasses.dataclass
class TrainState:
    """Training state: the model holds params and BN buffers; ``opt_state``
    the momentum buffers by parameter name; on a data×fsdp×tensor world
    ``fsdp`` (``parallel.fsdp.FsdpParams``) holds this rank's parts of the
    fsdp-split parameters, whose momentum buffers are parts too."""

    step: int
    model: nn.Module
    opt_state: Dict[str, torch.Tensor]
    kfac_state: Optional[Dict[str, Any]] = None
    fsdp: Optional[Any] = None


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


def per_sample_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """CE with optional label smoothing per sample: shape ``logits.shape[:-1]``."""
    ce = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        labels.long().reshape(-1),
        label_smoothing=label_smoothing,
        reduction="none",
    )
    return ce.reshape(logits.shape[:-1])


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean CE with optional label smoothing over every leading dimension
    (``[B, C]`` image logits or ``[B, T, V]`` LM logits)."""
    return F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        labels.long().reshape(-1),
        label_smoothing=label_smoothing,
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of argmax predictions equal to the labels, over every leading
    dimension."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def clip_by_global_norm(
    grads: Dict[str, torch.Tensor], max_norm: float,
    split: Optional[Dict[str, Tuple[int, World]]] = None,
) -> Dict[str, torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics (scale every gradient by
    ``min(1, max_norm / ‖g‖)``, the norm over all of them), without a host
    sync; returns a new dict. The gradients named in ``split`` are this
    tensor slot's shards (``layers.tensor_split_params``): their squares
    are summed over their world's tensor subgroup, once beside the whole
    model's other gradients, which every slot holds."""
    first = next(iter(grads.values()))
    if split:
        part = sum((grads[n].float() ** 2).sum() for n in split).reshape(1)
        sq = sum((g.float() ** 2).sum() for n, g in grads.items() if n not in split)
        gnorm = torch.sqrt(sq + next(iter(split.values()))[1].tensor_sum_(part)[0])
    else:
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    limit = torch.full((), float(max_norm), dtype=torch.float32, device=first.device)
    scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {n: g * scale for n, g in grads.items()}


def pmean_compressed(tensors, world: World, comm_dtype: Optional[torch.dtype]) -> None:
    """The ranks' mean of each tensor, in place, its payload crossing the
    wire in ``comm_dtype`` (each rank's value rounds once; ``None``: the
    tensors' own dtype) and the result restored to the tensors' dtype."""
    world.all_reduce_mean_(list(tensors), comm_dtype=comm_dtype)


def make_train_step(
    model: nn.Module,
    tx: SGD,
    kfac: Optional[KFAC] = None,
    sgd_hyper: Optional[Tuple[float, float]] = None,
    grad_clip: float = 0.0,
    label_smoothing: float = 0.0,
    accum_steps: int = 1,
    stats_all_microbatches: bool = False,
    world: Optional[World] = None,
    grad_comm_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """Build ``step_fn(state, batch, lr, damping, update_factors=...,
    update_eigen=..., diag_warmup_done=..., eigen_chunk=..., swap_eigen=...,
    flush_factors=...) -> (state, metrics)``; the flags are
    ``KFAC.update``'s (from ``kfac_flags_for_step`` or
    ``scheduler.EigenRefreshCadence``). ``lr`` and ``damping`` are floats or
    0-d tensors; the step reads them as float32 device scalars (the same
    bits either way), which a CUDA-graph replay
    (``training/graphs.py``) refreshes in place.

    The loss is the mean CE with ``label_smoothing`` (the ImageNet recipe's
    0.1), as the JAX step computes it.

    ``grad_clip > 0`` clips the gradients by their global norm between the
    backward pass and ``kfac.update``, the JAX step's clip point.

    ``sgd_hyper=(momentum, weight_decay)`` declares that ``tx`` is exactly
    ``make_sgd(momentum, weight_decay)``; with a preconditioner, the
    optimizer step then runs through the fused SGD kernel wrapper (unless
    ``apply_kernel="dense"``). ``kfac=None`` is the plain-SGD baseline
    (``--kfac-update-freq 0``).

    ``accum_steps > 1`` is gradient accumulation (``--batches-per-allreduce``):
    the batch arrives as ``[accum_steps, microbatch, ...]``, each microbatch
    takes a forward and a backward of its own mean loss in order (so the
    BatchNorm running statistics thread through them), and the gradients,
    the loss and the accuracy are averaged over the microbatches. K-FAC
    statistics come from the last microbatch, or with
    ``stats_all_microbatches`` from every one, averaged. Either way the
    hooks see the gradients of the unscaled microbatch loss, as in the JAX
    package (the reference's ``loss / accum`` would shrink G by
    ``accum_steps²``).

    With ``kfac.track_diagnostics`` the metrics also carry the ``kfac_*``
    diagnostics (``observability/diagnostics.py``), as device tensors, and
    under the truncated solvers their gauges (:func:`solver_metrics`).

    ``world`` (default: the preconditioner's, else the default process
    group's, else one process) is the data-parallel world; see the module
    docstring for the collectives and the BatchNorm routes.
    ``grad_comm_dtype`` (``torch.bfloat16``) selects the compressed route
    over more than one rank and is inert on one, as in the JAX package.

    On a data×fsdp×tensor world (``parallel.mesh.data_fsdp_tensor_world``)
    the model's split MLP layers compute on this tensor slot's shards, the
    global-norm clip sums their squares over the tensor subgroup, and the
    state's ``fsdp`` (a ``parallel.fsdp.FsdpParams``) gathers the
    fsdp-split parameters before the forward, hands the optimizer this
    rank's parts, their momentum and its slice of each averaged whole
    gradient, and releases the gathered values after the step.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    if grad_comm_dtype is not None and grad_comm_dtype not in WIRE_DTYPES:
        raise ValueError(f"Invalid grad_comm_dtype: {grad_comm_dtype}")
    if world is None:
        world = kfac.world if kfac is not None else data_parallel_world()
    if grad_comm_dtype is not None and world.seq_size > 1:
        raise ValueError(
            "grad_comm_dtype requires a data-plane mesh (non-data axes of "
            "size 1 or named 'tensor*'/'fsdp*'); got "
            f"{ {'data': world.data_size, 'seq': world.seq_size} } — a "
            "sequence/model axis would make the per-device local forward "
            "see a partial example"
        )
    compressed = grad_comm_dtype is not None and world.size > 1
    bn_ctx = (
        contextlib.nullcontext if compressed or world.size == 1
        else lambda: global_batchnorm(model, world)
    )
    bn_buffers = [
        b for m in model.modules() if isinstance(m, BatchNorm2d)
        for b in (m.running_mean, m.running_var)
    ]
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
    # the fused SGD kernel's plan of the leaf set, built at the first step
    # and kept while it holds (apply_kernels.dispatch_sgd_apply)
    sgd_plans: Dict[str, Any] = {}
    # this tensor slot's parameter shards (the global-norm clip's sum)
    split = tensor_split_params(model)

    def forward_backward(images, labels, capture_stats: bool):
        ctx = (
            capture.capturing(kfac.factor_kernel)
            if capture_stats
            else contextlib.nullcontext()
        )
        with ctx:
            logits = model(images)
            loss = softmax_cross_entropy(logits, labels, label_smoothing)
            loss.backward()
        with torch.no_grad():
            return loss.detach(), accuracy(logits, labels)

    def train_step(
        state: TrainState,
        batch: Tuple[torch.Tensor, torch.Tensor],
        lr,
        damping,
        *,
        update_factors: bool = False,
        update_eigen: bool = False,
        diag_warmup_done: bool = True,
        eigen_chunk: Optional[Tuple[int, int]] = None,
        swap_eigen: bool = False,
        flush_factors: bool = False,
    ):
        images, labels = batch
        model.train()
        fsdp = state.fsdp
        if fsdp is not None:
            fsdp.gather()
        params = dict(model.named_parameters())
        # lr and damping as 0-d float32 tensors on the step's device, each
        # filled once (a tensor passes through: the graphed step's scalars)
        device = next(iter(params.values())).device
        lr, damping = (apply_kernels.scalar_tensor(v, device) for v in (lr, damping))
        for p in params.values():
            p.grad = None
        capture_stats = kfac is not None and update_factors
        with bn_ctx():
            loss, acc, a_c, g_s = accumulate(images, labels, params, capture_stats)
        if capture_stats and a_c is None:
            a_c, g_s = capture.a_contribs, capture.g_factor_stats
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        # the overlap plane: the factor bucket means go on the wire before
        # the gradient mean, and are waited on before KFAC.update
        exchange = kfac.start_exchange(state.kfac_state, a_c, g_s) if capture_stats else None
        if world.distributed:
            pmean_compressed(grads.values(), world, grad_comm_dtype if compressed else None)
            means = torch.stack([loss, acc])
            world.all_reduce_mean_([means])
            loss, acc = means[0], means[1]
            if compressed:
                with torch.no_grad():
                    world.all_reduce_mean_(bn_buffers)
        if exchange is not None:
            a_c, g_s = exchange()
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip, split)
        new_state = precondition_and_step(
            state, params, grads, a_c, g_s, lr, damping, kfac, tx, sgd_hyper, sgd_plans,
            update_factors=update_factors, update_eigen=update_eigen,
            diag_warmup_done=diag_warmup_done, eigen_chunk=eigen_chunk, swap_eigen=swap_eigen,
            flush_factors=flush_factors, exchanged=exchange is not None,
            sgd_view=fsdp.sgd_view if fsdp is not None else None,
        )
        if fsdp is not None:
            fsdp.release()
        metrics = {"loss": loss, "accuracy": acc}
        if kfac is not None and kfac.track_diagnostics:
            metrics.update(diagnostic_metrics(new_state.kfac_state["diagnostics"]))
        metrics.update(solver_metrics(new_state.kfac_state))
        return new_state, metrics

    def accumulate(images, labels, params, capture_stats):
        """Forward and backward of the step's batch (or its microbatches):
        ``(loss, accuracy, a_c, g_s)``, the statistics set only when every
        microbatch captured them (else the hooks' last ones count)."""
        a_c = g_s = None
        if accum_steps == 1:
            loss, acc = forward_backward(images, labels, capture_stats)
        else:
            if images.shape[0] != accum_steps or labels.shape[0] != accum_steps:
                raise ValueError(
                    f"an accumulation step takes [{accum_steps}, microbatch, ...] "
                    f"batches, got images {tuple(images.shape)} and labels "
                    f"{tuple(labels.shape)}"
                )
            every = capture_stats and stats_all_microbatches
            for i in range(accum_steps):
                last = i == accum_steps - 1
                l_i, acc_i = forward_backward(
                    images[i], labels[i], every or (capture_stats and last)
                )
                loss, acc = (l_i, acc_i) if i == 0 else (loss + l_i, acc + acc_i)
                if every:
                    a_c = _add_stats(a_c, capture.a_contribs)
                    g_s = _add_stats(g_s, capture.g_factor_stats)
            inv = 1.0 / accum_steps
            loss, acc = loss * inv, acc * inv
            if every:
                a_c = {n: a * inv for n, a in a_c.items()}
                g_s = {n: g * inv for n, g in g_s.items()}
            for p in params.values():
                if p.grad is not None:
                    p.grad.mul_(inv)
        return loss, acc, a_c, g_s

    return train_step


def solver_metrics(kfac_state: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """The truncated solvers' gauges as step metrics, as the JAX steps emit
    them: ``kfac_spectrum_mass`` (the share of factor trace the kept bases
    captured at the last refresh) and, under streaming,
    ``kfac_stream_residual`` (the mass outside them after the last fold,
    what the trainer hands the cadence as its drift signal)."""
    out = {}
    if kfac_state is not None and "spectrum_mass" in kfac_state:
        out["kfac_spectrum_mass"] = kfac_state["spectrum_mass"]
    if kfac_state is not None and "stream_residual" in kfac_state:
        out["kfac_stream_residual"] = kfac_state["stream_residual"]
    return out


def precondition_and_step(
    state: TrainState,
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    a_c, g_s, lr: float, damping: float,
    kfac: Optional[KFAC], tx: SGD, sgd_hyper, sgd_plans: Dict[str, Any],
    sgd_view: Optional[Callable] = None,
    **flags,
) -> TrainState:
    """The tail of a train step, shared by the image and the RNN LM steps:
    ``KFAC.update`` (with the step's ``update_factors``/``update_eigen``/
    ``diag_warmup_done``/``eigen_chunk``/``swap_eigen``/``flush_factors``
    flags, and ``exchanged`` when the overlap plane averaged the statistics
    already), then SGD, through the fused SGD kernel
    wrapper when ``sgd_hyper`` declares ``tx`` and a preconditioner runs
    (``sgd_plans`` keeps its launch plan between steps), else per leaf.
    Updates the parameters and momentum in place; returns the next state.
    ``sgd_view(params, grads) -> (params, grads)`` maps the preconditioned
    gradients onto the leaves the optimizer updates
    (``parallel.fsdp.FsdpParams.sgd_view``)."""
    kfac_state = state.kfac_state
    if kfac is not None:
        grads, kfac_state = kfac.update(
            grads, kfac_state, a_contribs=a_c, g_factor_stats=g_s, lr=lr,
            damping=damping, **flags,
        )
    if sgd_view is not None:
        params, grads = sgd_view(params, grads)
    fused = None
    if sgd_hyper is not None and kfac is not None:
        fused = apply_kernels.dispatch_sgd_apply(
            params, grads, state.opt_state, lr, sgd_hyper[0], sgd_hyper[1],
            kind=kfac.apply_kernel, plans=sgd_plans,
        )
    if fused is None:
        tx.apply(params, grads, state.opt_state, lr)
    return TrainState(
        step=state.step + 1, model=state.model, opt_state=state.opt_state,
        kfac_state=kfac_state, fsdp=state.fsdp,
    )


def _add_stats(total, stats):
    """``total + stats`` per layer (``stats`` when ``total`` is None): one
    microbatch's statistics into the running sum."""
    if total is None:
        return dict(stats)
    return {n: total[n] + s for n, s in stats.items()}


def make_bn_recal_step(model: nn.Module, world: Optional[World] = None) -> Callable:
    """``recal(state, images) -> state``: one train-mode forward without
    gradients that moves only the BatchNorm running statistics.

    At a high learning rate the last steps of an epoch move the network
    faster than the running averages (momentum 0.9, a ~10-batch window)
    follow, so evaluation, which normalizes with them, dips; a few of these
    forwards before evaluation re-center them on the current weights.
    Over several ranks the statistics are the global batch's, as the JAX
    package's recalibration (a GSPMD forward) takes them on either route.
    """
    if world is None:
        world = data_parallel_world()

    def recal(state: TrainState, images: torch.Tensor) -> TrainState:
        model.train()
        with torch.no_grad(), global_batchnorm(model, world):
            model(images)
        return state

    return recal


def make_eval_step(model: nn.Module, label_smoothing: float = 0.0) -> Callable:
    """``eval_step(state, batch) -> {'loss', 'accuracy'}``: one inference-mode
    forward without gradients, means over the batch."""

    def eval_step(state: TrainState, batch: Tuple[torch.Tensor, torch.Tensor]):
        del state  # the model holds the parameters
        inputs, labels = batch
        model.eval()
        with torch.no_grad():
            logits = model(inputs)
            return {
                "loss": softmax_cross_entropy(logits, labels, label_smoothing),
                "accuracy": accuracy(logits, labels),
            }

    return eval_step


def make_masked_eval_step(model: nn.Module, label_smoothing: float = 0.0) -> Callable:
    """``eval_step(state, (images, labels, mask)) -> {'loss_sum', 'correct',
    'count'}``: sums over the samples whose mask is 1 (``data.eval_batches``
    pads the ragged tail with mask 0), so sums over every batch of a split
    evaluate the whole split. Device tensors: the caller reads them once."""

    def eval_step(state: TrainState, batch):
        del state  # the model holds the parameters
        images, labels, mask = batch
        model.eval()
        with torch.no_grad():
            logits = model(images)
            ce = per_sample_cross_entropy(logits, labels, label_smoothing)
            correct = (logits.argmax(dim=-1) == labels).float()
            return {
                "loss_sum": torch.sum(ce * mask),
                "correct": torch.sum(correct * mask),
                "count": torch.sum(mask),
            }

    return eval_step


def step_kind(flags: dict) -> str:
    """A step's kind in the twins' histories, from its ``KFAC.update``
    flags: ``"refresh"`` (the monolithic refresh), ``"chunk"`` or
    ``"chunk-swap"`` (a pipelined refresh chunk, the last one promoting the
    pending basis), ``"swap"`` (a slipped swap's catch-up), ``"flush"`` (a
    deferred factor flush on a step with no eigen work), ``"capture"`` or
    ``"plain"``."""
    if flags.get("update_eigen"):
        return "refresh"
    if flags.get("eigen_chunk") is not None:
        return "chunk-swap" if flags.get("swap_eigen") else "chunk"
    if flags.get("swap_eigen"):
        return "swap"
    if flags.get("flush_factors"):
        return "flush"
    return "capture" if flags.get("update_factors") else "plain"


def kfac_flags_for_step(
    step: int, kfac: Optional[KFAC], epoch: Optional[int] = None
) -> dict:
    """Host-side step gating: capture every ``fac_update_freq`` steps, refresh
    the eigenbases every ``kfac_update_freq`` steps (so step 0 refreshes).
    Under deferred factor communication the flags also carry
    ``flush_factors``: every ``factor_comm_freq``-th capture step and every
    refresh (the key is absent otherwise, as in the JAX package)."""
    if kfac is None:
        return {"update_factors": False, "update_eigen": False}
    hp = kfac.hparams
    flags = {
        "update_factors": step % hp.fac_update_freq == 0,
        "update_eigen": step % hp.kfac_update_freq == 0,
        "diag_warmup_done": epoch is None or epoch >= kfac.diag_warmup,
    }
    comm = getattr(kfac, "factor_comm", None)
    if comm is not None and comm.defer:
        flags["flush_factors"] = flags["update_eigen"] or comm.flush_due(step, hp.fac_update_freq)
    return flags
