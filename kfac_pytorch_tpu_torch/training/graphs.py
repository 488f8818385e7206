"""The compiled train step: one CUDA graph per step variant, replayed.

The JAX package jits its train step with the ``KFAC.update`` flags static
and the state donated (``jax.jit(step, static_argnames=..., donate_argnames=
("state",))``): one compiled program per flag set, each replayed as one
launch. :class:`GraphedTrainStep` is that step on the card. Its key is the
sorted flag tuple (the key ``compile_cache.expected_step_variants`` counts)
with the batch's shapes and dtypes; a key's first call runs the step
eagerly on a side stream (the warm-up ``torch.cuda.graphs`` asks for, which
also builds the kernels; its result is that call's result) and then
captures it into a ``torch.cuda.CUDAGraph``, every variant in one memory
pool; every later call copies its inputs into the captured buffers and
replays.

What a replay reads and writes in place: the batch buffers, the ``lr`` and
``damping`` device scalars, the model's parameters and buffers, the
momentum buffers and one set of K-FAC state tensors, the donated state.
Each variant copies the state ``KFAC.update`` returns into the donated
tensors at its end, so every variant reads and writes the same ones; a
state that arrives from elsewhere (a checkpoint restore, an eager
variant's output, a curvature-service install) is copied into them before
the replay. The metrics are copied out of the graph's buffers after it.

A variant whose step reads the host runs eagerly, by the rule of
:data:`EAGER_VARIANTS`, decided from its key before any capture; a capture
that fails raises. The kernel launch counters grow at each replay by what
the capture launched, and the ``trace/*`` spans fire at the warm-up and
the capture only (in JAX they time tracing, once per compile).

The twins (CIFAR, the transformer LM, ImageNet) decide with
:func:`eager_step_reason` whether their step is graphed at all, wrap it
with :func:`compiled_step` and record its captures with
:func:`compiled_record`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from kfac_pytorch_tpu_torch.compile_cache import expected_step_variants
from kfac_pytorch_tpu_torch.parallel import launch
from kfac_pytorch_tpu_torch.training.step import TrainState, step_kind

#: The step variants that run eagerly, each flag with the call that stops
#: its capture: a refresh or a refresh chunk decomposes the factors with
#: ``torch.linalg.eigh``, which reads cuSOLVER's ``info`` on the host after
#: the call (``at::_linalg_check_errors``): a stream synchronize, which a
#: capture refuses.
EAGER_VARIANTS: Dict[str, str] = {
    "update_eigen": "torch.linalg.eigh reads cuSOLVER's info on the host",
    "eigen_chunk": "torch.linalg.eigh reads cuSOLVER's info on the host",
}


def variant_key(flags: Dict[str, Any]) -> Tuple:
    """The step variant of ``flags``: their sorted items."""
    return tuple(sorted(flags.items()))


def eager_variant_reason(flags: Dict[str, Any]) -> Optional[str]:
    """Why the variant of ``flags`` runs eagerly (:data:`EAGER_VARIANTS`),
    or ``None`` when it is captured."""
    for flag, why in EAGER_VARIANTS.items():
        if flags.get(flag) not in (None, False):
            return f"{flag}: {why}"
    return None


def eager_step_reason(args, world, device: torch.device) -> Optional[str]:
    """Why a twin's configuration (its parsed ``args``, its ``World``, its
    device) runs the eager train step rather than :class:`GraphedTrainStep`,
    or ``None`` when the step is graphed. Decided before training, never on
    a failure: the kernels run either way. A flag the twin lacks counts as
    off."""
    if device.type != "cuda":
        return f"{device.type} device: CUDA graphs need the card"
    if world.distributed:
        return (f"a process group of {world.size} rank(s): the step's collectives (gloo "
                "stages them through host memory) are not captured")
    if getattr(args, "service_devices", 0):
        return "--service-devices: the step installs bases the service publishes"
    if getattr(args, "comm_overlap", False):
        return "--comm-overlap: a refresh chunk runs on a side stream"
    if getattr(args, "precond_method", "eigen") == "inverse":
        # measured on an H100: its replays differed from the eager step in
        # the last bit of ν (~1e-7 relative) while each part of the step,
        # captured alone, replayed bitwise; cause not found
        return "--precond-method inverse: its graphed step is not bitwise the eager one"
    return None


def compiled_step(train_step: Callable, kfac, device, why: Optional[str]):
    """``(step, budget)``: ``train_step`` graphed when ``why`` (the twin's
    :func:`eager_step_reason`) is ``None``, else ``train_step`` itself, that
    reason printed once on rank 0 either way; and the step's variant budget
    (``compile_cache.expected_step_variants``)."""
    budget = expected_step_variants(kfac)
    if why is None:
        if launch.is_primary():
            print(f"train step: CUDA graphs, one per step variant (budget {budget})")
        return GraphedTrainStep(train_step, device), budget
    if launch.is_primary():
        print(f"train step: eager ({why})")
    return train_step, budget


def compiled_record(step: "GraphedTrainStep", budget: int) -> Dict[str, object]:
    """A graphed step's captures: their count and ``budget``, each one's
    flags, milliseconds and kernel launches per replay (by wrapper name, a
    bf16 route's as ``name:bf16``), the replays, and the eagerly run
    variants' calls."""
    def launches(key):
        return {fn.__name__ + ("" if attr == "launches" else ":bf16"): n
                for (fn, attr), n in step._variants[key].launches.items()}

    return {
        "graphs": step._cache_size(),
        "capture_ms": [{"flags": dict(key[0]), "kind": step_kind(dict(key[0])), "ms": ms,
                        "launches_per_replay": launches(key)}
                       for key, ms in step.capture_ms.items()],
        "replays": step.replays,
        "eager_calls": [{"flags": dict(key), "calls": n} for key, n in step.eager_calls.items()],
        "budget": budget,
    }


def launch_counters() -> List[Tuple[Any, str]]:
    """Every kernel wrapper's launch counter, as ``(wrapper, attribute)``."""
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import flash_attention as fa

    fns = (fk.compute_a_conv_fused, fk.compute_a_conv_grouped_fused, fk.compute_a_embed_fused,
           ak.fused_precondition_stack, ak.fused_sgd_apply, fa.flash_forward,
           fa.flash_backward_dq, fa.flash_backward_dkv)
    return [(fn, attr) for fn in fns for attr in ("launches", "launches_bf16")
            if hasattr(fn, attr)]


def _flatten(tree, path=()):
    """``[(path, leaf)]`` of a nest of dicts (in key order), lists and
    tuples."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _spec(leaves):
    """The structure of flattened leaves: each path with its tensor's shape
    and dtype, or its host value (the state's ``step`` count aside)."""
    return tuple(
        (p, "tensor", tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
        else (p, "step", None, None) if p == ("step",)
        else (p, "host", repr(v), None)
        for p, v in leaves
    )


def _build(tree, values, path=()):
    """``tree``'s structure over ``values`` (a dict from path to leaf)."""
    if isinstance(tree, dict):
        return {k: _build(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_build(v, values, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return values[path]


class _Variant(NamedTuple):
    """One captured variant: the graph, the metrics it writes and the
    launches it makes per replay."""

    graph: Any
    metrics: Dict[str, torch.Tensor]
    launches: Dict[Tuple[Any, str], int]


class GraphedTrainStep:
    """``make_train_step``'s ``step_fn`` captured per variant in CUDA graphs.

    ``step(state, batch, lr, damping, **flags) -> (state, metrics)``, the
    eager step's signature: ``lr`` and ``damping`` are floats or 0-d
    tensors, copied into the step's device scalars before every call, and
    the returned state holds the donated K-FAC state and momentum tensors.
    Raises on a non-CUDA device (there is no graph to capture) and on a
    state with an fsdp part (the data×fsdp×tensor world stays eager).
    ``_cache_size()`` is the number of captured graphs, what
    ``compile_cache.RecompileMonitor`` watches."""

    def __init__(self, step_fn: Callable, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"GraphedTrainStep captures CUDA graphs and needs a CUDA device, got "
                f"{device}; call the eager step on the CPU"
            )
        self.step_fn = step_fn
        self.device = device
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.damping = torch.zeros((), dtype=torch.float32, device=device)
        self._pool = torch.cuda.graph_pool_handle()
        self._variants: Dict[Tuple, _Variant] = {}
        self._batches: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._kfac_tree = None  # the donated K-FAC state's structure
        self._kfac_spec = None
        self._kfac: Optional[List[torch.Tensor]] = None  # the donated tensors
        self._kfac_ptrs: Dict[int, int] = {}  # data_ptr -> leaf index
        self._returned = None  # the K-FAC state the last call returned
        self._opt: Optional[Dict[str, torch.Tensor]] = None
        self._storage: Optional[List[int]] = None  # params' and buffers' data_ptrs
        #: ms of each captured variant's capture, by key
        self.capture_ms: Dict[Tuple, float] = {}
        #: calls of each variant that ran eagerly by rule, by key
        self.eager_calls: Dict[Tuple, int] = {}
        self.replays = 0

    def _cache_size(self) -> int:
        return len(self._variants)

    # -- inputs ----------------------------------------------------------

    def _set_scalars(self, lr, damping) -> None:
        for dst, v in ((self.lr, lr), (self.damping, damping)):
            if isinstance(v, torch.Tensor):
                if v is not dst:
                    dst.copy_(v)
            else:
                dst.fill_(float(v))

    def _static_batch(self, sig, batch) -> Tuple[torch.Tensor, ...]:
        bufs = self._batches.get(sig)
        if bufs is None:
            bufs = self._batches[sig] = tuple(
                torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in batch)
        for dst, src in zip(bufs, batch):
            dst.copy_(src, non_blocking=True)
        return bufs

    def _adopt_kfac(self, kfac_state) -> None:
        """Copy ``kfac_state`` into the donated tensors (made, as clones of
        its tensors, on the first call) wherever a leaf is not already the
        donated tensor; a leaf that is another donated tensor is cloned
        first, so no copy reads a tensor an earlier copy wrote."""
        if kfac_state is None or kfac_state is self._returned:
            return
        leaves = _flatten(kfac_state)
        spec = _spec(leaves)
        if self._kfac is None:
            # a copy of the structure: the caller's dicts may change later
            self._kfac_tree, self._kfac_spec = _build(kfac_state, dict(leaves)), spec
            self._kfac = [v.clone(memory_format=torch.contiguous_format)
                          for _, v in leaves if isinstance(v, torch.Tensor)]
            self._kfac_ptrs = {t.data_ptr(): i for i, t in enumerate(self._kfac)}
            return
        if spec != self._kfac_spec:
            raise ValueError(
                "GraphedTrainStep: the K-FAC state's structure (its keys, tensor "
                "shapes, dtypes or host values) differs from the donated state's"
            )
        self._copy_into_donated([v for _, v in leaves if isinstance(v, torch.Tensor)])

    def _copy_into_donated(self, tensors: List[torch.Tensor]) -> None:
        pairs = []
        for i, (dst, src) in enumerate(zip(self._kfac, tensors)):
            if src is dst:
                continue
            j = self._kfac_ptrs.get(src.data_ptr())
            pairs.append((dst, src.clone() if j is not None and j != i else src))
        for dst, src in pairs:
            dst.copy_(src)

    def _donated_state(self, step: int):
        """The donated tensors in the K-FAC state's structure, at ``step``."""
        it = iter(self._kfac)
        values = {p: next(it) if kind == "tensor" else step if kind == "step" else v
                  for (p, kind, _, _), (_, v) in zip(self._kfac_spec, _flatten(self._kfac_tree))}
        return _build(self._kfac_tree, values)

    def _adopt_opt(self, opt_state) -> Dict[str, torch.Tensor]:
        if self._opt is None:
            self._opt = opt_state
        elif opt_state is not self._opt:
            if list(opt_state) != list(self._opt):
                raise ValueError("GraphedTrainStep: the momentum buffers' names changed")
            for n, t in opt_state.items():
                if t is not self._opt[n]:
                    self._opt[n].copy_(t)
        return self._opt

    def _check_storage(self, model) -> None:
        ptrs = [t.data_ptr() for t in (*model.parameters(), *model.buffers())]
        if self._storage is None:
            self._storage = ptrs
        elif ptrs != self._storage:
            raise ValueError(
                "GraphedTrainStep: a parameter or buffer of the model was reallocated "
                "since the step was captured; copy new values in place instead"
            )

    # -- the step --------------------------------------------------------

    def __call__(self, state: TrainState, batch, lr, damping, **flags):
        if state.fsdp is not None:
            raise ValueError("GraphedTrainStep: an fsdp-split state runs the eager step")
        self._set_scalars(lr, damping)
        if eager_variant_reason(flags) is not None:
            key = variant_key(flags)
            self.eager_calls[key] = self.eager_calls.get(key, 0) + 1
            return self.step_fn(state, batch, self.lr, self.damping, **flags)
        batch = tuple(batch)
        sig = tuple((tuple(t.shape), t.dtype) for t in batch)
        key = (variant_key(flags), sig)
        self._check_storage(state.model)
        kin = state.kfac_state
        self._adopt_kfac(kin)
        opt = self._adopt_opt(state.opt_state)
        static = self._static_batch(sig, batch)
        variant = self._variants.get(key)
        if variant is None:
            inner = TrainState(step=state.step, model=state.model, opt_state=opt,
                               kfac_state=None if kin is None else self._donated_state(kin["step"]))
            metrics = self._warm_up_and_capture(key, inner, static, flags)
        else:
            variant.graph.replay()
            for (fn, attr), n in variant.launches.items():
                setattr(fn, attr, getattr(fn, attr) + n)
            self.replays += 1
            metrics = variant.metrics
        self._returned = None if kin is None else self._donated_state(kin["step"] + 1)
        # out of the graph's buffers (and the donated state), which the next
        # call overwrites
        metrics = {k: v.clone() for k, v in metrics.items()}
        return TrainState(step=state.step + 1, model=state.model, opt_state=opt,
                          kfac_state=self._returned), metrics

    def _run(self, state, static, flags):
        """The step on the captured inputs, its K-FAC state written into
        the donated tensors: ``metrics``."""
        new_state, metrics = self.step_fn(state, static, self.lr, self.damping, **flags)
        if new_state.opt_state is not self._opt:
            raise ValueError("GraphedTrainStep: the step replaced the momentum buffers")
        if self._kfac is not None:
            leaves = _flatten(new_state.kfac_state)
            if _spec(leaves) != self._kfac_spec:
                raise ValueError(
                    "GraphedTrainStep: the step changed the K-FAC state's structure (its "
                    "keys, tensor shapes, dtypes or host values)")
            self._copy_into_donated([v for _, v in leaves if isinstance(v, torch.Tensor)])
        return metrics

    def _warm_up_and_capture(self, key, state, static, flags):
        """A key's first call: the step run eagerly on a side stream (this
        call's result), then captured into a graph that is not run."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self._run(state, static, flags)
        main.wait_stream(side)
        counters = launch_counters()
        before = {c: getattr(*c) for c in counters}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            captured = self._run(state, static, flags)
        capture_ms = (time.perf_counter() - t0) * 1e3
        launches = {}
        for c in counters:
            n = getattr(*c) - before[c]
            setattr(c[0], c[1], before[c])  # a capture launches nothing
            if n:
                launches[c] = n
        self._variants[key] = _Variant(graph, captured, launches)
        self.capture_ms[key] = capture_ms
        return metrics
