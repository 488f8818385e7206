"""Fused apply kernels: eigenbasis precondition + SGD, as CUDA kernels.

Port of ``kfac_pytorch_tpu/ops/apply_kernels.py``. Two wrappers, each with
its plain PyTorch version beside it and a launch counter on the wrapper
(``fn.launches``, CUDA calls only):

* :func:`fused_precondition_stack` — for one ``[k, g, a]`` shape group,
  ``v = QG·[(QGᵀ·g·QA)/(dG dAᵀ + λ)]·QAᵀ`` plus the per-layer KL-clip
  partial ``Σ v·g`` (``csrc/fused_apply.cu``, four 3xTF32 tensor-core
  GEMM launches, replacing the TPU kernel ``fused_precondition_stack`` →
  ``_fused_apply_kernel``); ``QA``/``QG`` in float32 or, under
  ``eigen_dtype=torch.bfloat16``, in bfloat16 (the bf16-Q route: Q read at
  half the bytes, two TF32 products per product);
* :func:`fused_sgd_apply` — ``m' = μ·m + (g + wd·p); p' = p − lr·m'`` over
  every parameter leaf, updating params and momentum IN PLACE
  (``csrc/fused_sgd.cu``, one launch for up to 896 leaves, replacing
  ``fused_sgd_apply`` → ``_fused_sgd_kernel``). ``lr`` is a float or a 0-d
  tensor; the kernel reads it from device memory, so a launch captured in
  a CUDA graph takes each replay's value. An :class:`SGDPlan` holds
  what does not change from step to step (pointers, sizes, launch tables);
  the train step keeps one, so a step's host work is over the grads only.
  The counter counts device launches.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``"dense"`` (:data:`APPLY_KERNELS`) keeps the JAX package's oracle
option: the einsum-chain ``precondition_all`` and the per-leaf SGD step.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import kernel_build

APPLY_KERNELS = ("auto", "kernel", "dense")


def resolve_apply_kernel(kind: str, device: torch.device) -> str:
    """Validate ``kind``; ``"kernel"`` needs a CUDA device."""
    if kind not in APPLY_KERNELS:
        raise ValueError(
            f"Invalid apply_kernel: {kind!r} (choose from {APPLY_KERNELS})"
        )
    if kind == "kernel" and torch.device(device).type != "cuda":
        raise ValueError(
            "apply_kernel='kernel' launches the CUDA apply kernels and needs "
            f"a CUDA device, got {device}; use 'auto' (the plain PyTorch "
            "versions on CPU tensors) or 'dense'"
        )
    return kind


# ---------------------------------------------------------------------------
# Fused eigenbasis apply: rotate → damped divide → back-rotate → Σ v·g
# ---------------------------------------------------------------------------


def fused_precondition_stack_plain(
    gm: torch.Tensor,
    qa: torch.Tensor,
    da: torch.Tensor,
    qg: torch.Tensor,
    dg: torch.Tensor,
    damping,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same four products and the same sums
    (bfloat16 Q upcast to float32 first, as the TPU kernel upcasts it)."""
    qa, qg = qa.float(), qg.float()
    t = qg.transpose(1, 2) @ gm
    t = (t @ qa) / (dg[:, :, None] * da[:, None, :] + damping)
    v = (qg @ t) @ qa.transpose(1, 2)
    return v, (v * gm).sum(dim=(1, 2))


def scalar_tensor(value, device) -> torch.Tensor:
    """``value`` (a float or a 0-d tensor) as a float32 0-d tensor on
    ``device``: a tensor already there is passed through, a float filled
    (a fill kernel on the stream, not a host-to-device copy: no sync)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def fused_precondition_stack(
    gm: torch.Tensor,
    qa: torch.Tensor,
    da: torch.Tensor,
    qg: torch.Tensor,
    dg: torch.Tensor,
    damping,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``precondition_all`` chain for one shape group.

    ``gm [k, g, a]``, ``qa [k, a, a]``, ``da [k, a]``, ``qg [k, g, g]``,
    ``dg [k, g]``, ``damping`` a float or 0-d tensor; everything float32
    but ``qa`` and ``qg``, which may both be bfloat16 (the kernel's bf16-Q
    route). Returns ``(v [k, g, a], vg [k])`` float32.
    """
    if gm.device.type == "cpu":
        return fused_precondition_stack_plain(gm, qa, da, qg, dg, damping)
    if gm.device.type != "cuda":
        raise ValueError(f"fused_precondition_stack: unsupported device {gm.device}")
    k, g, a = gm.shape
    want = {"gm": (k, g, a), "qa": (k, a, a), "da": (k, a), "qg": (k, g, g), "dg": (k, g)}
    q_dtype = torch.bfloat16 if qa.dtype == torch.bfloat16 else torch.float32
    tensors = {"gm": gm, "qa": qa, "da": da, "qg": qg, "dg": dg}
    for key, t in tensors.items():
        dtype = q_dtype if key in ("qa", "qg") else torch.float32
        if t.device != gm.device or t.dtype != dtype or tuple(t.shape) != want[key]:
            raise ValueError(
                f"fused_precondition_stack: {key} must be {dtype} "
                f"{want[key]} on {gm.device} (qa and qg both float32 or both "
                f"bfloat16), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    gm, qa, da, qg, dg = (t.contiguous() for t in (gm, qa, da, qg, dg))
    lam = scalar_tensor(damping, gm.device)
    # one buffer for the kernel's scratch: the two [k, g, a] intermediates
    # with rows padded to a multiple of 4 floats (16-byte cp.async), then
    # the per-tile KL partials (at most one per 32 x 32 tile) and one
    # counter per layer
    inter = k * g * (-(-a // 4) * 4)
    partials = k * -(-g // 32) * -(-a // 32)
    scratch = torch.empty(2 * inter + partials + k, dtype=torch.float32, device=gm.device)
    out = torch.empty_like(gm)
    vg = torch.empty((k,), dtype=torch.float32, device=gm.device)
    lib = kernel_build.load("fused_apply")
    err = lib.kfac_fused_precondition(
        gm.data_ptr(), qa.data_ptr(), da.data_ptr(), qg.data_ptr(),
        dg.data_ptr(), lam.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * inter, out.data_ptr(), vg.data_ptr(), k, g, a,
        int(q_dtype == torch.bfloat16), kernel_build.current_stream_handle(gm.device),
    )
    kernel_build.check(err, "fused_apply")
    fused_precondition_stack.launches += 1
    fused_precondition_stack.launches_bf16 += q_dtype == torch.bfloat16
    return out, vg


# every CUDA launch, and those of them on the bf16-Q route
fused_precondition_stack.launches = 0
fused_precondition_stack.launches_bf16 = 0

_APPLY_TILES = ("32x32", "64x64", "128x128")


def fused_apply_route(gm: torch.Tensor, qa: torch.Tensor, qg: torch.Tensor) -> Dict[str, object]:
    """What :func:`fused_precondition_stack` launches for these contiguous
    CUDA inputs: its block tile, and the copy width in bytes of G's, QA's
    and QG's rows (16 where a row starts 16-byte
    aligned; else a float32 row takes 4-byte ``cp.async`` copies and a
    bfloat16 row 2-byte loads). The padded intermediates always take
    16-byte copies."""
    k, g, a = gm.shape
    bf16 = qa.dtype == torch.bfloat16
    bits = kernel_build.load("fused_apply").kfac_fused_apply_route(
        k, g, a, gm.data_ptr(), qa.data_ptr(), qg.data_ptr(), int(bf16)
    )
    narrow = {"G": 4, "QA": 2 if bf16 else 4, "QG": 2 if bf16 else 4}
    return {
        "tile": _APPLY_TILES[bits & 3],
        **{name: 16 if bits & bit else narrow[name]
           for name, bit in (("G", 4), ("QA", 8), ("QG", 16))},
    }


def dispatch_precondition_stack(
    gm: torch.Tensor,
    qa: torch.Tensor,
    da: torch.Tensor,
    qg: torch.Tensor,
    dg: torch.Tensor,
    damping,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shape group's fused apply; called from the kernel branch of
    ``precondition_all_with_vg`` (the dense branch keeps the oracle chain).
    The apply consumes finished gradients, so nothing here is differentiated."""
    tel = get_telemetry()
    tel.set_gauge("kfac/apply_kernel", 1.0 if gm.is_cuda else 0.0)
    with tel.span("trace/kfac/apply_kernel"):
        return fused_precondition_stack(
            gm.detach(), qa.detach(), da.detach(), qg.detach(), dg.detach(), damping
        )


# ---------------------------------------------------------------------------
# Fused SGD: momentum + weight decay + parameter update, in place
# ---------------------------------------------------------------------------


@torch.no_grad()
def fused_sgd_apply_plain(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    trace: Sequence[torch.Tensor],
    lr,
    momentum: float,
    weight_decay: float,
) -> None:
    """Plain PyTorch version, per leaf and in place:
    ``m = μ·m + (g + wd·p)``, ``p = p − lr·m``; ``lr`` a float or a 0-d
    float32 tensor (the same bits: a float operand is rounded to float32)."""
    for p, g, m in zip(params, grads, trace):
        m.mul_(momentum).add_(g + weight_decay * p)
        p.sub_(lr * m)


# csrc/fused_sgd.cu's LeafTable capacities, in leaves; the largest keeps the
# kernel's argument (36 bytes a leaf, then the lr pointer, momentum and
# weight decay) under sm_90's 32,764-byte limit
SGD_TABLE_CAPACITIES = (64, 256, 896)
SGD_CHUNK = 4096  # elements a block of csrc/fused_sgd.cu updates
SGD_ARG_LIMIT = 32764  # bytes of kernel arguments an sm_90 kernel takes (CUDA >= 12.1)

_TABLE_TYPES: Dict[int, type] = {}


def _table_type(cap: int) -> type:
    """ctypes mirror of ``csrc/fused_sgd.cu``'s ``LeafTable<cap>``."""
    t = _TABLE_TYPES.get(cap)
    if t is None:
        fields = [
            ("p", ctypes.c_void_p * cap),
            ("g", ctypes.c_void_p * cap),
            ("m", ctypes.c_void_p * cap),
            ("n", ctypes.c_longlong * cap),
            ("first_chunk", ctypes.c_int * (cap + 1)),
            ("count", ctypes.c_int),
        ]
        t = _TABLE_TYPES[cap] = type(f"LeafTable{cap}", (ctypes.Structure,), {"_fields_": fields})
    return t


def plan_sgd_tables(sizes: Sequence[int]) -> List[Tuple[int, int, int, List[int]]]:
    """Cut a leaf set of ``sizes`` (elements per leaf, in order) into launches
    of ``csrc/fused_sgd.cu``: ``[(first leaf, leaf count, capacity, chunk
    offsets), ...]``, one per launch. A leaf of ``n`` elements takes
    ``ceil(n / SGD_CHUNK)`` chunks (an empty leaf none), numbered from 0 in
    each launch; ``chunk offsets`` has one entry per leaf and the total
    last. Launches hold up to ``max(SGD_TABLE_CAPACITIES)`` leaves each, and
    take the smallest capacity that holds theirs. A launch whose leaves are
    all empty is left out."""
    cap_max = SGD_TABLE_CAPACITIES[-1]
    out = []
    for lo in range(0, len(sizes), cap_max):
        part = sizes[lo:lo + cap_max]
        offsets = [0]
        for n in part:
            offsets.append(offsets[-1] + -(-n // SGD_CHUNK))
        if offsets[-1] == 0:
            continue
        cap = next(c for c in SGD_TABLE_CAPACITIES if c >= len(part))
        out.append((lo, len(part), cap, offsets))
    return out


def sgd_vector_leaves(p_ptrs, g_ptrs, m_ptrs) -> List[bool]:
    """Per leaf, whether ``csrc/fused_sgd.cu`` moves it in float4s: its
    param, grad and momentum all start 16-byte aligned (else the scalar
    path). The kernel makes the same test on the device."""
    return [(p | g | m) % 16 == 0 for p, g, m in zip(p_ptrs, g_ptrs, m_ptrs)]


class SGDPlan:
    """What a fused SGD launch needs that does not change from step to step,
    built once per leaf set: the param and momentum pointers, the sizes,
    the chunk offsets and the launch tables, and their checks. A call then
    checks and records only the grads (:meth:`launch`).

    The plan holds no reference to the params and momentum buffers, only a
    weak reference to each one's storage: when any of those storages is
    freed (a tensor's storage replaced by ``.data =``, ``set_`` or a
    reallocating ``resize_``, or a momentum buffer replaced and dropped),
    the plan turns :attr:`stale` and refuses to launch, so it never writes
    into memory that is no longer the tensor's. Callers rebuild it then
    (``dispatch_sgd_apply`` does). A storage replaced while something else
    keeps the old one alive is not seen: the caller who replaces storage
    builds a new plan.
    """

    def __init__(self, params: Sequence[torch.Tensor], trace: Sequence[torch.Tensor]):
        params, trace = list(params), list(trace)
        if len(params) != len(trace):
            raise ValueError("fused_sgd_apply: params and trace differ in length")
        if not params:
            raise ValueError("fused_sgd_apply: an SGD plan needs at least one leaf")
        device = params[0].device
        if device.type != "cuda":
            raise ValueError(f"fused_sgd_apply: an SGD plan needs CUDA tensors, got {device}")
        for p, m in zip(params, trace):
            for t in (p, m):
                _check_leaf(t, p.shape, device)
        self.device = device
        self.shapes = [p.shape for p in params]
        # the callbacks set a flag, not an attribute of the plan: no cycle
        # through the plan, whose weak references die with it
        freed = self._freed = [False]
        self._refs = [
            weakref.ref(t.untyped_storage(), lambda _ref: freed.__setitem__(0, True))
            for t in params + trace
        ]
        p_ptrs = [p.data_ptr() for p in params]
        m_ptrs = [m.data_ptr() for m in trace]
        sizes = [p.numel() for p in params]
        self.tables = []  # (first leaf, leaf count, capacity, ctypes table, blocks)
        for lo, k, cap, offsets in plan_sgd_tables(sizes):
            table = _table_type(cap)()
            table.p[:k] = p_ptrs[lo:lo + k]
            table.m[:k] = m_ptrs[lo:lo + k]
            table.n[:k] = sizes[lo:lo + k]
            table.first_chunk[:k + 1] = offsets
            table.count = k
            self.tables.append((lo, k, cap, table, offsets[-1]))
        self._lib = kernel_build.load("fused_sgd")
        for cap in {cap for _, _, cap, _, _ in self.tables}:
            want = self._lib.kfac_fused_sgd_table_bytes(cap)
            if want != ctypes.sizeof(_table_type(cap)):
                raise RuntimeError(
                    f"fused_sgd: the ctypes table of {cap} leaves takes "
                    f"{ctypes.sizeof(_table_type(cap))} bytes, csrc/fused_sgd.cu's {want}"
                )

    @property
    def stale(self) -> bool:
        """Whether a param or momentum storage of the plan was freed."""
        return self._freed[0]

    @property
    def launches_per_call(self) -> int:
        return len(self.tables)

    def launch(self, grads: Sequence[torch.Tensor], lr, momentum: float,
               weight_decay: float) -> None:
        """The SGD step of the plan's leaves with these grads: one launch
        per table (one for up to 896 leaves), each counted on
        ``fused_sgd_apply.launches``. ``lr`` is a 0-d tensor on the plan's
        device, which every block reads, or a float, filled into one."""
        if self.stale:
            raise ValueError(
                "fused_sgd_apply: a param or momentum storage of this SGD plan "
                "was freed or replaced since the plan was built; build a new plan"
            )
        if len(grads) != len(self.shapes):
            raise ValueError(
                f"fused_sgd_apply: {len(grads)} grads for a plan of {len(self.shapes)} leaves"
            )
        index = self.device.index
        for g, shape in zip(grads, self.shapes):
            if (g.dtype != torch.float32 or g.shape != shape or not g.is_cuda
                    or g.get_device() != index or not g.is_contiguous()):
                _check_leaf(g, shape, self.device)
        g_ptrs = [g.data_ptr() for g in grads]
        stream = kernel_build.current_stream_handle(self.device)
        lr_t = scalar_tensor(lr, self.device)
        momentum, weight_decay = float(momentum), float(weight_decay)
        for lo, k, cap, table, blocks in self.tables:
            table.g[:k] = g_ptrs[lo:lo + k]
            err = self._lib.kfac_fused_sgd(
                ctypes.addressof(table), cap, blocks, lr_t.data_ptr(), momentum, weight_decay,
                stream,
            )
            kernel_build.check(err, "fused_sgd")
            fused_sgd_apply.launches += 1


def _check_leaf(t: torch.Tensor, shape, device) -> None:
    if (
        t.device != device
        or t.dtype != torch.float32
        or not t.is_contiguous()
        or t.shape != shape
    ):
        raise ValueError(
            "fused_sgd_apply: every leaf must be a contiguous float32 "
            f"tensor on {device} shaped like its param {tuple(shape)}"
            f", got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def fused_sgd_apply(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    trace: Sequence[torch.Tensor],
    lr,
    momentum: float,
    weight_decay: float,
) -> None:
    """The whole SGD step as one multi-tensor launch (one per 896 leaves);
    updates ``params`` and the momentum ``trace`` in place (the JAX version
    returns new trees).

    All leaves must be contiguous float32 tensors on one device; a leaf's
    param, grad and momentum share its shape. CPU tensors take the plain
    version. On CUDA this builds an :class:`SGDPlan` for the one call; a
    caller that steps the same leaf set again keeps the plan and calls its
    :meth:`SGDPlan.launch`, which checks and records only the grads.
    """
    params, grads, trace = list(params), list(grads), list(trace)
    if not (len(params) == len(grads) == len(trace)):
        raise ValueError("fused_sgd_apply: params, grads and trace differ in length")
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        fused_sgd_apply_plain(params, grads, trace, lr, momentum, weight_decay)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_sgd_apply: unsupported device {device}")
    SGDPlan(params, trace).launch(grads, lr, momentum, weight_decay)


fused_sgd_apply.launches = 0


def dispatch_sgd_apply(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    trace: Dict[str, torch.Tensor],
    lr,
    momentum: float,
    weight_decay: float,
    *,
    kind: str,
    plans: Optional[Dict[str, object]] = None,
) -> Optional[bool]:
    """Run the optimizer step through the fused kernel wrapper.

    Returns ``None`` under ``kind="dense"``: the caller then runs the plain
    per-leaf SGD, as the JAX train step runs its optax chain. ``plans`` is a
    dict the caller keeps between steps: on CUDA it holds the
    :class:`SGDPlan` of this leaf set, built on the first call and rebuilt
    when it turns stale or ``trace`` is another dict.
    """
    names = list(params)
    on_cuda = params[names[0]].device.type == "cuda"
    tel = get_telemetry()
    tel.set_gauge("kfac/apply_kernel", 1.0 if kind != "dense" and on_cuda else 0.0)
    if kind == "dense":
        return None
    g = [grads[n] for n in names]
    with tel.span("trace/kfac/apply_kernel"):
        if not on_cuda:
            fused_sgd_apply_plain([params[n].detach() for n in names], g,
                                  [trace[n] for n in names], lr, momentum, weight_decay)
            return True
        plans = {} if plans is None else plans
        plan = plans.get("plan")
        if plan is None or plan.stale or plans.get("trace") is not trace:
            plan = SGDPlan([params[n].detach() for n in names], [trace[n] for n in names])
            plans.update(plan=plan, trace=trace)
        plan.launch(g, lr, momentum, weight_decay)
        return True
