"""Fused apply kernels: eigenbasis precondition + SGD, as CUDA kernels.

Port of ``kfac_pytorch_tpu/ops/apply_kernels.py``. Two wrappers, each with
its plain PyTorch version beside it and a launch counter on the wrapper
(``fn.launches``, CUDA calls only):

* :func:`fused_precondition_stack` — for one ``[k, g, a]`` shape group,
  ``v = QG·[(QGᵀ·g·QA)/(dG dAᵀ + λ)]·QAᵀ`` plus the per-layer KL-clip
  partial ``Σ v·g`` (``csrc/fused_apply.cu``, four 3xTF32 tensor-core
  GEMM launches, replacing the TPU kernel ``fused_precondition_stack`` →
  ``_fused_apply_kernel``);
* :func:`fused_sgd_apply` — ``m' = μ·m + (g + wd·p); p' = p − lr·m'`` over
  every parameter leaf, updating params and momentum IN PLACE
  (``csrc/fused_sgd.cu``, replacing ``fused_sgd_apply`` →
  ``_fused_sgd_kernel``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``"dense"`` (:data:`APPLY_KERNELS`) keeps the JAX package's oracle
option: the einsum-chain ``precondition_all`` and the per-leaf SGD step.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

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
    """Plain PyTorch version: the same four products and the same sums."""
    t = qg.transpose(1, 2) @ gm
    t = (t @ qa) / (dg[:, :, None] * da[:, None, :] + damping)
    v = (qg @ t) @ qa.transpose(1, 2)
    return v, (v * gm).sum(dim=(1, 2))


def _damping_tensor(damping, device) -> torch.Tensor:
    if isinstance(damping, torch.Tensor):
        return damping.to(device=device, dtype=torch.float32).reshape(())
    # a fill kernel on the stream, not a host-to-device copy: no sync
    return torch.full((), float(damping), dtype=torch.float32, device=device)


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
    ``dg [k, g]``, ``damping`` a float or 0-d tensor. Returns
    ``(v [k, g, a], vg [k])`` float32.
    """
    if gm.device.type == "cpu":
        return fused_precondition_stack_plain(gm, qa, da, qg, dg, damping)
    if gm.device.type != "cuda":
        raise ValueError(f"fused_precondition_stack: unsupported device {gm.device}")
    k, g, a = gm.shape
    want = {"gm": (k, g, a), "qa": (k, a, a), "da": (k, a), "qg": (k, g, g), "dg": (k, g)}
    tensors = {"gm": gm, "qa": qa, "da": da, "qg": qg, "dg": dg}
    for key, t in tensors.items():
        if (
            t.device != gm.device
            or t.dtype != torch.float32
            or tuple(t.shape) != want[key]
        ):
            raise ValueError(
                f"fused_precondition_stack: {key} must be float32 "
                f"{want[key]} on {gm.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}"
            )
    gm, qa, da, qg, dg = (t.contiguous() for t in (gm, qa, da, qg, dg))
    lam = _damping_tensor(damping, gm.device)
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
        kernel_build.current_stream_handle(gm.device),
    )
    kernel_build.check(err, "fused_apply")
    fused_precondition_stack.launches += 1
    return out, vg


fused_precondition_stack.launches = 0

_APPLY_TILES = ("32x32", "64x64", "128x128")


def fused_apply_route(gm: torch.Tensor, qa: torch.Tensor, qg: torch.Tensor) -> Dict[str, object]:
    """What :func:`fused_precondition_stack` launches for these contiguous
    CUDA inputs: its block tile, and the ``cp.async`` copy width in bytes
    of G's, QA's and QG's rows (16 where a row starts 16-byte aligned, else
    4). The padded intermediates always take 16-byte copies."""
    k, g, a = gm.shape
    bits = kernel_build.load("fused_apply").kfac_fused_apply_route(
        k, g, a, gm.data_ptr(), qa.data_ptr(), qg.data_ptr()
    )
    return {
        "tile": _APPLY_TILES[bits & 3],
        **{name: 16 if bits & bit else 4 for name, bit in (("G", 4), ("QA", 8), ("QG", 16))},
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
    lr: float,
    momentum: float,
    weight_decay: float,
) -> None:
    """Plain PyTorch version, per leaf and in place:
    ``m = μ·m + (g + wd·p)``, ``p = p − lr·m``."""
    for p, g, m in zip(params, grads, trace):
        m.mul_(momentum).add_(g + weight_decay * p)
        p.sub_(lr * m)


def fused_sgd_apply(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    trace: Sequence[torch.Tensor],
    lr: float,
    momentum: float,
    weight_decay: float,
) -> None:
    """The whole SGD step as ONE multi-tensor launch; updates ``params`` and
    the momentum ``trace`` in place (the JAX version returns new trees).

    All leaves must be contiguous float32 tensors on one device; a leaf's
    param, grad and momentum share its shape.
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
    for p, g, m in zip(params, grads, trace):
        for t in (p, g, m):
            if (
                t.device != device
                or t.dtype != torch.float32
                or not t.is_contiguous()
                or t.shape != p.shape
            ):
                raise ValueError(
                    "fused_sgd_apply: every leaf must be a contiguous float32 "
                    f"tensor on {device} shaped like its param {tuple(p.shape)}"
                    f", got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
    n = len(params)
    ptrs = ctypes.c_void_p * n
    sizes = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    p_tab = ptrs(*(p.data_ptr() for p in params))
    g_tab = ptrs(*(g.data_ptr() for g in grads))
    m_tab = ptrs(*(m.data_ptr() for m in trace))
    lib = kernel_build.load("fused_sgd")
    err = lib.kfac_fused_sgd(
        ctypes.cast(p_tab, ctypes.c_void_p), ctypes.cast(g_tab, ctypes.c_void_p),
        ctypes.cast(m_tab, ctypes.c_void_p), ctypes.cast(sizes, ctypes.c_void_p),
        n, float(lr), float(momentum), float(weight_decay),
        kernel_build.current_stream_handle(device),
    )
    kernel_build.check(err, "fused_sgd")
    fused_sgd_apply.launches += 1


fused_sgd_apply.launches = 0


def dispatch_sgd_apply(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    trace: Dict[str, torch.Tensor],
    lr: float,
    momentum: float,
    weight_decay: float,
    *,
    kind: str,
) -> Optional[bool]:
    """Run the optimizer step through the fused kernel wrapper.

    Returns ``None`` under ``kind="dense"``: the caller then runs the plain
    per-leaf SGD, as the JAX train step runs its optax chain.
    """
    if kind == "dense":
        return None
    names = list(params)
    fused_sgd_apply(
        [params[n].detach() for n in names],
        [grads[n].detach() for n in names],
        [trace[n] for n in names],
        lr,
        momentum,
        weight_decay,
    )
    return True
