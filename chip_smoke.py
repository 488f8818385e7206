#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (any failure raises: the script exits non-zero and prints
no result line):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``kfac_pytorch_tpu_torch/csrc/``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the inputs the
   main path gives it (ResNet-32, batch 128, 32×32 images) and time, with
   CUDA events, the kernel, the plain version and one PyTorch library call
   for the same function (a yardstick only; the port never calls it);
4. train ResNet-32 at its published widths on synthetic data through the
   trainer's entry point (lr 0.1, momentum 0.9, wd 5e-4, stat-decay 0.95,
   damping 0.003, kl-clip 0.001, cov-freq 1, kfac-update-freq 10) with the
   kernels' launch counters zeroed just before and read just after; the
   loss must be finite and falling and every counter above 0. The same
   loop with ``--kfac-update-freq 0`` gives plain SGD's step time;
5. the same training with ``--factor-kernel dense --apply-kernel dense``
   (the oracle paths) must match the kernel run's first losses;
6. print one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BATCH = 128
STEPS = 30
MODEL = "resnet32"
TIMING_REPS = 20


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(calls):
    """Least time for ``[(bytes, flops), ...]`` calls: per call the larger of
    bytes over the memory rate and FLOPs over the float32 peak, summed."""
    t_bytes = sum(b / PEAK_BYTES for b, _ in calls)
    t_flops = sum(f / PEAK_F32_FLOPS for _, f in calls)
    total = sum(max(b / PEAK_BYTES, f / PEAK_F32_FLOPS) for b, f in calls)
    return total * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def scaled_err(got, want):
    """``(max |got − want|, that over max |want|)``."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def conv_a_phase(model, images):
    """Kernel 1 on every conv input of one ResNet-32 forward at batch 128."""
    import torch
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.models.layers import KFACConv
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    calls = []
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, inp: calls.append(
                (inp[0].detach().contiguous(), mod.kernel_size, mod.stride,
                 mod.factor_padding(), mod.bias is not None, mod.dilation)
            )
        )
        for m in model.modules() if isinstance(m, KFACConv)
    ]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()

    tol = 1e-5
    worst_abs = worst_rel = 0.0
    for c in calls:
        err, rel = scaled_err(fk.compute_a_conv_fused(*c), fk.compute_a_conv_fused_plain(*c))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    if not worst_rel <= tol:
        raise AssertionError(f"conv A kernel disagrees with its plain version: rel {worst_rel:.3e} > {tol}")

    def library():
        for x, ks, st, pad, _, dil in calls:
            cols = F.unfold(x, ks, dilation=dil, padding=pad[0][0], stride=st)
            p = cols.transpose(1, 2).reshape(-1, cols.shape[1])
            p.T @ p

    work = []
    for x, ks, st, pad, bias, dil in calls:
        fp = x.shape[1] * ks[0] * ks[1] + int(bias)
        h_out = (x.shape[2] + 2 * pad[0][0] - ks[0]) // st[0] + 1
        w_out = (x.shape[3] + 2 * pad[1][0] - ks[1]) // st[1] + 1
        rows = x.shape[0] * h_out * w_out
        # symmetric output: fp·(fp+1)/2 distinct sums of `rows` products
        work.append((4 * (x.numel() + fp * fp), rows * fp * (fp + 1)))
    b_ms, b_by = bound_ms(work)
    return {
        "name": "patch_cov (conv A factor)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/patch_cov.cu",
        "replaces": "kfac_pytorch_tpu/ops/factor_kernels.py:251",
        "unit": f"{len(calls)} conv A factors of one capture step",
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": f"|kernel - plain| <= {tol} * max|plain| per conv",
        "ms": time_ms(lambda: [fk.compute_a_conv_fused(*c) for c in calls]),
        "plain_ms": time_ms(lambda: [fk.compute_a_conv_fused_plain(*c) for c in calls]),
        "library_ms": time_ms(library),
        "library": "F.unfold + torch.matmul per conv",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def apply_phase(model, device):
    """Kernel 3 on every shape group of ResNet-32's K-FAC layers."""
    import torch

    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import precondition as pc

    kfac = KFAC(layers=capture.discover_layers(model), device=device)
    facs = kfac._identity_factors(model)
    shapes = {n: (f["G"].shape[0], f["A"].shape[0]) for n, f in facs.items()}
    gen = torch.Generator(device=device).manual_seed(0)

    def orth(k, n):
        q, _ = torch.linalg.qr(torch.randn(k, n, n, device=device, generator=gen))
        return q.contiguous()

    groups = []
    for (g, a), names in pc.shape_groups(shapes).items():
        k = len(names)
        groups.append((
            torch.randn(k, g, a, device=device, generator=gen),
            orth(k, a),
            torch.rand(k, a, device=device, generator=gen) + 0.1,
            orth(k, g),
            torch.rand(k, g, device=device, generator=gen) + 0.1,
        ))
    lam = torch.full((), 0.003, device=device)
    tol = 1e-4
    worst_abs = worst_rel = 0.0
    for grp in groups:
        v, vg = ak.fused_precondition_stack(*grp, lam)
        v_p, vg_p = ak.fused_precondition_stack_plain(*grp, lam)
        for got, want in ((v, v_p), (vg, vg_p)):
            err, rel = scaled_err(got, want)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    if not worst_rel <= tol:
        raise AssertionError(f"fused apply kernel disagrees with its plain version: rel {worst_rel:.3e} > {tol}")

    def library():
        for gm, qa, da, qg, dg in groups:
            t = torch.matmul(torch.matmul(qg.transpose(1, 2), gm), qa)
            t = t / (dg[:, :, None] * da[:, None, :] + lam)
            torch.matmul(torch.matmul(qg, t), qa.transpose(1, 2))

    work = []
    for gm, qa, da, qg, dg in groups:
        k, g, a = gm.shape
        flops = k * (4 * g * a * (g + a) + 3 * g * a + 2 * g * a)
        nbytes = 4 * (2 * k * g * a + k * a * a + k * g * g + k * a + k * g + k + 1)
        work.append((nbytes, flops))
    b_ms, b_by = bound_ms(work)
    return {
        "name": "fused_apply (eigenbasis precondition + KL partial)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/fused_apply.cu",
        "replaces": "kfac_pytorch_tpu/ops/apply_kernels.py:190",
        "unit": f"{len(groups)} shape groups ({len(shapes)} layers) of one step",
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": f"|kernel - plain| <= {tol} * max|plain| per group (v and vg)",
        "ms": time_ms(lambda: [ak.fused_precondition_stack(*grp, lam) for grp in groups]),
        "plain_ms": time_ms(lambda: [ak.fused_precondition_stack_plain(*grp, lam) for grp in groups]),
        "library_ms": time_ms(library),
        "library": "batched torch.matmul chain per group",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def sgd_phase(model, device):
    """Kernel 4 over every parameter leaf of ResNet-32."""
    import torch

    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak

    gen = torch.Generator(device=device).manual_seed(1)
    params = [p.detach().clone() for p in model.parameters()]
    grads = [torch.randn(p.shape, device=device, generator=gen) for p in params]
    trace = [torch.randn(p.shape, device=device, generator=gen) for p in params]
    lr, mu, wd = 0.1, 0.9, 5e-4
    kp, km = [p.clone() for p in params], [m.clone() for m in trace]
    pp, pm = [p.clone() for p in params], [m.clone() for m in trace]
    ak.fused_sgd_apply(kp, grads, km, lr, mu, wd)
    ak.fused_sgd_apply_plain(pp, grads, pm, lr, mu, wd)
    worst_abs = worst_rel = 0.0
    for got, want in zip(kp + km, pp + pm):
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    tol = 1e-6
    if not worst_rel <= tol:
        raise AssertionError(f"fused SGD kernel disagrees with its plain version: rel {worst_rel:.3e} > {tol}")

    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    opt = torch.optim.SGD(lib_params, lr=lr, momentum=mu, weight_decay=wd, foreach=True)
    for p, g, m in zip(lib_params, grads, trace):
        p.grad = g
        opt.state[p]["momentum_buffer"] = m.clone()
    n = sum(p.numel() for p in params)
    b_ms, b_by = bound_ms([(20 * n, 4 * n)])
    return {
        "name": "fused_sgd (momentum + weight decay, in place)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "kfac_pytorch_tpu/ops/apply_kernels.py:325",
        "unit": f"one SGD step over {len(params)} leaves ({n} params)",
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": f"|kernel - plain| <= {tol} * |plain| per element",
        "ms": time_ms(lambda: ak.fused_sgd_apply(kp, grads, km, lr, mu, wd)),
        "plain_ms": time_ms(lambda: ak.fused_sgd_apply_plain(pp, grads, pm, lr, mu, wd)),
        "library_ms": time_ms(opt.step),
        "library": "torch.optim.SGD(foreach=True).step",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def train(extra):
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    return trainer.main([
        "--synthetic", "--model", MODEL, "--batch-size", str(BATCH), "--epochs", "1",
        "--steps-per-epoch", str(STEPS), "--seed", "0", "--device", "cuda", *extra,
    ])


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("CUDA is not available: the port's main path runs on an NVIDIA GPU")
    try:
        from kfac_pytorch_tpu_torch.device import use_ieee_f32
        from kfac_pytorch_tpu_torch.models import cifar_resnet
        from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
        from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
        from kfac_pytorch_tpu_torch.ops import kernel_build
        from kfac_pytorch_tpu_torch.training.data import synthetic_batches
    except ImportError as e:
        return _fail(f"the port is not importable ({e}); run from the repository root")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    use_ieee_f32()

    # 2. build
    secs = kernel_build.build_all()
    print(f"build: {secs:.1f} s for {len(kernel_build.SIGNATURES)} kernels (nvcc, sm_90a)", flush=True)

    # 3. kernels against their plain versions, at the main path's shapes
    model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)).to(device)
    xb, _ = next(synthetic_batches(BATCH, (3, 32, 32), 10, 1, seed=0))
    images = torch.from_numpy(xb).to(device)
    kernels = [conv_a_phase(model, images), apply_phase(model, device), sgd_phase(model, device)]
    for k in kernels:
        print(f"kernel {k['name']}: max_rel_err {k['max_rel_err']:.3e}, "
              f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library {k['library_ms']:.4f}, "
              f"bound {k['bound_ms']:.4f} by {k['bound_by']})", flush=True)

    # 4. the main path through the trainer, counters zeroed just before
    counted = (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply)
    for fn in counted:
        fn.launches = 0
    hist = train([])
    launches = [fn.launches for fn in counted]
    losses = hist["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first:.4f}, last-5 mean {last:.4f}")
    for k, n in zip(kernels, launches):
        if n <= 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
        k["launches"] = n
        k["launches_per_step"] = n / STEPS
        k["kernel_ms"] = k["ms"]
    sgd = train(["--kfac-update-freq", "0"])
    ms = hist["step_ms"][1:]  # step 0 pays first-call set-up (cuSOLVER, caches)
    kinds = hist["kind"][1:]
    capture_ms = statistics.median(m for m, k in zip(ms, kinds) if k == "capture")
    refresh_ms = statistics.median(m for m, k in zip(ms, kinds) if k == "refresh")
    sgd_ms = statistics.median(sgd["step_ms"][1:])
    print(json.dumps({
        "main_path": f"{MODEL} batch {BATCH}, {STEPS} steps, synthetic 32x32x3",
        "loss_first5": first, "loss_last5": last,
        "step0_ms": hist["step_ms"][0],
        "capture_step_ms_median": capture_ms,
        "refresh_step_ms_median": refresh_ms,
        "images_per_s": BATCH * len(ms) / (sum(ms) / 1e3),
        "sgd_step_ms_median": sgd_ms,
        "sgd_images_per_s": BATCH * len(sgd["step_ms"][1:]) / (sum(sgd["step_ms"][1:]) / 1e3),
        "kfac_over_sgd_mean_step": (sum(ms) / len(ms)) / statistics.mean(sgd["step_ms"][1:]),
        "launches": launches,
    }), flush=True)

    # 5. the kernel path against the oracle paths on the first steps
    dense = train(["--factor-kernel", "dense", "--apply-kernel", "dense"])
    for i in range(5):
        a, b = losses[i], dense["loss"][i]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"step {i}: kernel-path loss {a} vs oracle-path loss {b}")
    print(f"oracle paths: first 5 losses agree to 1e-3 relative "
          f"(max diff {max(abs(a - b) for a, b in zip(losses[:5], dense['loss'][:5])):.3e})", flush=True)

    # 6. results
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
