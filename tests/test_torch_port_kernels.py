"""The port's three kernels: plain versions against the JAX Pallas kernels,
and the routing rules.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold that arithmetic to the JAX package's Pallas kernels run as that
package's own tests run them (``interpret=True``), on the same numpy
inputs. The CUDA kernels themselves are held to these plain versions on a
GPU by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances: float32 on both sides, different summation orders. Products
are held to ``|got − want| ≤ rtol·max|want|`` (cancellation makes per-entry
relative error meaningless): rtol 2e-6 for the covariances, 1e-5 for the
apply, whose damped divide amplifies rounding by up to 1/λ. The SGD update
is elementwise with the same rounding steps: 1e-6 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops import apply_kernels as japply
from kfac_pytorch_tpu.ops import factor_kernels as jfk
from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu_torch.ops import apply_kernels as tapply
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk
from kfac_pytorch_tpu_torch.ops import factors as tf


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_scaled(got, want, rtol):
    want = np.asarray(want)
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


# ----------------------------------------------------------- kernel 1: conv A

CONV_CASES = [
    # (NHWC shape, kernel, strides, padding, bias)
    ((3, 8, 8, 4), (1, 1), (1, 1), "VALID", False),
    ((3, 8, 8, 4), (1, 1), (2, 2), "VALID", True),
    ((3, 8, 8, 4), (3, 3), (1, 1), ((1, 1), (1, 1)), True),
    ((3, 9, 9, 4), (3, 3), (2, 2), ((1, 1), (1, 1)), False),
]


@pytest.mark.parametrize("shape,ks,st,pad,bias", CONV_CASES)
def test_conv_a_plain_matches_pallas_and_oracle(shape, ks, st, pad, bias):
    x = np.random.RandomState(20).randn(*shape).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    pallas = jfk.compute_a_conv_fused(jnp.asarray(x), ks, st, pad, bias, interpret=True)
    oracle = jf.compute_a_conv(jnp.asarray(x), ks, st, pad, bias)
    before = tfk.compute_a_conv_fused.launches
    got = tfk.compute_a_conv_fused(xt, ks, st, pad, bias)
    assert tfk.compute_a_conv_fused.launches == before  # plain path: no launch
    assert got.shape == tuple(pallas.shape) and got.dtype == torch.float32
    _close_scaled(got, pallas, rtol=2e-6)
    _close_scaled(got, oracle, rtol=2e-6)
    np.testing.assert_array_equal(
        got.numpy(), tfk.compute_a_conv_fused_plain(xt, ks, st, pad, bias).numpy()
    )


def test_conv_a_dispatch_routes():
    x = torch.from_numpy(np.random.RandomState(21).randn(2, 3, 6, 6).astype(np.float32))
    args = ((3, 3), (1, 1), ((1, 1), (1, 1)), False)
    dense = tfk.dispatch_compute_a_conv(x, *args, kind="dense")
    np.testing.assert_array_equal(dense.numpy(), tf.compute_a_conv(x, *args).numpy())
    auto = tfk.dispatch_compute_a_conv(x, *args, kind="auto")
    np.testing.assert_array_equal(auto.numpy(), tfk.compute_a_conv_fused_plain(x, *args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dispatch_compute_a_conv(x, *args, kind="kernel")
    with pytest.raises(ValueError, match="Invalid factor_kernel"):
        tfk.dispatch_compute_a_conv(x, *args, kind="pallas")


def test_conv_a_3xtf32_keeps_float32_accuracy():
    """Kernel 1's numerical scheme, emulated over ResNet-32's longest
    reduction (its first conv: 131072 patch rows, F = 27, post-ReLU-like
    inputs), in the kernel's order on a 132-SM card: each stage's 256 rows
    summed on the tensor cores in 3xTF32 into a fresh fragment, the stage
    sums added in float32 four to a row split, the 128 split partials added
    in split order. The whole sum stays within 1e-6 of float64, 10x inside
    the card's 1e-5 tolerance. Per stage, the tensor cores' own sums are
    within 1e-6 in 3xTF32, and at least 10x worse with one TF32 product,
    which breaks that tolerance. (Over all 131072 rows one TF32 product's
    unbiased input rounding largely averages out, to within a small,
    data-dependent factor of the float32 adds' error: the per-stage sums
    are where it shows.)"""
    from tests.test_torch_port_flash import _mm_1xtf32, _mm_3xtf32

    r = np.random.RandomState(24)
    x = torch.from_numpy(np.maximum(r.randn(128, 3, 32, 32), 0).astype(np.float32))
    patches, _, _ = tf.extract_patches(x, (3, 3), (1, 1), ((1, 1), (1, 1)))
    stages = patches.reshape(-1, 256, 27)  # 8 output rows of 32 per stage
    ref_stages = stages.double().transpose(1, 2) @ stages.double()

    def stage_err(mm):
        got = mm(stages.transpose(1, 2), stages).double()
        scale = ref_stages.abs().amax(dim=(1, 2))
        return float(((got - ref_stages).abs().amax(dim=(1, 2)) / scale).max())

    sums = _mm_3xtf32(stages.transpose(1, 2), stages).reshape(128, 4, 27, 27)
    part = sums[:, 0]
    for k in range(1, 4):
        part = part + sums[:, k]
    total = part[0]
    for s in range(1, 128):
        total = total + part[s]
    ref = ref_stages.sum(dim=0)
    assert float((total.double() - ref).abs().max() / ref.abs().max()) <= 1e-6
    three, one = stage_err(_mm_3xtf32), stage_err(_mm_1xtf32)
    assert three <= 1e-6
    assert one >= 10 * three and one > 1e-5


# -------------------------------------------------------- kernel 3: fused apply


def _orth(r, n):
    q, _ = np.linalg.qr(r.randn(n, n))
    return q.astype(np.float32)


def _apply_inputs(seed, k, g, a):
    r = np.random.RandomState(seed)
    gm = r.randn(k, g, a).astype(np.float32)
    qa = np.stack([_orth(r, a) for _ in range(k)])
    qg = np.stack([_orth(r, g) for _ in range(k)])
    da = (r.rand(k, a) + 0.1).astype(np.float32)
    dg = (r.rand(k, g) + 0.1).astype(np.float32)
    return gm, qa, da, qg, dg


@pytest.mark.parametrize("k,g,a", [(1, 8, 9), (3, 4, 37), (2, 10, 65)])
def test_fused_apply_plain_matches_pallas(k, g, a):
    arrs = _apply_inputs(k * 100 + a, k, g, a)
    damping = 0.03
    v_j, vg_j = japply.fused_precondition_stack(
        *(jnp.asarray(x) for x in arrs), jnp.float32(damping), interpret=True
    )
    before = tapply.fused_precondition_stack.launches
    v_t, vg_t = tapply.fused_precondition_stack(*(torch.from_numpy(x) for x in arrs), damping)
    assert tapply.fused_precondition_stack.launches == before
    assert v_t.shape == (k, g, a) and vg_t.shape == (k,)
    for i in range(k):
        _close_scaled(v_t[i], v_j[i], rtol=1e-5)
    _close_scaled(vg_t, vg_j, rtol=1e-5)


def _chain(gm, qa, da, qg, dg, damping, mm):
    """Kernel 3's four products, each taken by ``mm``, with the damped
    divide and the KL partial: ``(v, vg)``."""
    t = mm(mm(qg.transpose(1, 2), gm), qa) / (dg[:, :, None] * da[:, None, :] + damping)
    v = mm(mm(qg, t), qa.transpose(1, 2))
    return v, (v * gm).sum(dim=(1, 2))


def test_fused_apply_3xtf32_keeps_float32_accuracy():
    """Kernel 3's numerical scheme, emulated at the longest A side the paths
    give it (a = 2049: the LM's 2048-wide MLP input with its bias, and
    ResNeXt's classifier): with every product in 3xTF32, v and vg stay
    within 1e-5 of the largest float64 entry, 10x inside the card's 1e-4
    tolerance, as IEEE float32 products do; one TF32 product is at least
    10x worse and breaks that tolerance. The emulation rounds its float32
    sums, as the kernel does when it adds each 32-deep step's tensor-core
    sum on the CUDA cores. The bases are Gaussian with orthonormal-sized
    entries (a QR of 2049² would cost seconds; the chain does not rely on
    orthogonality)."""
    from tests.test_torch_port_flash import _mm_1xtf32, _mm_3xtf32

    r = np.random.RandomState(23)
    k, g, a = 1, 64, 2049
    arrs = [
        r.randn(k, g, a).astype(np.float32),
        (r.randn(k, a, a) / np.sqrt(a)).astype(np.float32),
        (r.rand(k, a) + 0.1).astype(np.float32),
        (r.randn(k, g, g) / np.sqrt(g)).astype(np.float32),
        (r.rand(k, g) + 0.1).astype(np.float32),
    ]
    damping = 0.003
    ts = [torch.from_numpy(x) for x in arrs]
    ref = _chain(*(x.double() for x in ts), damping, lambda x, y: x @ y)

    def err(mm):
        return max(float((got.double() - want).abs().max() / want.abs().max())
                   for got, want in zip(_chain(*ts, damping, mm), ref))

    plain = max(float((got.double() - want).abs().max() / want.abs().max())
                for got, want in zip(tapply.fused_precondition_stack(*ts, damping), ref))
    three, one = err(_mm_3xtf32), err(_mm_1xtf32)
    assert plain <= 1e-5
    assert three <= 1e-5
    assert one >= 10 * three and one > 1e-4


def test_kernel_builds_follow_their_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any ``csrc/`` header that the
    source includes (directly or through another header) is newer; a
    header it does not include leaves it alone."""
    from kfac_pytorch_tpu_torch.ops import kernel_build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", build)
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "other.cuh").write_text("#pragma once\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    assert kernel_build._stale("k")  # never built
    lib = kernel_build.library_path("k")
    lib.write_text("")
    assert sorted(p.name for p in kernel_build._inputs("k")) == ["inner.cuh", "k.cu", "outer.cuh"]

    def touch(path, when):
        os.utime(path, (when, when))

    for path in csrc.iterdir():
        touch(path, 1000)
    touch(lib, 2000)
    assert not kernel_build._stale("k")
    touch(csrc / "other.cuh", 3000)
    assert not kernel_build._stale("k")
    touch(csrc / "inner.cuh", 3000)
    assert kernel_build._stale("k")
    touch(lib, 4000)
    touch(csrc / "k.cu", 5000)
    assert kernel_build._stale("k")
    # the port's own sources: flash attention, the fused apply and the conv
    # A factors share the tensor-core header
    monkeypatch.undo()
    for name in ("flash_attention", "fused_apply", "patch_cov"):
        assert "tf32_mma.cuh" in {p.name for p in kernel_build._inputs(name)}


def test_apply_kernel_resolution():
    assert tapply.resolve_apply_kernel("auto", torch.device("cpu")) == "auto"
    assert tapply.resolve_apply_kernel("dense", torch.device("cpu")) == "dense"
    with pytest.raises(ValueError, match="CUDA"):
        tapply.resolve_apply_kernel("kernel", torch.device("cpu"))
    with pytest.raises(ValueError, match="Invalid apply_kernel"):
        tapply.resolve_apply_kernel("pallas", torch.device("cpu"))


# ---------------------------------------------------------- kernel 4: fused SGD


def _sgd_inputs(seed):
    r = np.random.RandomState(seed)
    shapes = {"conv": (4, 3, 3, 3), "bn_scale": (4,), "bn_bias": (4,), "fc": (5, 4), "fc_b": (5,)}
    make = lambda: {n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}  # noqa: E731
    return make(), make(), make()  # params, grads, a non-zero momentum trace


def test_fused_sgd_plain_matches_pallas_and_optax():
    params, grads, trace = _sgd_inputs(30)
    lr, mu, wd = 0.1, 0.9, 5e-4
    jp_, jm_ = japply.fused_sgd_apply(
        {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in grads.items()},
        {n: jnp.asarray(v) for n, v in trace.items()},
        jnp.float32(lr), mu, wd, interpret=True,
    )
    # the optax chain the fused kernel replaces (make_sgd: decay, trace, −lr)
    tx = jmake_sgd(mu, wd)
    state = tx.init({n: jnp.asarray(v) for n, v in params.items()})
    state = (state[0], state[1]._replace(trace={n: jnp.asarray(v) for n, v in trace.items()}))
    upd, _ = tx.update(
        {n: jnp.asarray(v) for n, v in grads.items()}, state,
        {n: jnp.asarray(v) for n, v in params.items()},
    )
    names = list(params)
    tp_ = [torch.from_numpy(params[n].copy()) for n in names]
    tm_ = [torch.from_numpy(trace[n].copy()) for n in names]
    before = tapply.fused_sgd_apply.launches
    tapply.fused_sgd_apply(tp_, [torch.from_numpy(grads[n]) for n in names], tm_, lr, mu, wd)
    assert tapply.fused_sgd_apply.launches == before
    for i, n in enumerate(names):
        np.testing.assert_allclose(tp_[i].numpy(), np.asarray(jp_[n]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm_[i].numpy(), np.asarray(jm_[n]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tp_[i].numpy(), params[n] - lr * np.asarray(upd[n]), rtol=1e-6, atol=1e-7
        )


def test_dispatch_sgd_dense_declines():
    p = {"w": torch.ones(3)}
    assert tapply.dispatch_sgd_apply(p, {"w": torch.ones(3)}, {"w": torch.zeros(3)}, 0.1, 0.9, 0.0, kind="dense") is None
    assert torch.equal(p["w"], torch.ones(3))
