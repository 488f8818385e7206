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
