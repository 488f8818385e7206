"""Grouped-conv K-FAC in the port against the JAX package and against itself.

* Kernel 1g's CPU route (``compute_a_conv_grouped_fused`` on CPU tensors,
  i.e. its plain version) against the JAX package's Pallas kernel run as its
  own tests run it (``interpret=True``) and against the JAX oracle
  ``factors.compute_a_conv_grouped``; the launch counter stays put on the
  CPU.
* ``compute_g_conv_grouped`` against JAX, and the three routes of
  ``dispatch_compute_a_conv_grouped``.
* K-FAC on one grouped ``KFACConv`` equals K-FAC on G explicit ungrouped
  convs carrying the same weights (factors, preconditioned gradients, ν):
  the port's twin of ``tests/test_grouped_conv.py``. Incomplete pseudo-layer
  sets are refused.

Inputs are made from seeds with numpy; activations cross the NHWC (JAX) /
NCHW (port) boundary by transposition. Tolerances: float32 products that
differ only in summation order, held to ``|got − want| ≤ rtol·max|want|``:
1e-5 for the covariances (the kernel's bound on the card), 1e-5 for the
preconditioned gradients, whose damped divide amplifies rounding by up to
1/λ, and ν to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from kfac_pytorch_tpu.ops import factor_kernels as jfk
from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
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


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------- kernel 1g, CPU route


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("ks,st,pad", [
    ((1, 1), (1, 1), "VALID"),
    ((1, 1), (2, 2), "VALID"),
    ((3, 3), (1, 1), ((1, 1), (1, 1))),
    ((3, 3), (2, 2), ((1, 1), (1, 1))),
])
@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_a_matches_pallas_and_oracle(groups, ks, st, pad, bias):
    x = np.random.RandomState(100 + groups).randn(2, 5, 5, 8).astype(np.float32)
    pallas = jax.jit(  # one compile of the G interpreted kernel calls
        lambda v: jfk.compute_a_conv_grouped_fused(v, groups, ks, st, pad, bias, interpret=True)
    )(jnp.asarray(x))
    oracle = jf.compute_a_conv_grouped(jnp.asarray(x), groups, ks, st, pad, bias)
    before = tfk.compute_a_conv_grouped_fused.launches
    got = tfk.compute_a_conv_grouped_fused(_to_nchw(x), groups, ks, st, pad, bias)
    assert tfk.compute_a_conv_grouped_fused.launches == before  # plain path
    assert got.shape == tuple(pallas.shape) and got.dtype == torch.float32
    _close_scaled(got, pallas, rtol=1e-5)
    _close_scaled(got, oracle, rtol=1e-5)
    # the port's own oracle, and kernel 1's plain version slice by slice
    _close_scaled(tf.compute_a_conv_grouped(_to_nchw(x), groups, ks, st, pad, bias),
                  oracle, rtol=1e-5)
    cg = 8 // groups
    for k in range(groups):
        np.testing.assert_array_equal(
            got[k].numpy(),
            tfk.compute_a_conv_fused_plain(
                _to_nchw(x[..., k * cg:(k + 1) * cg]), ks, st, pad, bias
            ).numpy(),
        )


@pytest.mark.parametrize("batch_averaged", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_g_matches_jax(groups, batch_averaged):
    g = np.random.RandomState(110 + groups).randn(3, 5, 5, 8).astype(np.float32)
    want = jf.compute_g_conv_grouped(jnp.asarray(g), groups, batch_averaged)
    got = tf.compute_g_conv_grouped(_to_nchw(g), groups, batch_averaged)
    assert got.shape == tuple(want.shape) == (groups, 8 // groups, 8 // groups)
    _close_scaled(got, want, rtol=1e-6)
    # each group is compute_g_conv of its own output-channel slice
    co = 8 // groups
    for k in range(groups):
        _close_scaled(got[k], tf.compute_g_conv(_to_nchw(g[..., k * co:(k + 1) * co]),
                                                batch_averaged), rtol=1e-6)


def test_grouped_a_dispatch_routes():
    x = torch.from_numpy(np.random.RandomState(120).randn(2, 8, 6, 6).astype(np.float32))
    args = (4, (3, 3), (1, 1), ((1, 1), (1, 1)), True)
    dense = tfk.dispatch_compute_a_conv_grouped(x, *args, kind="dense")
    np.testing.assert_array_equal(dense.numpy(), tf.compute_a_conv_grouped(x, *args).numpy())
    before = tfk.compute_a_conv_grouped_fused.launches
    auto = tfk.dispatch_compute_a_conv_grouped(x, *args, kind="auto")
    assert tfk.compute_a_conv_grouped_fused.launches == before
    np.testing.assert_array_equal(
        auto.numpy(), tfk.compute_a_conv_grouped_fused_plain(x, *args).numpy()
    )
    _close_scaled(auto, dense, rtol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dispatch_compute_a_conv_grouped(x, *args, kind="kernel")


# ------------------------------------- grouped K-FAC == explicit groups

B, C, H, FEAT, G = 4, 8, 6, 8, 2


class _Grouped(nn.Module):
    def __init__(self, bias):
        super().__init__()
        self.gc = KFACConv(C, FEAT, 3, padding=1, groups=G, bias=bias)
        self.head = KFACDense(FEAT, 3)

    def forward(self, x):
        return self.head(torch.relu(self.gc(x)).mean(dim=(2, 3)))


class _Explicit(nn.Module):
    def __init__(self, bias):
        super().__init__()
        self.g = nn.ModuleList(
            KFACConv(C // G, FEAT // G, 3, padding=1, bias=bias) for _ in range(G)
        )
        self.head = KFACDense(FEAT, 3)

    def forward(self, x):
        cg = C // G
        y = torch.cat([conv(x[:, k * cg:(k + 1) * cg]) for k, conv in enumerate(self.g)], dim=1)
        return self.head(torch.relu(y).mean(dim=(2, 3)))


def _tie(grouped, explicit):
    co = FEAT // G
    with torch.no_grad():
        for k, conv in enumerate(explicit.g):
            conv.weight.copy_(grouped.gc.weight[k * co:(k + 1) * co])
            if conv.bias is not None:
                conv.bias.copy_(grouped.gc.bias[k * co:(k + 1) * co])
        explicit.head.load_state_dict(grouped.head.state_dict())


def _kfac_step(model, x, lr=0.1, damping=0.01):
    """Capture + factors + eigen refresh + precondition; returns
    ``(names, kfac state, new grads, ν)``."""
    names = capture.discover_layers(model)
    kfac = KFAC(layers=names, lr=lr, damping=damping, device="cpu")
    cap = capture.Capture(model, names)
    state = kfac.init(model)
    with cap.capturing():
        (model(x) ** 2).mean().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    new, state = kfac.update(
        grads, state, a_contribs=cap.a_contribs, g_factor_stats=cap.g_factor_stats,
        lr=lr, damping=damping, update_factors=True, update_eigen=True,
    )
    nu = kfac._precondition_replicated(
        grads, names, state["eigen"], state["eigen_stacked"], lr, damping
    )[3]
    cap.remove()
    return names, state, new, nu


@pytest.mark.parametrize("bias", [False, True])
def test_grouped_kfac_matches_explicit_groups(bias):
    torch.manual_seed(130)
    grouped, explicit = _Grouped(bias), _Explicit(bias)
    _tie(grouped, explicit)
    x = torch.from_numpy(np.random.RandomState(131).randn(B, C, H, H).astype(np.float32))
    g_names, g_state, g_new, g_nu = _kfac_step(grouped, x)
    e_names, e_state, e_new, e_nu = _kfac_step(explicit, x)
    assert g_names == [f"gc#g{k}" for k in range(G)] + ["head"]
    assert e_names == [f"g.{k}" for k in range(G)] + ["head"]
    a_side, g_side = (C // G) * 9 + int(bias), FEAT // G
    co = FEAT // G
    for k in range(G):
        gf, ef = g_state["factors"][f"gc#g{k}"], e_state["factors"][f"g.{k}"]
        assert gf["A"].shape == (a_side, a_side) and gf["G"].shape == (g_side, g_side)
        for key in ("A", "G"):
            _close_scaled(gf[key], ef[key], rtol=1e-6)
        _close_scaled(g_new["gc.weight"][k * co:(k + 1) * co], e_new[f"g.{k}.weight"], rtol=1e-5)
        if bias:
            _close_scaled(g_new["gc.bias"][k * co:(k + 1) * co], e_new[f"g.{k}.bias"], rtol=1e-5)
    for key in ("head.weight", "head.bias"):
        _close_scaled(g_new[key], e_new[key], rtol=1e-5)
    np.testing.assert_allclose(float(g_nu), float(e_nu), rtol=1e-5)
    assert g_new["gc.weight"].shape == grouped.gc.weight.shape
    assert g_new["gc.weight"].is_contiguous()


def test_grouped_grad_mats_write_back_round_trip():
    model = _Grouped(True)
    names = capture.discover_layers(model)
    grads = {n: torch.randn(p.shape) for n, p in model.named_parameters()}
    mats = capture.grad_mats(capture.layer_grads(grads, names))
    assert mats["gc#g1"].shape == (FEAT // G, (C // G) * 9 + 1)
    back = capture.write_back(grads, mats, torch.tensor(1.0))
    for n, g in grads.items():
        assert torch.equal(back[n], g), n
    partial = {n: m for n, m in mats.items() if n != "gc#g0"}
    with pytest.raises(ValueError, match="1 of 2 groups"):
        capture.write_back(grads, partial, torch.tensor(1.0))


def test_incomplete_or_unexpanded_group_sets_are_refused():
    model = _Grouped(False)
    assert capture.group_counts(capture.discover_layers(model)) == {"gc": G}
    assert capture.split_group_name("a.b#g12") == ("a.b", 12)
    assert capture.split_group_name("a.b") == ("a.b", None)
    with pytest.raises(ValueError, match="pseudo-layers"):
        capture.Capture(model, ["gc#g0", "head"])
    with pytest.raises(ValueError, match="pseudo-layers"):
        KFAC(layers=["gc", "head"], device="cpu").init(model)
    with pytest.raises(ValueError, match="pseudo-layers"):
        KFAC(layers=["head#g0"], device="cpu").init(model)
