"""The port's core math against the JAX package, function by function.

Covers ``kfac_pytorch_tpu_torch/ops/factors.py``, ``ops/eigh.py``,
``parallel/sharded_eigh.py`` and ``ops/precondition.py``. Every input is
made from a seed with numpy and fed to both packages; activations cross
the NHWC (JAX) / NCHW (port) boundary by transposition, factor-space
matrices ``[out, in·kh·kw(+1)]`` compare as they are.

Tolerances: both sides are float32 on the CPU and the products differ only
in summation order. A sum with cancellation has no useful per-entry
relative error, so matrix products are held to an absolute bound scaled to
the result: ``|got − want| ≤ rtol·max|want|`` with rtol 1e-6 (a few ulps of
the largest entry; 1e-5 after a division by damped eigenvalues, which
amplifies rounding by up to 1/λ). Eigenvectors are not unique (sign,
degenerate subspaces), so eigen results compare through the factors they
reconstruct and through preconditioned gradients, never ``Q`` itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops import eigh as jeigh
from kfac_pytorch_tpu.ops import factor_kernels as jfk
from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu.ops import precondition as jp
from kfac_pytorch_tpu.parallel import sharded_eigh as jse
from kfac_pytorch_tpu_torch.ops import eigh as teigh
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk
from kfac_pytorch_tpu_torch.ops import factors as tf
from kfac_pytorch_tpu_torch.ops import precondition as tp
from kfac_pytorch_tpu_torch.parallel import sharded_eigh as tse


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_scaled(got, want, rtol=1e-6):
    """``|got − want| ≤ rtol·max|want|`` elementwise (see module docstring)."""
    want = np.asarray(want)
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


def _nhwc(r, shape):
    return r.randn(*shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _spd(r, n):
    m = r.randn(n, n + 3).astype(np.float32)
    return (m @ m.T / (n + 3)).astype(np.float32)


def _orth(r, n):
    q, _ = np.linalg.qr(r.randn(n, n))
    return q.astype(np.float32)


# ------------------------------------------------------------ factors.py


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead", [(6,), (3, 4)])
def test_compute_a_dense(lead, bias):
    x = np.random.RandomState(1).randn(*lead, 7).astype(np.float32)
    _close_scaled(tf.compute_a_dense(torch.from_numpy(x), bias), jf.compute_a_dense(jnp.asarray(x), bias))


CONV_CASES = [
    # (NHWC shape, kernel, strides, padding, dilation, bias)
    ((3, 8, 8, 4), (3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), False),
    ((3, 8, 8, 4), (3, 3), (2, 2), ((1, 1), (1, 1)), (1, 1), True),
    ((2, 7, 9, 3), (1, 1), (1, 1), "VALID", (1, 1), True),
    ((2, 9, 9, 3), (3, 3), (2, 2), "SAME", (1, 1), False),
    ((2, 8, 8, 2), (3, 3), (1, 1), ((1, 2), (0, 1)), (1, 1), True),
    ((2, 11, 11, 2), (3, 3), (1, 1), "SAME", (2, 2), False),
]


@pytest.mark.parametrize("shape,ks,st,pad,dil,bias", CONV_CASES)
def test_compute_a_conv(shape, ks, st, pad, dil, bias):
    x = _nhwc(np.random.RandomState(2), shape)
    want = jf.compute_a_conv(jnp.asarray(x), ks, st, pad, bias, kernel_dilation=dil)
    got = tf.compute_a_conv(_to_nchw(x), ks, st, pad, bias, kernel_dilation=dil)
    _close_scaled(got, want)


@pytest.mark.parametrize("shape,ks,st,pad,dil,bias", CONV_CASES)
def test_resolve_padding(shape, ks, st, pad, dil, bias):
    _, h, w, _ = shape
    assert tfk._resolve_padding(h, w, ks, st, pad, dil) == jfk._resolve_padding(
        h, w, ks, st, pad, dil
    )


@pytest.mark.parametrize("ba", [False, True])
def test_compute_g_dense(ba):
    g = np.random.RandomState(3).randn(5, 6).astype(np.float32)
    _close_scaled(tf.compute_g_dense(torch.from_numpy(g), ba), jf.compute_g_dense(jnp.asarray(g), ba))


@pytest.mark.parametrize("ba", [False, True])
def test_compute_g_conv(ba):
    g = _nhwc(np.random.RandomState(4), (3, 5, 4, 6))
    _close_scaled(tf.compute_g_conv(_to_nchw(g), ba), jf.compute_g_conv(jnp.asarray(g), ba))


def test_update_running_avg_is_code_semantics():
    r = np.random.RandomState(5)
    new, cur = (r.randn(4, 4).astype(np.float32) for _ in range(2))
    got = tf.update_running_avg(torch.from_numpy(new), torch.from_numpy(cur), 0.95)
    # bitwise: the same two products and one sum, rounded alike
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jf.update_running_avg(jnp.asarray(new), jnp.asarray(cur), 0.95))
    )


@pytest.mark.parametrize("bias", [False, True])
def test_grads_to_mat_and_back_conv(bias):
    r = np.random.RandomState(6)
    hwio = r.randn(3, 3, 4, 5).astype(np.float32)
    b = r.randn(5).astype(np.float32)
    jg = {"kernel": jnp.asarray(hwio)}
    tg = {"weight": torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))}
    if bias:
        jg["bias"], tg["bias"] = jnp.asarray(b), torch.from_numpy(b)
    mat = tf.grads_to_mat(tg)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jf.grads_to_mat(jg)))
    back = tf.mat_to_grads(mat, tg["weight"].shape, bias)
    np.testing.assert_array_equal(back["weight"].numpy(), tg["weight"].numpy())
    if bias:
        np.testing.assert_array_equal(back["bias"].numpy(), b)
    jback = jf.mat_to_grads(jnp.asarray(mat.numpy()), hwio.shape, bias)
    np.testing.assert_array_equal(
        np.asarray(jback["kernel"]).transpose(3, 2, 0, 1), back["weight"].numpy()
    )


def test_grads_to_mat_and_back_dense():
    r = np.random.RandomState(7)
    w_io, b = r.randn(6, 3).astype(np.float32), r.randn(3).astype(np.float32)
    tg = {"weight": torch.from_numpy(np.ascontiguousarray(w_io.T)), "bias": torch.from_numpy(b)}
    mat = tf.grads_to_mat(tg)
    np.testing.assert_array_equal(
        mat.numpy(), np.asarray(jf.grads_to_mat({"kernel": jnp.asarray(w_io), "bias": jnp.asarray(b)}))
    )
    back = tf.mat_to_grads(mat, (3, 6), True)
    np.testing.assert_array_equal(back["weight"].numpy(), w_io.T)
    assert back["weight"].is_contiguous() and back["bias"].is_contiguous()


# ------------------------------------------------------------ eigh.py


def test_symmetrize():
    x = np.random.RandomState(8).randn(2, 5, 5).astype(np.float32)
    np.testing.assert_array_equal(
        teigh.symmetrize(torch.from_numpy(x)).numpy(), np.asarray(jeigh.symmetrize(jnp.asarray(x)))
    )


def test_eigh_with_floor_reconstructs_and_floors():
    r = np.random.RandomState(9)
    m = r.randn(6, 3).astype(np.float32)
    f = (m @ m.T).astype(np.float32)  # rank 3: three ~1e-7 eigenvalues
    qj, dj = jeigh.eigh_with_floor(jnp.asarray(f), eps=1e-4)
    qt, dt = teigh.eigh_with_floor(torch.from_numpy(f), eps=1e-4)
    _close(dt, dj, rtol=1e-5, atol=1e-5)
    assert int((dt == 0).sum()) == int((np.asarray(dj) == 0).sum()) == 3
    recon_t = (qt * dt) @ qt.T
    recon_j = (np.asarray(qj) * np.asarray(dj)) @ np.asarray(qj).T
    _close(recon_t, recon_j, rtol=1e-5, atol=1e-5)
    _close(recon_t, f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("index,count,shape", [(0, 1, (5, 5)), (1, 3, (7, 7)), (2, 3, (7, 9))])
def test_get_block_boundary(index, count, shape):
    assert teigh.get_block_boundary(index, count, shape) == jeigh.get_block_boundary(
        index, count, shape
    )


@pytest.mark.parametrize("index,count,shape", [(3, 3, (5, 5)), (0, 6, (5, 5))])
def test_get_block_boundary_refusals(index, count, shape):
    with pytest.raises(ValueError):
        jeigh.get_block_boundary(index, count, shape)
    with pytest.raises(ValueError):
        teigh.get_block_boundary(index, count, shape)


# ------------------------------------------------------- sharded_eigh.py


def test_replicated_eigen_update_matches_jax():
    """Per-size batched eigh (port) vs −1-padded bucketed eigh (JAX): the same
    spectra and the same reconstructed factors."""
    r = np.random.RandomState(10)
    sizes = {"a": (9, 4), "b": (9, 4), "c": (5, 3)}
    facs = {n: {"A": _spd(r, a), "G": _spd(r, g)} for n, (a, g) in sizes.items()}
    je = jse.replicated_eigen_update(
        {n: {k: jnp.asarray(v) for k, v in f.items()} for n, f in facs.items()},
        {n: 1 for n in facs},
    )
    te = tse.replicated_eigen_update(
        {n: {k: torch.from_numpy(v) for k, v in f.items()} for n, f in facs.items()},
        {n: 1 for n in facs},
    )
    assert list(te) == list(je)
    for n in facs:
        assert list(te[n]) == list(je[n]) == ["QA", "dA", "QG", "dG"]
        for side in ("A", "G"):
            q, d = te[n][f"Q{side}"], te[n][f"d{side}"]
            _close(d, je[n][f"d{side}"], rtol=1e-5, atol=1e-6)
            _close((q * d) @ q.T, facs[n][side], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ precondition.py


def _eigen_entry(r, g, a):
    return {
        "QA": _orth(r, a), "dA": (r.rand(a) + 0.1).astype(np.float32),
        "QG": _orth(r, g), "dG": (r.rand(g) + 0.1).astype(np.float32),
    }


def _both(tree):
    j = {n: {k: jnp.asarray(v) for k, v in e.items()} for n, e in tree.items()}
    t = {n: {k: torch.from_numpy(v) for k, v in e.items()} for n, e in tree.items()}
    return j, t


def _problem(seed=11):
    """Layers with a stacked group (two 4x9), and singletons."""
    r = np.random.RandomState(seed)
    shapes = {"c0": (4, 9), "c1": (4, 9), "c2": (3, 5), "fc": (2, 7)}
    eig = {n: _eigen_entry(r, g, a) for n, (g, a) in shapes.items()}
    gm = {n: r.randn(g, a).astype(np.float32) for n, (g, a) in shapes.items()}
    return eig, gm


def test_precondition_mat():
    eig, gm = _problem()
    e = eig["c2"]
    want = jp.precondition_mat(jnp.asarray(gm["c2"]), *(jnp.asarray(e[k]) for k in ("QA", "QG", "dA", "dG")), 0.03)
    got = tp.precondition_mat(torch.from_numpy(gm["c2"]), *(torch.from_numpy(e[k]) for k in ("QA", "QG", "dA", "dG")), 0.03)
    _close_scaled(got, want, rtol=1e-5)


def test_shape_groups_and_split_eigen_state():
    eig, _ = _problem()
    shapes = {n: (e["QG"].shape[0], e["QA"].shape[0]) for n, e in eig.items()}
    assert tp.shape_groups(shapes) == jp.shape_groups(shapes)
    je, te = _both(eig)
    js, jst = jp.split_eigen_state(je)
    ts, tst = tp.split_eigen_state(te)
    assert sorted(ts) == sorted(js) and list(tst) == list(jst) == ["4x9"]
    for k in ("QA", "dA", "QG", "dG"):
        np.testing.assert_array_equal(tst["4x9"][k].numpy(), np.asarray(jst["4x9"][k]))


@pytest.mark.parametrize("use_stacked", [False, True])
def test_precondition_all(use_stacked):
    eig, gm = _problem()
    je, te = _both(eig)
    jst = jp.split_eigen_state(je)[1] if use_stacked else None
    tst = tp.split_eigen_state(te)[1] if use_stacked else None
    want = jp.precondition_all({n: jnp.asarray(g) for n, g in gm.items()}, je, 0.03, stacked=jst)
    got = tp.precondition_all({n: torch.from_numpy(g) for n, g in gm.items()}, te, 0.03, stacked=tst)
    assert list(got) == list(want)
    for n in gm:
        _close_scaled(got[n], want[n], rtol=1e-5)


@pytest.mark.parametrize("kind", ["auto", "dense"])
def test_precondition_all_with_vg_and_kl_clip(kind):
    """The port's kernel route (plain version on CPU tensors) and its dense
    route against the JAX dense route + kl_clip_coefficient; kl_clip_from_vg
    against the same coefficient."""
    eig, gm = _problem(12)
    je, te = _both(eig)
    jg = {n: jnp.asarray(g) for n, g in gm.items()}
    tg = {n: torch.from_numpy(g) for n, g in gm.items()}
    want, jvg = jp.precondition_all_with_vg(jg, je, 0.03)
    assert jvg is None  # JAX dense scope
    nu_want = jp.kl_clip_coefficient(want, jg, jnp.float32(0.1), 0.001)
    got, vg_terms = tp.precondition_all_with_vg(tg, te, 0.03, kind=kind)
    for n in gm:
        _close_scaled(got[n], want[n], rtol=1e-5)
    nu_dense = tp.kl_clip_coefficient(got, tg, 0.1, 0.001)
    _close(nu_dense, nu_want, rtol=1e-5, atol=0)
    if kind == "dense":
        assert vg_terms is None
    else:
        assert len(vg_terms) == len(gm)
        _close(tp.kl_clip_from_vg(vg_terms, 0.1, 0.001), nu_want, rtol=1e-5, atol=0)
        jnu = jp.kl_clip_from_vg(
            [jnp.sum(want[n] * jg[n]) for n in got], jnp.float32(0.1), 0.001
        )
        _close(jnu, nu_want, rtol=1e-6, atol=0)
