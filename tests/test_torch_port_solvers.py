"""The port's truncated solvers and pipelined refresh against the JAX package.

The JAX package draws its sketch Ω from threefry, which PyTorch cannot
reproduce; here the port's ``ops.rsvd.sketch_matrix`` is monkeypatched to
return the JAX sketch, so both packages run the same math on the same Ω.

* ``ops/rsvd.py``: ``batched_randomized_eigh`` (the port unpadded with
  ``Ω[:n]``, JAX zero-padded to its bucket) within 1e-5, compared as
  projectors ``Q Qᵀ`` and as ``d`` (relative to the largest); ``residual_rho``
  within 1e-6, its clip at 0 exact; the zero-pad identity ``A_pad·Ω =
  [A·Ω[:n]; 0]`` exact (in float64 on values whose sums are exact) and the
  port's padded solve within 1e-6 of its unpadded one with exactly zero pad
  rows.
* ``ops/streaming.py``: ``fold_side``, ``fold_rho`` and ``fold_replicated``
  within 1e-6 of the largest entry.
* The four Woodbury solves within 1e-5 of the largest entry, singly and
  stacked.
* ``KFAC.update`` on a conv+dense net's statistics (spectra with a clear
  gap) with ``solver_auto_threshold`` low enough that one layer truncates
  its A side only, one its G side only, one both and a stacked pair its A
  side: ``solver="rsvd"`` and ``"streaming"`` over capture and refresh
  steps, and ``eigh_chunks=3`` over a bootstrap and one interval with its
  swap, against the JAX ``KFAC.update`` on the same grads and statistics.
  Preconditioned gradients hold to ``|got − want| ≤ 1e-4·max|want|`` (the
  damped solve amplifies rounding by up to 1/λ), eigen state through its
  reconstructions ``Q diag(d) Qᵀ`` (+ ``rho (I − Q Qᵀ)``) to 1e-5 of the
  largest entry.
* Exact identities: ``solver_rank >= n`` bitwise equal to
  ``solver="eigh"``; ``eigh_chunks=1`` bitwise equal to the plain refresh;
  streaming at ``stream_drift_threshold=0`` and a refresh every step bitwise
  equal to ``rsvd``; the chunked refresh of frozen factors equal to the
  monolithic one within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu.ops import precondition as jprecond
from kfac_pytorch_tpu.ops import rsvd as jrsvd
from kfac_pytorch_tpu.ops import streaming as jstreaming
from kfac_pytorch_tpu_torch import KFAC
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
from kfac_pytorch_tpu_torch.ops import eigh as teigh
from kfac_pytorch_tpu_torch.ops import precondition as tprecond
from kfac_pytorch_tpu_torch.ops import rsvd as trsvd
from kfac_pytorch_tpu_torch.ops import streaming as tstreaming


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_sketch(monkeypatch):
    """The port's sketch replaced by the JAX package's."""
    def sketch(m, cols, device=None):
        return torch.from_numpy(np.array(jrsvd.sketch_matrix(m, cols)))
    monkeypatch.setattr(trsvd, "sketch_matrix", sketch)


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _decaying_spd(r, n, top=10.0, rate=0.6):
    """A symmetric PSD matrix with eigenvalues ``top·rate^i``: clear gaps
    at the top, so a truncated basis is well determined."""
    u, _ = np.linalg.qr(r.randn(n, n))
    d = top * rate ** np.arange(n)
    return ((u * d) @ u.T).astype(np.float32)


# ------------------------------------------------------------------ rsvd


@pytest.mark.parametrize("n,rank,rate", [(40, 6, 0.6), (200, 16, 0.8)])
def test_batched_randomized_eigh_matches_jax(jax_sketch, n, rank, rate):
    """The spectra decay so that the kept pairs and the sketch's
    oversampled ones stay far above float32 rounding, where both packages
    determine the same subspace."""
    r = np.random.RandomState(n)
    stack = np.stack([_decaying_spd(r, n, rate=rate) for _ in range(3)])
    m = teigh.bucket_size(n)
    jpad = jnp.stack([jrsvd.pad_for_rsvd(jnp.asarray(b), m) for b in stack])
    jq, jd = jrsvd.batched_randomized_eigh(jpad, rank)
    tq, td = trsvd.batched_randomized_eigh(torch.from_numpy(stack), rank)
    assert tq.shape == (3, n, rank) and td.shape == (3, rank)
    jq = np.asarray(jq)[:, :n, :].astype(np.float64)
    tq = tq.double().numpy()
    for k in range(3):
        _close(tq[k] @ tq[k].T, jq[k] @ jq[k].T, 1e-5)
        _close(td[k].numpy(), np.asarray(jd)[k], 1e-5)
    assert np.all(np.diff(td.numpy(), axis=1) >= 0)  # ascending, as eigh


def test_residual_rho_matches_jax_and_clips():
    r = np.random.RandomState(3)
    d = np.abs(r.randn(4, 6)).astype(np.float32)
    trace = (d.sum(1) + np.array([5.0, 0.5, 0.0, -1.0], np.float32)).astype(np.float32)
    for i in range(4):
        want = float(jrsvd.residual_rho(jnp.asarray(trace[i]), jnp.asarray(d[i]), 20, 6))
        got = float(trsvd.residual_rho(torch.tensor(trace[i]), torch.from_numpy(d[i]), 20, 6))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the clip: a trace below Σ d gives exactly 0
    assert float(trsvd.residual_rho(torch.tensor(1.0), torch.tensor([2.0]), 5, 1)) == 0.0
    # the denominator's floor at 1
    assert float(trsvd.residual_rho(torch.tensor(3.0), torch.tensor([1.0]), 1, 4)) == 2.0


def test_zero_pad_sketch_identity(jax_sketch):
    """``A_pad·Ω = [A·Ω[:n]; 0]``: exact where every product and partial
    sum is exact (float64, small integers times Ω rounded to 2⁻⁸), and
    the port's solve of the padded block is its unpadded solve with zero
    pad rows."""
    n, cols = 37, 12
    m = teigh.bucket_size(n)
    r = np.random.RandomState(5)
    a = r.randint(-4, 5, size=(n, n)).astype(np.float64)
    a = a + a.T
    omega = np.round(np.asarray(jrsvd.sketch_matrix(m, cols), np.float64) * 256) / 256
    pad = trsvd.pad_for_rsvd(torch.from_numpy(a), m)
    assert pad.shape == (m, m) and torch.all(pad[n:] == 0) and torch.all(pad[:, n:] == 0)
    got = pad @ torch.from_numpy(omega)
    want = torch.cat([torch.from_numpy(a) @ torch.from_numpy(omega[:n]),
                      torch.zeros(m - n, cols, dtype=torch.float64)])
    assert torch.equal(got, want)
    spd = torch.from_numpy(_decaying_spd(r, n))
    q_pad, d_pad = trsvd.batched_randomized_eigh(trsvd.pad_for_rsvd(spd, m)[None], 5)
    q, d = trsvd.batched_randomized_eigh(spd[None], 5)
    assert torch.all(q_pad[0, n:] == 0)
    _close((q_pad[0, :n] @ q_pad[0, :n].T).numpy(), (q[0] @ q[0].T).numpy(), 1e-6)
    _close(d_pad.numpy(), d.numpy(), 1e-6)


# ------------------------------------------------------------- streaming


def test_streaming_folds_match_jax():
    r = np.random.RandomState(8)
    n, rank = 30, 5
    facs = np.stack([_decaying_spd(r, n) for _ in range(2)])
    q = np.stack([np.linalg.qr(r.randn(n, rank))[0] for _ in range(2)]).astype(np.float32)
    jd, jt = jstreaming.fold_side(jnp.asarray(q), jnp.asarray(facs), 1e-10)
    td, tt = tstreaming.fold_side(torch.from_numpy(q), torch.from_numpy(facs), 1e-10)
    _close(td.numpy(), jd, 1e-6)
    _close(tt.numpy(), jt, 1e-6)
    _close(tstreaming.fold_rho(tt, td, n, rank).numpy(), jstreaming.fold_rho(jt, jd, n, rank), 1e-6)
    diag = np.array([0.5, 1e-12, 2.0], np.float32)
    assert tstreaming.fold_diag(None, torch.from_numpy(diag), 1e-6).tolist() == [0.5, 0.0, 2.0]

    # the whole split layout: a stacked truncated pair, a truncated single,
    # a dense single and an embedding (diagonal A)
    shapes = {"a": (8, n), "b": (8, n), "c": (6, n), "d": (6, 12), "e": (8, None)}
    facs, eigen = {}, {}
    for name, (g, a) in shapes.items():
        G = _decaying_spd(r, g)
        qg = np.linalg.qr(r.randn(g, g))[0].astype(np.float32)
        if a is None:
            facs[name] = {"A_diag": np.abs(r.randn(9)).astype(np.float32), "G": G}
            eigen[name] = {"dA": np.zeros(9, np.float32), "QG": qg, "dG": np.zeros(g, np.float32)}
            continue
        A = _decaying_spd(r, a)
        facs[name] = {"A": A, "G": G}
        if a == n:
            qa = np.linalg.qr(r.randn(a, rank))[0].astype(np.float32)
            eigen[name] = {"QA": qa, "dA": np.zeros(rank, np.float32),
                           "rhoA": np.float32(0), "QG": qg, "dG": np.zeros(g, np.float32)}
        else:
            eigen[name] = {"QA": np.linalg.qr(r.randn(a, a))[0].astype(np.float32),
                           "dA": np.zeros(a, np.float32), "QG": qg,
                           "dG": np.zeros(g, np.float32)}
    jsing, jstack = jprecond.split_eigen_state(
        {k: {kk: jnp.asarray(v) for kk, v in e.items()} for k, e in eigen.items()})
    tsing, tstack = tprecond.split_eigen_state(
        {k: {kk: torch.as_tensor(v) for kk, v in e.items()} for k, e in eigen.items()})
    assert list(jstack) == list(tstack) == ["8x30"]
    jf = {k: {kk: jnp.asarray(v) for kk, v in f.items()} for k, f in facs.items()}
    tf = {k: {kk: torch.from_numpy(v) for kk, v in f.items()} for k, f in facs.items()}
    js, jst, jres = jstreaming.fold_replicated(jf, jsing, jstack, 1e-10)
    ts, tst, tres = tstreaming.fold_replicated(tf, tsing, tstack, 1e-10)
    np.testing.assert_allclose(float(tres), float(jres), rtol=1e-6)
    assert 0.0 < float(tres) < 1.0
    for got, want in ((ts, js), (tst, jst)):
        assert set(got) == set(want)
        for k in want:
            assert set(got[k]) == set(want[k])
            for kk in want[k]:
                _close(got[k][kk].numpy(), want[k][kk], 1e-6)


# -------------------------------------------------------------- Woodbury


def _woodbury_case(r, g, a, rg, ra):
    def basis(n, k):
        return np.linalg.qr(r.randn(n, n))[0][:, :k].astype(np.float32)

    return dict(
        g=r.randn(g, a).astype(np.float32),
        qa=basis(a, ra), qg=basis(g, rg),
        da=np.sort(np.abs(r.randn(ra))).astype(np.float32),
        dg=np.sort(np.abs(r.randn(rg))).astype(np.float32),
        rho_a=np.float32(0.05), rho_g=np.float32(0.02),
    )


@pytest.mark.parametrize("variant", ["lowrank", "lr_g", "lr_a", "embed_lr_g"])
def test_woodbury_solves_match_jax(variant):
    r = np.random.RandomState(12)
    lam = 0.003
    g, a = 14, 20
    ra = 5 if variant in ("lowrank", "lr_a") else a
    rg = 4 if variant in ("lowrank", "lr_g", "embed_lr_g") else g
    cases = [_woodbury_case(r, g, a, rg, ra) for _ in range(3)]
    if variant == "embed_lr_g":
        for c in cases:
            c["da"] = np.abs(r.randn(a)).astype(np.float32)

    def call(mod, c, to):
        x = {k: to(v) for k, v in c.items()}
        if variant == "lowrank":
            return mod.precondition_mat_lowrank(x["g"], x["qa"], x["qg"], x["da"], x["dg"],
                                                x["rho_a"], x["rho_g"], lam)
        if variant == "lr_g":
            return mod.precondition_mat_lr_g(x["g"], x["qa"], x["qg"], x["da"], x["dg"],
                                             x["rho_g"], lam)
        if variant == "lr_a":
            return mod.precondition_mat_lr_a(x["g"], x["qa"], x["qg"], x["da"], x["dg"],
                                             x["rho_a"], lam)
        return mod.precondition_mat_embed_lr_g(x["g"], x["qg"], x["dg"], x["rho_g"],
                                               x["da"], lam)

    wants = []
    for c in cases:
        want = np.asarray(call(jprecond, c, jnp.asarray))
        _close(call(tprecond, c, torch.as_tensor).numpy(), want, 1e-5)
        wants.append(want)
    # the stacked form the shape groups take
    stacked = {k: np.stack([c[k] for c in cases]) for k in cases[0]}
    _close(call(tprecond, stacked, torch.as_tensor).numpy(), np.stack(wants), 1e-5)


# --------------------------------------------------- KFAC.update vs JAX


class SolverNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c0 = KFACConv(3, 12, 3, padding=1, bias=False)  # [12, 27]: A truncated
        self.c1 = KFACConv(12, 12, 3, padding=1, bias=False)  # [12, 108] } stacked, A
        self.c2 = KFACConv(12, 12, 3, padding=1, bias=False)  # [12, 108] } truncated
        self.fc = KFACDense(12, 16)  # [16, 13]: G truncated
        self.fc2 = KFACDense(16, 16)  # [16, 17]: both truncated


# port layer -> (JAX path, JAX kernel shape, has bias)
LAYERS = {
    "c0": ("KFACConv_0", (3, 3, 3, 12), False),
    "c1": ("KFACConv_1", (3, 3, 12, 12), False),
    "c2": ("KFACConv_2", (3, 3, 12, 12), False),
    "fc": ("KFACDense_0", (12, 16), True),
    "fc2": ("KFACDense_1", (16, 16), True),
}
SOLVER = dict(solver_rank=3, solver_auto_threshold=14)
LR, DAMPING = 0.1, 0.003


def _problem(seed):
    r = np.random.RandomState(seed)
    a_c, g_s, jgrads, tgrads = {}, {}, {}, {}
    for n, (jn, kshape, bias) in LAYERS.items():
        a_side = int(np.prod(kshape[:-1])) + int(bias)
        # gaps of 20%: the bases (and the folds through them) are well
        # determined in float32
        a_c[n] = _decaying_spd(r, a_side, rate=0.8)
        g_s[n] = _decaying_spd(r, kshape[-1], rate=0.8)
        k = r.randn(*kshape).astype(np.float32)
        jgrads[jn] = {"kernel": jnp.asarray(k)}
        w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        tgrads[f"{n}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if bias:
            b = r.randn(kshape[-1]).astype(np.float32)
            jgrads[jn]["bias"] = jnp.asarray(b)
            tgrads[f"{n}.bias"] = torch.from_numpy(b)
    return a_c, g_s, jgrads, tgrads


def _jparams():
    return {jn: {"kernel": jnp.zeros(ks), **({"bias": jnp.zeros(ks[-1])} if b else {})}
            for jn, ks, b in LAYERS.values()}


def _pair(**kw):
    common = dict(lr=LR, damping=DAMPING, factor_decay=0.5, kfac_update_freq=100, **kw)
    jk = JKFAC(layers=[v[0] for v in LAYERS.values()], **common)
    tk = KFAC(layers=list(LAYERS), device="cpu", **common)
    return jk, tk, jk.init(_jparams()), tk.init(SolverNet())


def _step(jk, tk, js, ts, problem, **flags):
    a_c, g_s, jgrads, tgrads = problem
    jnew, js = jk.update(
        jgrads, js, a_contribs={LAYERS[n][0]: jnp.asarray(v) for n, v in a_c.items()},
        g_factor_stats={LAYERS[n][0]: jnp.asarray(v) for n, v in g_s.items()},
        lr=jnp.float32(LR), damping=jnp.float32(DAMPING), **flags)
    tnew, ts = tk.update(
        tgrads, ts, a_contribs={n: torch.from_numpy(v) for n, v in a_c.items()},
        g_factor_stats={n: torch.from_numpy(v) for n, v in g_s.items()},
        lr=LR, damping=DAMPING, **flags)
    for n, (jn, _, bias) in LAYERS.items():
        w = tnew[f"{n}.weight"].numpy()
        _close(w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T, jnew[jn]["kernel"], 1e-4)
        if bias:
            _close(tnew[f"{n}.bias"].numpy(), jnew[jn]["bias"], 1e-4)
    return js, ts


def _full_eigen(state, names):
    """Per-layer entries from the split layout: a stack's rows are its
    shape's layers in name order."""
    out = {n: dict(e) for n, e in state["eigen"].items()}
    for key, group in state["eigen_stacked"].items():
        members = [n for n in names if n not in out and
                   f"{state['factors'][n]['G'].shape[0]}x{state['factors'][n]['A'].shape[0]}" == key]
        for row, n in enumerate(members):
            out[n] = {k: v[row] for k, v in group.items()}
    return out


def _reconstruct(e, side):
    q = np.asarray(e[f"Q{side}"], np.float64)
    d = np.asarray(e[f"d{side}"], np.float64)
    f = (q * d) @ q.T
    if f"rho{side}" in e:
        f += float(e[f"rho{side}"]) * (np.eye(q.shape[0]) - q @ q.T)
    return f


def _assert_eigen_close(js, ts):
    jnames = [v[0] for v in LAYERS.values()]
    jfull = _full_eigen(js, jnames)
    tfull = _full_eigen(ts, list(LAYERS))
    for n, (jn, _, _) in LAYERS.items():
        assert set(tfull[n]) == set(jfull[jn]), n
        for side in ("A", "G"):
            assert tfull[n][f"Q{side}"].shape == jfull[jn][f"Q{side}"].shape
            _close(_reconstruct(tfull[n], side), _reconstruct(jfull[jn], side), 1e-5)


@pytest.mark.parametrize("solver", ["rsvd", "streaming"])
def test_kfac_update_truncated_solvers_match_jax(jax_sketch, solver):
    jk, tk, js, ts = _pair(solver=solver, **SOLVER)
    full = {n: e for n, e in ts["eigen"].items()}
    assert "rhoA" in full["c0"] and "rhoG" not in full["c0"]
    assert "rhoG" in full["fc"] and "rhoA" not in full["fc"]
    assert "rhoA" in full["fc2"] and "rhoG" in full["fc2"]
    assert "rhoA" in ts["eigen_stacked"]["12x108"] and ts["eigen_stacked"]["12x108"]["QA"].shape == (2, 108, 3)
    schedule = [(True, True), (True, False), (False, False), (True, False), (True, True), (True, False)]
    for i, (upf, upe) in enumerate(schedule):
        js, ts = _step(jk, tk, js, ts, _problem(40 + i), update_factors=upf, update_eigen=upe)
        _assert_eigen_close(js, ts)
        np.testing.assert_allclose(float(ts["spectrum_mass"]), float(js["spectrum_mass"]), rtol=1e-5)
        if solver == "streaming":
            np.testing.assert_allclose(float(ts["stream_residual"]),
                                       float(js["stream_residual"]), rtol=1e-5, atol=1e-7)
            assert int(ts["stream_fold_steps"]) == int(js["stream_fold_steps"])
    assert 0.0 < float(ts["spectrum_mass"]) < 1.0


def test_kfac_update_chunked_refresh_matches_jax():
    """A bootstrap refresh, then one 3-chunk interval with the swap on its
    last chunk, through the port and JAX; the diagnostics ride along."""
    jk, tk, js, ts = _pair(eigh_chunks=3, track_diagnostics=True)
    assert set(ts["eigen_pending"]) == set(LAYERS)
    js, ts = _step(jk, tk, js, ts, _problem(50), update_factors=True, update_eigen=True)
    for c in range(3):
        js, ts = _step(jk, tk, js, ts, _problem(51 + c), update_factors=True,
                       update_eigen=False, eigen_chunk=(c, 3), swap_eigen=c == 2)
        _assert_eigen_close(js, ts)
    for key in ("min_damped_eig", "max_damped_eig"):
        np.testing.assert_allclose(float(ts["diagnostics"][key]),
                                   float(js["diagnostics"][key]), rtol=1e-5)
    assert int(ts["diagnostics"]["eigen_stale_steps"]) == 0


def test_kfac_update_chunked_rsvd_with_slip_matches_jax(jax_sketch):
    """Chunks of the randomized refresh; the last chunk withholds its swap
    (bounded staleness) and a bare swap lands it."""
    jk, tk, js, ts = _pair(eigh_chunks=2, solver="rsvd", staleness_budget=2, **SOLVER)
    js, ts = _step(jk, tk, js, ts, _problem(60), update_factors=True, update_eigen=True)
    js, ts = _step(jk, tk, js, ts, _problem(61), update_factors=True, update_eigen=False,
                   eigen_chunk=(0, 2))
    js, ts = _step(jk, tk, js, ts, _problem(62), update_factors=False, update_eigen=False,
                   eigen_chunk=(1, 2), swap_eigen=False)
    assert int(ts["eigen_swap_slip"]) == int(js["eigen_swap_slip"]) == 1
    js, ts = _step(jk, tk, js, ts, _problem(63), update_factors=False, update_eigen=False,
                   swap_eigen=True)
    assert int(ts["eigen_swap_slip"]) == 0
    _assert_eigen_close(js, ts)
    np.testing.assert_allclose(float(ts["spectrum_mass"]), float(js["spectrum_mass"]), rtol=1e-5)


# ------------------------------------------------------ exact identities


def _run(tk, problems, schedule):
    ts = tk.init(SolverNet())
    outs = []
    for p, flags in zip(problems, schedule):
        a_c, g_s, _, tgrads = p
        new, ts = tk.update(
            tgrads, ts, a_contribs={n: torch.from_numpy(v) for n, v in a_c.items()},
            g_factor_stats={n: torch.from_numpy(v) for n, v in g_s.items()},
            lr=LR, damping=DAMPING, **flags)
        outs.append(new)
    return outs, ts


def _assert_bitwise(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_full_rank_solver_is_bitwise_eigh():
    problems = [_problem(70 + i) for i in range(3)]
    schedule = [dict(update_factors=True, update_eigen=e) for e in (True, False, True)]
    kw = dict(lr=LR, damping=DAMPING, layers=list(LAYERS), device="cpu")
    eigh_out, eigh_state = _run(KFAC(**kw), problems, schedule)
    k = KFAC(solver="rsvd", solver_rank=200, solver_auto_threshold=1, **kw)
    assert k._rank_fn() is not None and all(
        k._rank_for(n) is None for n in (12, 13, 16, 17, 27, 108))
    out, state = _run(k, problems, schedule)
    _assert_bitwise(out, eigh_out)
    for key in ("factors", "eigen", "eigen_stacked"):
        _assert_bitwise(state[key], eigh_state[key])
    assert float(state["spectrum_mass"]) == 1.0


def test_one_chunk_is_bitwise_the_plain_refresh():
    problems = [_problem(80 + i) for i in range(2)]
    schedule = [dict(update_factors=True, update_eigen=True)] * 2
    kw = dict(lr=LR, damping=DAMPING, layers=list(LAYERS), device="cpu")
    base, base_state = _run(KFAC(**kw), problems, schedule)
    one, one_state = _run(KFAC(eigh_chunks=1, **kw), problems, schedule)
    _assert_bitwise(one, base)
    _assert_bitwise(one_state, base_state)
    assert "eigen_pending" not in one_state


def test_streaming_threshold_zero_is_bitwise_rsvd():
    problems = [_problem(90 + i) for i in range(3)]
    schedule = [dict(update_factors=True, update_eigen=True)] * 3
    kw = dict(lr=LR, damping=DAMPING, layers=list(LAYERS), device="cpu", **SOLVER)
    r_out, r_state = _run(KFAC(solver="rsvd", **kw), problems, schedule)
    s_out, s_state = _run(KFAC(solver="streaming", stream_drift_threshold=0.0, **kw),
                          problems, schedule)
    _assert_bitwise(s_out, r_out)
    for key in ("factors", "eigen", "eigen_stacked", "spectrum_mass"):
        _assert_bitwise(s_state[key], r_state[key])
    np.testing.assert_allclose(float(s_state["stream_residual"]),
                               max(1.0 - float(s_state["spectrum_mass"]), 0.0), rtol=1e-6)


@pytest.mark.parametrize("solver", ["eigh", "rsvd"])
def test_chunked_refresh_of_frozen_factors_equals_monolithic(solver):
    kw = dict(lr=LR, damping=DAMPING, layers=list(LAYERS), device="cpu",
              solver=solver, **SOLVER)
    p = _problem(100)
    capture = dict(update_factors=True, update_eigen=True)
    _, mono = _run(KFAC(**kw), [p, p], [capture, dict(update_factors=False, update_eigen=True)])
    chunked = [dict(update_factors=False, update_eigen=False, eigen_chunk=(c, 4),
                    swap_eigen=c == 3) for c in range(4)]
    _, piped = _run(KFAC(eigh_chunks=4, **kw), [p] * 5, [capture] + chunked)
    for key in ("eigen", "eigen_stacked"):
        for n, e in mono[key].items():
            for k, v in e.items():
                _close(piped[key][n][k].numpy() if not k.startswith("Q") else
                       (piped[key][n][k] @ piped[key][n][k].transpose(-1, -2)).numpy(),
                       v.numpy() if not k.startswith("Q") else
                       (v @ v.transpose(-1, -2)).numpy(), 1e-6)


def test_update_guards():
    k = KFAC(device="cpu", eigh_chunks=2)
    state = k.init(SolverNet())
    grads = {n: torch.zeros_like(p) for n, p in SolverNet().named_parameters()}
    with pytest.raises(ValueError, match="mutually exclusive"):
        k.update(grads, state, lr=0.1, update_factors=False, update_eigen=True, eigen_chunk=(0, 2))
    with pytest.raises(ValueError, match="Invalid eigen_chunk"):
        k.update(grads, state, lr=0.1, update_factors=False, update_eigen=False, eigen_chunk=(2, 2))
    with pytest.raises(ValueError, match="rides the final chunk"):
        k.update(grads, state, lr=0.1, update_factors=False, update_eigen=False, swap_eigen=True)
    with pytest.raises(ValueError, match="eigh_chunks > 1"):
        KFAC(device="cpu").update(grads, KFAC(device="cpu").init(SolverNet()), lr=0.1,
                                  update_factors=False, update_eigen=False, eigen_chunk=(0, 2))


@pytest.mark.parametrize("kwargs,message", [
    (dict(eigh_chunks=2, precond_method="inverse"), "no spike"),
    (dict(solver="rsvd", precond_method="inverse"), "Woodbury"),
    (dict(solver="rsvd", diag_blocks=2), "pick one approximation"),
    (dict(solver="streaming", eigh_chunks=2), "streaming_vs_chunks"),
    (dict(solver="streaming", staleness_budget=1), "streaming_vs_swap_slip"),
    (dict(staleness_budget=1), "has none of them"),
    (dict(solver="qr"), "Invalid solver"),
    (dict(solver_rank=0), "Invalid solver_rank"),
    (dict(solver_auto_threshold=0), "Invalid solver_auto_threshold"),
    (dict(stream_drift_threshold=-1.0), "Invalid stream_drift_threshold"),
    (dict(staleness_budget=-1), "Invalid staleness_budget"),
    (dict(eigh_chunks=0), "Invalid eigh chunk count"),
])
def test_lever_validation_matches_jax(kwargs, message):
    with pytest.raises(ValueError, match=message) as tinfo:
        KFAC(device="cpu", **kwargs)
    with pytest.raises(ValueError) as jinfo:
        JKFAC(**kwargs)
    assert str(tinfo.value) == str(jinfo.value)
