"""The bfloat16 modes of ``KFAC`` against the JAX package, on the CPU.

* ``eigen_dtype=torch.bfloat16`` at the ``KFAC.update`` level
  (``tests/test_torch_port_kfac.py``'s conv + dense net, the same factor
  statistics and gradients on both sides), for the eigen method, the
  inverse method and ``diag_blocks=2``, over a refresh step, a capture step
  on the stale basis and a plain step: the stored eigenvectors (or matrix
  inverses) are bfloat16 on both sides, stacked groups included, and
  everything else is float32; factors and eigenvalues hold to 1e-5; the
  preconditioned gradients and ν to the bounds below;
* a K-FAC embedding (diagonal A) under ``eigen_dtype=torch.bfloat16``:
  its ``dA`` (eigen) and ``iA_diag`` (inverse) stay float32 while ``QG``
  and ``iG`` are bfloat16, and the updates stay within a few bf16 steps
  of the float32 run's;
* ``precond_precision``: every name is accepted and reaches the dense
  rotations; on the CPU the three names give equal results, and equal the
  JAX package's under the same name;
* kernel 3's plain version with bfloat16 Q against the JAX Pallas kernel
  in interpret mode, fed the same bfloat16 Q, on an LM-like and a
  ResNeXt-like shape group;
* the numerical arguments of the two bf16 kernel routes, emulated in numpy:
  a bf16 × bf16 product is exact in float32 (kernel 1's bf16 MMA), and a
  bf16 value's 3xTF32 split has a zero small part (kernel 3's bf16-Q
  route drops that MMA).

Bound of the bf16 comparisons. Both packages run eigh (or the Cholesky
inverses) in float32 and round the results to bfloat16, so they store the
same bf16 matrices except where a float32 entry lies within float32 noise
of a rounding boundary: there the two differ by one bf16 step, 2⁻⁸ of the
entry. The apply multiplies by Q four times (twice by an inverse) and the
damped divide mixes eigen-directions whose scales differ by up to
``max(dG dA + λ)/λ``; the test problem's factors have well separated
spectra, so such boundary cases are rare and the updates agree to
``4·2⁻⁸`` of their largest entry (measured: 1.7e-3 for the eigen method,
2.1e-3 with blocks, 2e-7 for the inverse method, at most about half a
step), and ν, a sum over every layer, to 1e-2 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu.ops import apply_kernels as japply
from kfac_pytorch_tpu_torch import KFAC
from kfac_pytorch_tpu_torch import device as tdevice
from kfac_pytorch_tpu_torch.ops import apply_kernels as tapply
from kfac_pytorch_tpu_torch.ops import precondition as tpc
from tests.test_torch_port_kfac import LAYERS, ConvDenseNet, _jparams, _port_grad, _problem

BF16_STEP = 2.0 ** -8
UPDATE_RTOL = 4 * BF16_STEP
NU_RTOL = 1e-2
# (update_factors, update_eigen): a refresh, a capture on the stale basis, a
# plain step
STEPS = [(True, True), (True, False), (False, False)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_scaled(got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=0, atol=bound)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _run_pair(seed, jax_kw, port_kw, steps=STEPS, lr=0.1, damping=0.003):
    """Both packages' ``KFAC.update`` over ``steps`` on the same problem:
    ``[(jax grads, jax state, port grads, port state), ...]`` per step."""
    a_c, g_s, jgrads, tgrads = _problem(seed)
    jk = JKFAC(lr=lr, damping=damping, layers=[v[0] for v in LAYERS.values()], **jax_kw)
    tk = KFAC(lr=lr, damping=damping, layers=list(LAYERS), device="cpu", **port_kw)
    js, ts = jk.init(_jparams()), tk.init(ConvDenseNet())
    out = [(None, js, None, ts)]
    for upf, upe in steps:
        jnew, js = jk.update(
            jgrads, js, a_contribs={LAYERS[n][0]: jnp.asarray(v) for n, v in a_c.items()},
            g_factor_stats={LAYERS[n][0]: jnp.asarray(v) for n, v in g_s.items()},
            lr=jnp.float32(lr), damping=jnp.float32(damping), update_factors=upf,
            update_eigen=upe,
        )
        tnew, ts = tk.update(
            tgrads, ts, a_contribs={n: _t(v) for n, v in a_c.items()},
            g_factor_stats={n: _t(v) for n, v in g_s.items()},
            lr=lr, damping=damping, update_factors=upf, update_eigen=upe,
        )
        out.append((jnew, js, tnew, ts))
    return out


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested dict of tensors / arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


MODES = {
    "eigen": dict(),
    "inverse": dict(precond_method="inverse"),
    "blocks": dict(diag_blocks=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_eigen_dtype_bf16_update_matches_jax(mode):
    kw = MODES[mode]
    runs = _run_pair(150, {**kw, "eigen_dtype": jnp.bfloat16},
                     {**kw, "eigen_dtype": torch.bfloat16})
    matrix_keys = ("iA", "iG") if mode == "inverse" else ("QA", "QG")
    for step, (jnew, js, tnew, ts) in enumerate(runs):
        # storage: Q (or the inverses) bf16 in both packages, stacked groups
        # too; factors, eigenvalues and every other entry float32
        jl = _leaves({"eigen": js["eigen"], "stacked": js["eigen_stacked"]})
        tl = _leaves({"eigen": ts["eigen"], "stacked": ts["eigen_stacked"]})
        for path, leaf in tl.items():
            want = torch.bfloat16 if path.rsplit("/", 1)[1] in matrix_keys else torch.float32
            assert leaf.dtype == want, (step, path)
        for path, leaf in jl.items():
            want = jnp.bfloat16 if path.rsplit("/", 1)[1] in matrix_keys else jnp.float32
            assert leaf.dtype == want, (step, path)
        for leaf in _leaves(ts["factors"]).values():
            assert leaf.dtype == torch.float32
        if jnew is None:
            continue
        for n, (jn, _, bias) in LAYERS.items():
            for f in ("A", "G"):
                np.testing.assert_allclose(ts["factors"][n][f].numpy(),
                                           np.asarray(js["factors"][jn][f]), rtol=1e-5, atol=1e-7)
            w, b = _port_grad(tnew, n)
            _close_scaled(w, jnew[jn]["kernel"], UPDATE_RTOL)
            if bias:
                _close_scaled(b, jnew[jn]["bias"], UPDATE_RTOL)
        if mode != "inverse":
            for n, (jn, _, _) in LAYERS.items():
                te = ts["eigen"].get(n)
                if te is None:  # a stacked pair: compare through the stacks
                    continue
                for k in ("dA", "dG"):
                    np.testing.assert_allclose(np.sort(te[k].numpy()),
                                               np.sort(np.asarray(js["eigen"][jn][k])),
                                               rtol=1e-5, atol=1e-6)
            for key, te in ts["eigen_stacked"].items():
                for k in ("dA", "dG"):
                    np.testing.assert_allclose(np.sort(te[k].numpy(), axis=-1),
                                               np.sort(np.asarray(js["eigen_stacked"][key][k]),
                                                       axis=-1), rtol=1e-5, atol=1e-6)
    if mode == "blocks":  # the conv factors' eigenvectors are block-diagonal
        qa = runs[1][3]["eigen_stacked"]["4x36"]["QA"]
        assert qa.dtype == torch.bfloat16 and not qa[:, :18, 18:].any()
    if mode == "inverse":
        assert runs[1][3]["eigen"]["fc"]["iA"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["eigen", "inverse"])
def test_eigen_dtype_bf16_nu_matches_jax(mode):
    """ν from the same bf16 state in both packages (the KL clip's sum over
    every layer), and the bf16 run's updates beside the float32 run's: the
    bf16 storage moves them by a few bf16 steps, no more."""
    kw = MODES[mode]
    bf = _run_pair(151, {**kw, "eigen_dtype": jnp.bfloat16}, {**kw, "eigen_dtype": torch.bfloat16},
                   steps=STEPS[:1])
    f32 = _run_pair(151, kw, kw, steps=STEPS[:1])
    jnew, js, tnew, ts = bf[1]
    lr, damping = jnp.float32(0.1), jnp.float32(0.003)
    jk = JKFAC(lr=0.1, damping=0.003, layers=[v[0] for v in LAYERS.values()],
               eigen_dtype=jnp.bfloat16, **kw)
    tk = KFAC(lr=0.1, damping=0.003, layers=list(LAYERS), device="cpu",
              eigen_dtype=torch.bfloat16, **kw)
    _, _, _, jnu = jk._precondition_replicated(
        _problem(151)[2], list(js["factors"]), js["factors"], js["eigen"], js["eigen_stacked"],
        lr, damping)
    _, _, _, tnu = tk._precondition_replicated(
        _problem(151)[3], list(ts["factors"]), ts["eigen"], ts["eigen_stacked"], 0.1, 0.003)
    np.testing.assert_allclose(float(tnu), float(jnu), rtol=NU_RTOL)
    for n in LAYERS:
        w_bf, _ = _port_grad(tnew, n)
        w_32, _ = _port_grad(f32[1][2], n)
        _close_scaled(w_bf, w_32, 16 * BF16_STEP)


@pytest.mark.parametrize("method", ["eigen", "inverse"])
def test_eigen_dtype_bf16_keeps_the_diagonal_a_float32(method):
    """A tiny transformer LM with a K-FAC token embedding, one captured
    step: the embedding's diagonal-A entry and every eigenvalue stay
    float32, its G-side matrix and the dense layers' matrices are bf16, and
    the preconditioned gradients stay within 16 bf16 steps of the float32
    run's (the G side's rounding amplified by the damped solve)."""
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.models import transformer_lm

    r = np.random.RandomState(156)
    ids = torch.from_numpy(r.randint(0, 48, size=(2, 12)))
    tgt = torch.from_numpy(r.randint(0, 48, size=(2, 12)))
    updates = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = transformer_lm.get_model(48, max_len=12, d_model=16, n_heads=2, n_layers=1,
                                         kfac_embedding=True,
                                         generator=torch.Generator().manual_seed(0))
        cap = capture.Capture(model)
        with cap.capturing():
            logits = model(ids)
            torch.nn.functional.cross_entropy(logits.reshape(-1, 48), tgt.reshape(-1)).backward()
        kfac = KFAC(layers=capture.discover_layers(model), precond_method=method,
                    eigen_dtype=dtype, device="cpu")
        grads = {n: p.grad for n, p in model.named_parameters()}
        new, st = kfac.update(grads, kfac.init(model), a_contribs=cap.a_contribs,
                              g_factor_stats=cap.g_factor_stats, lr=0.1, damping=0.003,
                              update_factors=True, update_eigen=True)
        emb = st["eigen"]["tok_embed"]
        if method == "inverse":
            assert emb["iA_diag"].dtype == torch.float32 and emb["iG"].dtype == dtype
        else:
            assert emb["dA"].dtype == emb["dG"].dtype == torch.float32 and emb["QG"].dtype == dtype
        for path, leaf in _leaves({"e": st["eigen"], "s": st["eigen_stacked"]}).items():
            if path.rsplit("/", 1)[1] in ("QA", "QG", "iA", "iG"):
                assert leaf.dtype == dtype, path
        updates[dtype] = new
    for k, v in updates[torch.float32].items():
        _close_scaled(updates[torch.bfloat16][k].detach(), v.detach(), 16 * BF16_STEP)


@pytest.mark.parametrize("name", [None, "default", "high", "highest", "HIGH"])
def test_precond_precision_reaches_the_rotations(name, monkeypatch):
    """Each name is accepted, lower-cased, and handed to the dense rotations
    (and to the inverse method's products); the fused apply kernel's
    branch takes it only for its dense (embedding) entries."""
    seen = []
    real = tdevice.rotation_precision

    def spy(precision):
        seen.append(precision)
        return real(precision)

    monkeypatch.setattr(tpc, "rotation_precision", spy)
    for method, apply_kernel in (("eigen", "dense"), ("inverse", "auto")):
        runs = _run_pair(152, {"precond_method": method},
                         {"precond_method": method, "precond_precision": name,
                          "apply_kernel": apply_kernel}, steps=STEPS[:1])
        assert runs[1][3] is not None
    want = None if name is None else name.lower()
    assert seen and set(seen) == {want}
    assert KFAC(device="cpu", precond_precision=name).precond_precision == want
    with pytest.raises(ValueError, match="precond_precision"):
        KFAC(device="cpu", precond_precision="fastest")


@pytest.mark.parametrize("method", ["eigen", "inverse"])
def test_precond_precision_names_agree_on_the_cpu(method):
    """On the CPU the three names (and None) compute in float32: the port's
    updates are equal across them, and equal the JAX package's under the
    same name to the float32 bound of ``tests/test_torch_port_kfac.py``."""
    results = {}
    for name in (None, "default", "high", "highest"):
        runs = _run_pair(153, {"precond_method": method, "precond_precision": name},
                         {"precond_method": method, "precond_precision": name,
                          "apply_kernel": "dense"}, steps=STEPS[:2])
        results[name] = runs
        for jnew, _, tnew, _ in runs[1:]:
            for n, (jn, _, bias) in LAYERS.items():
                w, b = _port_grad(tnew, n)
                _close_scaled(w, jnew[jn]["kernel"], 1e-4)
    for name in ("default", "high", "highest"):
        for (_, _, a, _), (_, _, b, _) in zip(results[None][1:], results[name][1:]):
            for k in a:
                assert torch.equal(a[k], b[k]), (name, k)
    # the precision context restores the matmul flag it set
    before = torch.backends.cuda.matmul.allow_tf32
    with tdevice.rotation_precision("default"):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


def _bf16_apply_inputs(seed, k, g, a):
    """Group inputs with bfloat16 Q: ``(numpy float32 arrays, torch tensors)``,
    Q's float32 copy holding the bf16 values exactly."""
    r = np.random.RandomState(seed)
    gm = r.randn(k, g, a).astype(np.float32)
    qa = np.stack([np.linalg.qr(r.randn(a, a))[0] for _ in range(k)]).astype(np.float32)
    qg = np.stack([np.linalg.qr(r.randn(g, g))[0] for _ in range(k)]).astype(np.float32)
    da = (r.rand(k, a) + 0.1).astype(np.float32)
    dg = (r.rand(k, g) + 0.1).astype(np.float32)
    tq = [torch.from_numpy(q).bfloat16() for q in (qa, qg)]
    qa, qg = (q.float().numpy() for q in tq)
    return (gm, qa, da, qg, dg), (torch.from_numpy(gm), tq[0], torch.from_numpy(da), tq[1],
                                  torch.from_numpy(dg))


# an LM-like group (odd A side: a bias column) and a ResNeXt-like stack of
# narrow grouped-conv pseudo-layers (G side 4, A side 36)
@pytest.mark.parametrize("k,g,a", [(2, 24, 65), (12, 4, 36)])
def test_fused_apply_bf16_q_plain_matches_pallas(k, g, a):
    arrs, ts = _bf16_apply_inputs(154 + a, k, g, a)
    damping = 0.003
    jarrs = [jnp.asarray(x) for x in arrs]
    jarrs[1], jarrs[3] = jarrs[1].astype(jnp.bfloat16), jarrs[3].astype(jnp.bfloat16)
    v_j, vg_j = japply.fused_precondition_stack(*jarrs, jnp.float32(damping), interpret=True)
    before = tapply.fused_precondition_stack.launches
    v_t, vg_t = tapply.fused_precondition_stack(*ts, damping)
    assert tapply.fused_precondition_stack.launches == before  # the plain version
    assert ts[1].dtype == torch.bfloat16 and v_t.dtype == vg_t.dtype == torch.float32
    for i in range(k):
        _close_scaled(v_t[i], v_j[i], 1e-5)
    _close_scaled(vg_t, vg_j, 1e-5)
    # the dense oracle with bf16 Q upcasts as the plain version does
    eig = {f"l{i}": {"QA": ts[1][i], "dA": ts[2][i], "QG": ts[3][i], "dG": ts[4][i]}
           for i in range(k)}
    dense = tpc.precondition_all({f"l{i}": ts[0][i] for i in range(k)}, eig, damping)
    for i in range(k):
        _close_scaled(dense[f"l{i}"], v_j[i], 1e-5)


def _bf16_values(n, seed):
    """``n`` random finite bfloat16 values of every exponent a unit-scale
    activation takes, as float32 (exact)."""
    r = np.random.RandomState(seed)
    x = (r.randn(n) * np.exp2(r.randint(-20, 20, size=n))).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def test_bf16_products_are_exact_in_float32():
    """Kernel 1's bf16 route: each bf16 × bf16 product (8 + 8 significand
    bits) is exact in float32 (24), so one bf16 MMA with float32
    accumulation computes the float32 product of the upcast values; the
    sums of a conv A factor (4096 patch rows), taken in float32 in stages
    of 256 positions as the kernel takes them, stay within 1e-5 of the
    float64 sums: the route's 1e-5 tolerance."""
    a, b = _bf16_values(1 << 16, 155), _bf16_values(1 << 16, 156)
    prod64 = a.astype(np.float64) * b.astype(np.float64)
    assert np.array_equal(prod64.astype(np.float32).astype(np.float64), prod64)
    p = _bf16_values(4096 * 48, 157).reshape(4096, 48)
    want = p.astype(np.float64).T @ p.astype(np.float64)
    got = np.zeros((48, 48), np.float32)
    for s in range(0, 4096, 256):  # a stage's exact products, summed in float32
        blk = p[s:s + 256]
        got += (blk.astype(np.float64).T @ blk.astype(np.float64)).astype(np.float32)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-5


def _split_3xtf32(x):
    """csrc/tf32_mma.cuh's split of float32 ``x`` (numpy): ``(big, small)``."""
    bits = x.view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = ((x - big).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return big, small


def test_bf16_values_split_with_a_zero_small_part():
    """Kernel 3's bf16-Q route: every finite bfloat16 value (all 2^16 bit
    patterns but inf and NaN) is exact in TF32, so its 3xTF32 split is
    ``big = x``, ``small = 0``, and the ``small·big`` product the 3xTF32
    route adds is zero: two TF32 products per product lose nothing."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    big, small = _split_3xtf32(x)
    assert np.array_equal(big.view(np.uint32), x.view(np.uint32))
    assert not small.view(np.uint32).any()
    y = _bf16_values(1000, 158) * np.float32(1 + 2.0 ** -12)  # not bf16: a nonzero small part
    assert _split_3xtf32(y)[1].any()
