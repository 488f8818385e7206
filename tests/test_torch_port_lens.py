"""The transformer LM's extras: the QKV expand lens, remat and dropout.

Against the JAX package, on a tiny LM (d_model 32, 2 heads, 2 layers,
vocab 64, T 16, a K-FAC token embedding) whose weights are carried over
with ``interop.lm_state_dict_from_jax``:

* the expand lens (``qkv_lens``): the layer names (``blocks.{i}.qkv#s0..2``,
  ``interop.lm_layer_name_from_jax`` of the JAX names); one captured
  forward/backward's A and G statistics and weight gradients against
  JAX's ``capture.a_contribs``/``g_factors`` (with and without remat);
  ``KFAC.update`` under the eigen and the inverse methods against JAX's on
  a lensed projection; three K-FAC train steps of the lensed LM against
  JAX's, to ``test_torch_port_lm.py``'s bounds (loss 1e-5 relative, every
  parameter ``2e-5·max|jax| + 1e-6``); the shape groups of the apply; a
  checkpoint round trip of the ``#s`` names;
* the lens under every lever the port carries that the JAX package lets
  compose with it: the JAX KFAC takes ``#sK`` pseudo-layers as ordinary
  layers everywhere outside capture and init (its lens branches are
  ``preconditioner.py:912,1343-1400,1743``), so on 2 gloo ranks the lensed
  net is held to its unfused oracle (three narrow layers) under the
  round-robin refresh, the bf16 deferred factor wire, owner shards, the
  pipelined refresh, the rsvd solver, the inverse method and the
  distributed apply; an owner state's ``#s`` names through a checkpoint
  and a replicated one re-homed;
* remat: the port with remat is bitwise equal to itself without, in
  factors, gradients and parameters after two K-FAC steps; each A is
  computed once per capture step (``compute_a_dense`` and the token-count
  dispatch counted);
* dropout: at 0 the train forward matches JAX; in eval mode the model is
  deterministic and equals the JAX ``train=False`` forward at dropout 0.1;
  training with dropout needs a generator; at 0.1, remat on and off give
  bitwise equal gradients and leave the generator in the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.models.layers import KFAC_ACTS, PERTURBATIONS
from kfac_pytorch_tpu.ops import factors as jfactors
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import lm_layer_name_from_jax, lm_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.models.layers import KFACDense
from kfac_pytorch_tpu_torch.ops import factor_kernels, factors
from kfac_pytorch_tpu_torch.ops import precondition as precond_ops
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
    softmax_cross_entropy,
)
from tests import torch_dist_workers as workers

VOCAB, D_MODEL, HEADS, LAYERS, SEQ, BATCH, STEPS = 64, 32, 2, 2, 16, 2, 3
LR, MOMENTUM, WD, CLIP = 0.1, 0.9, 1e-5, 0.25
HP = dict(factor_decay=0.95, damping=0.003, kl_clip=0.001,
          fac_update_freq=1, kfac_update_freq=2)
MODEL_KW = dict(max_len=SEQ, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
                kfac_embedding=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_lm(seed, **kw):
    model = jlm.get_model(VOCAB, **MODEL_KW, **kw)
    init = jnp.zeros((BATCH, SEQ), jnp.int32)
    # jitted: one compile costs less than the eager ops' first dispatches
    params = jax.jit(lambda k, x: model.init(k, x, train=True))(jax.random.PRNGKey(seed), init)
    return model, init, params["params"]


def _port_lm(params, **kw):
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kw)
    model.load_state_dict(lm_state_dict_from_jax(_np_tree(params)))  # strict
    return model


def _tokens(seed, n=1):
    r = np.random.RandomState(seed)
    return [(r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32),
             r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)) for _ in range(n)]


def _t64(a):
    return torch.from_numpy(a.astype(np.int64))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()) + 1e-6, err_msg=err_msg)


# ------------------------------------------------------------ the expand lens


def test_lens_layer_names_and_refusals():
    with pytest.raises(ValueError, match="lens_splits=2 must divide features=9"):
        KFACDense(4, 9, lens_splits=2)
    jmodel, init, _ = _jax_lm(0, qkv_lens=True)
    jnames = jcapture.discover_layers(jmodel, init, train=True)
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=True)
    names = capture.discover_layers(model)
    assert sorted(map(lm_layer_name_from_jax, jnames)) == sorted(names)
    assert [n for n in names if "qkv" in n] == [
        f"blocks.{i}.qkv#s{k}" for i in range(LAYERS) for k in range(3)]
    assert capture.layer_base("blocks.0.qkv#s2") == "blocks.0.qkv"
    assert capture.lens_counts(names) == {f"blocks.{i}.qkv": 3 for i in range(LAYERS)}
    with pytest.raises(ValueError, match="lens-split"):  # a partial set
        capture.Capture(model, [n for n in names if n != "blocks.1.qkv#s1"])
    with pytest.raises(ValueError, match="lens-split"):  # the unsplit name
        KFAC(layers=["blocks.0.qkv"], device="cpu").init(model)


def test_lens_write_back_round_trip_is_contiguous():
    """Split and stacked back, a lensed layer's gradients come back equal
    and contiguous: the fused SGD kernel takes contiguous leaves only (a
    strided bias view of the stacked updates was refused on the card)."""
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=True)
    names = capture.discover_layers(model)
    grads = {n: torch.randn(p.shape) for n, p in model.named_parameters()}
    mats = capture.grad_mats(capture.layer_grads(grads, names, {"tok_embed"}))
    assert mats["blocks.0.qkv#s1"].shape == (D_MODEL, D_MODEL + 1)
    back = capture.write_back(grads, mats, torch.tensor(1.0), {"tok_embed"})
    for n, g in grads.items():
        assert torch.equal(back[n], g) and back[n].is_contiguous(), n
    with pytest.raises(ValueError, match="1 of 3 splits"):
        capture.write_back(grads, {"blocks.0.qkv#s2": mats["blocks.0.qkv#s2"]}, torch.tensor(1.0))


@pytest.mark.parametrize("remat", [False, True])
def test_lens_capture_matches_jax(remat):
    """One captured forward/backward: every layer's A and G, and the weight
    gradients, against JAX's capture of the same lensed (and remat) LM."""
    jmodel, init, params = _jax_lm(1, qkv_lens=True, remat=remat)
    (x, y), = _tokens(2)
    names = jcapture.discover_layers(jmodel, init, train=True)
    perts = jcapture.perturbation_zeros(jmodel, jnp.asarray(x), train=True)

    def loss_fn(p, pt):
        logits, mut = jmodel.apply({"params": p, PERTURBATIONS: pt}, jnp.asarray(x),
                                   train=True, mutable=[KFAC_ACTS])
        return jce(logits, jnp.asarray(y)), mut

    (jloss, mut), (jgrads, gperts) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, perts)
    want_a = jcapture.a_contribs(mut[KFAC_ACTS], names, perturb_grads=gperts)
    want_g = jcapture.g_factors(gperts, names, True, captured=mut[KFAC_ACTS])

    model = _port_lm(params, qkv_lens=True, remat=remat)
    cap = capture.Capture(model, capture.discover_layers(model))
    with cap.capturing("auto"):
        loss = softmax_cross_entropy(model(_t64(x)), _t64(y))
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(cap.a_contribs) == set(cap.g_factor_stats) == set(map(lm_layer_name_from_jax, names))
    for jn in names:
        n = lm_layer_name_from_jax(jn)
        _close(cap.a_contribs[n].numpy(), want_a[jn], f"A {n}")
        _close(cap.g_factor_stats[n].numpy(), want_g[jn], f"G {n}")
    for i in range(LAYERS):  # one A, shared by the three splits
        a = [cap.a_contribs[f"blocks.{i}.qkv#s{k}"] for k in range(3)]
        assert a[0].shape == (D_MODEL + 1, D_MODEL + 1) and all(torch.equal(a[0], b) for b in a)
        assert cap.g_factor_stats[f"blocks.{i}.qkv#s1"].shape == (D_MODEL, D_MODEL)
    want = lm_state_dict_from_jax(_np_tree(jgrads))
    for key, p in model.named_parameters():
        _close(p.grad.numpy(), want[key].numpy(), key)


@pytest.mark.parametrize("method", ["eigen", "inverse"])
def test_lens_update_matches_jax(method):
    """``KFAC.update`` over a lensed projection's three pseudo-layers, a
    refresh step then a capture step, against the JAX package's."""
    cin, m, s, b = 6, 8, 3, 24
    r = np.random.RandomState(3)
    x = r.randn(b, cin).astype(np.float32)
    gouts = [r.randn(b, s * m).astype(np.float32) / b for _ in range(2)]
    grads = [(r.randn(s * m, cin).astype(np.float32), r.randn(s * m).astype(np.float32))
             for _ in range(2)]
    jnames = [f"qkv{jcapture.SPLIT_SEP}{k}" for k in range(s)]
    names = [f"qkv{capture.SPLIT_SEP}{k}" for k in range(s)]
    hp = dict(damping=0.01, precond_method=method, factor_decay=0.9)
    jk = JKFAC(layers=jnames, **hp)
    jstate = jax.jit(jk.init)({"qkv": {"kernel": jnp.zeros((cin, s * m)), "bias": jnp.zeros((s * m,))}})
    model = torch.nn.Module()
    model.qkv = KFACDense(cin, s * m, lens_splits=s)
    tk = KFAC(layers=names, device="cpu", **hp)
    tstate = tk.init(model)
    a = jfactors.compute_a_dense(jnp.asarray(x), has_bias=True)
    for step, (gout, (wg, bg)) in enumerate(zip(gouts, grads)):
        g_s = {n: jfactors.compute_g_dense(jnp.asarray(gout[:, k * m:(k + 1) * m]), True)
               for k, n in enumerate(jnames)}
        flags = dict(update_factors=True, update_eigen=step == 0)
        jnew, jstate = jk.update({"qkv": {"kernel": jnp.asarray(wg.T), "bias": jnp.asarray(bg)}},
                                 jstate, a_contribs={n: a for n in jnames}, g_factor_stats=g_s,
                                 lr=0.1, damping=0.01, **flags)
        tnew, tstate = tk.update(
            {"qkv.weight": torch.from_numpy(wg), "qkv.bias": torch.from_numpy(bg)}, tstate,
            a_contribs={n: torch.from_numpy(np.array(a)) for n in names},
            g_factor_stats={n: torch.from_numpy(np.array(g_s[jn])) for n, jn in zip(names, jnames)},
            lr=0.1, damping=0.01, **flags)
        _close(tnew["qkv.weight"].numpy(), np.asarray(jnew["qkv"]["kernel"]).T, f"step {step}")
        _close(tnew["qkv.bias"].numpy(), jnew["qkv"]["bias"], f"step {step}")
    for n, jn in zip(names, jnames):
        for side in ("A", "G"):
            _close(tstate["factors"][n][side].numpy(), jstate["factors"][jn][side], f"{n} {side}")


def test_lens_lm_train_steps_match_jax():
    """Three K-FAC train steps (refresh, capture, refresh) of the lensed LM:
    loss and every parameter against the JAX step."""
    jmodel, init, params = _jax_lm(0, qkv_lens=True)
    model = _port_lm(params, qkv_lens=True)
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), **HP)
    tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                         opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params))
    tstate = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                        kfac_state=tk.init(model))
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True}, grad_clip=CLIP,
                             sgd_hyper=(MOMENTUM, WD))
    tstep = make_train_step(model, tx, tk, sgd_hyper=(MOMENTUM, WD), grad_clip=CLIP)
    for i, (x, y) in enumerate(_tokens(4, STEPS)):
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        tstate, tm = tstep(tstate, (_t64(x), _t64(y)), LR, HP["damping"], **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        want = lm_state_dict_from_jax(_np_tree(jstate.params))
        for key, p in model.state_dict().items():
            _close(p.numpy(), want[key].numpy(), f"step {i}: {key}")
    facs = tstate.kfac_state["factors"]
    assert facs["blocks.0.qkv#s2"]["G"].shape == (D_MODEL, D_MODEL)
    assert torch.equal(facs["blocks.1.qkv#s0"]["A"], facs["blocks.1.qkv#s2"]["A"])


def test_lens_cuts_the_apply_groups_and_refresh_cubes():
    """The LM's apply groups go from 5 to 4 under the lens (the three
    ``d_model``-wide splits join the ``out`` projections' group), and the
    refresh's eigh work on the QKV factors drops at least threefold."""
    def groups_and_cubes(qkv_lens):
        model = transformer_lm.get_model(100, max_len=8, d_model=16, n_heads=2, n_layers=2,
                                         kfac_embedding=True, qkv_lens=qkv_lens)
        facs = KFAC(layers=capture.discover_layers(model), device="cpu")._identity_factors(model)
        shapes = {n: (f["G"].shape[0], f["A"].shape[0]) for n, f in facs.items() if "A" in f}
        cubes = sum(g ** 3 + a ** 3 for n, (g, a) in shapes.items() if "qkv" in n)
        return len(precond_ops.shape_groups(shapes)), cubes

    (g1, c1), (g3, c3) = groups_and_cubes(False), groups_and_cubes(True)
    assert (g1, g3) == (5, 4)
    assert c1 >= 3 * c3


def test_lens_checkpoint_round_trip(tmp_path):
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=True)
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
    tx = make_sgd(MOMENTUM, WD)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step = make_train_step(model, tx, kfac, sgd_hyper=(MOMENTUM, WD), grad_clip=CLIP)
    for i, (x, y) in enumerate(_tokens(5, 2)):
        state, _ = step(state, (_t64(x), _t64(y)), LR, HP["damping"], **kfac_flags_for_step(i, kfac))
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    fresh_model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=True,
                                           generator=torch.Generator().manual_seed(9))
    fresh = TrainState(step=0, model=fresh_model,
                       opt_state=tx.init(dict(fresh_model.named_parameters())),
                       kfac_state=kfac.init(fresh_model))
    back = ckpt.restore_checkpoint(str(tmp_path), 0, fresh, kfac)
    assert back.step == 2
    want, got = workers._np(state.kfac_state), workers._np(back.kfac_state)
    assert "blocks.0.qkv#s1" in got["factors"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[k], v)


LEVER_CASES = {
    "replicated": {},
    "comm_bf16_deferred": {"factor_comm_dtype": "bf16", "factor_comm_freq": 2},
    "owner": {"factor_sharding": "owner"},
    "eigh_chunks": {"eigh_chunks": 2},
    "rsvd": {"solver": "rsvd", "solver_rank": 4, "solver_auto_threshold": 8},
    "inverse": {"precond_method": "inverse"},
    "distribute_precondition": {"distribute_precondition": True},
}
LENS_SHAPE = (6, 8, 5)  # cin, m, classes
LENS_STEPS = 7


@pytest.fixture(scope="module", autouse=True)
def lens_spawn(tmp_path_factory):
    """The lever cases' two ranks, started before the module's first test so
    that they run while this process runs JAX; joined when first read, and
    at the module's end."""
    cin, m, classes = LENS_SHAPE
    r = np.random.RandomState(7)
    weights = {}
    for p in ("q", "k", "v"):
        weights[f"{p}.weight"] = (r.randn(m, cin) / np.sqrt(cin)).astype(np.float32)
        weights[f"{p}.bias"] = (0.1 * r.randn(m)).astype(np.float32)
    weights["head.weight"] = (r.randn(classes, 3 * m) / np.sqrt(3 * m)).astype(np.float32)
    weights["head.bias"] = np.zeros(classes, np.float32)
    root = tmp_path_factory.mktemp("lens")
    ranks = workers.joiner(workers.start(
        "lens", 2, str(root / "run"), weights=weights,
        x=r.randn(2, 16, cin).astype(np.float32), y=r.randint(0, classes, size=(2, 16)),
        shape=LENS_SHAPE, cases=LEVER_CASES, steps=LENS_STEPS, ck_root=str(root / "ck")))
    yield ranks
    ranks()


@pytest.fixture(scope="module")
def lens_ranks(lens_spawn):
    return lens_spawn()


@pytest.mark.parametrize("case", list(LEVER_CASES))
def test_lens_composes_with_levers(lens_ranks, case):
    """Two gloo ranks: the lensed net equals its unfused oracle after every
    step under each lever (float32 rounding of the fused product apart)."""
    for res in lens_ranks:
        for step, (fused, unfused) in enumerate(zip(res[case]["fused"], res[case]["unfused"])):
            for key, want in unfused.items():
                _close(fused[key], want, f"{case} step {step}: {key}")
    assert lens_ranks[0][case]["fused"][-1].keys() == lens_ranks[1][case]["fused"][-1].keys()
    for key, want in lens_ranks[0][case]["fused"][-1].items():
        np.testing.assert_array_equal(lens_ranks[1][case]["fused"][-1][key], want)


def test_lens_owner_checkpoint(lens_ranks):
    for res in lens_ranks:
        ck = res["ck"]
        assert ck["names"] == ["head", "qkv#s0", "qkv#s1", "qkv#s2"]
        for pair in (ck["round_trip"], ck["rehomed"]):
            jax.tree_util.tree_map(np.testing.assert_array_equal, pair[1], pair[0])


# ---------------------------------------------------------------- remat


def _captured_step(model, x, y, generator=None):
    """One captured forward/backward: ``(A, G, grads)``."""
    cap = capture.Capture(model, capture.discover_layers(model))
    with cap.capturing("auto"):
        softmax_cross_entropy(model(_t64(x), generator=generator), _t64(y)).backward()
    cap.remove()
    return (dict(cap.a_contribs), dict(cap.g_factor_stats),
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("qkv_lens", [False, True])
def test_remat_is_bitwise_transparent(qkv_lens):
    """Remat changes memory, not math: the captured statistics, the
    gradients, and the parameters after two K-FAC steps, bit for bit."""
    (x, y), = _tokens(6)
    runs = []
    for remat in (False, True):
        model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=qkv_lens, remat=remat)
        a, g, grads = _captured_step(model, x, y)
        kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
        tx = make_sgd(MOMENTUM, WD)
        state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                           kfac_state=kfac.init(model))
        step = make_train_step(model, tx, kfac, sgd_hyper=(MOMENTUM, WD), grad_clip=CLIP)
        for i, (xs, ys) in enumerate(_tokens(7, 2)):
            state, _ = step(state, (_t64(xs), _t64(ys)), LR, HP["damping"],
                            **kfac_flags_for_step(i, kfac))
        runs.append((a, g, grads, dict(model.state_dict())))
    for want, got in zip(*runs):
        _bitwise(got, want)


def test_remat_computes_each_a_once(monkeypatch):
    """A capture step under remat computes each dense A, and the token
    counts (kernel 2's dispatch), once, as without remat, though every
    block's forward runs twice."""
    calls = {"dense": 0, "embed": 0, "blocks": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(factors, "compute_a_dense", counting("dense", factors.compute_a_dense))
    monkeypatch.setattr(factor_kernels, "dispatch_compute_a_embed",
                        counting("embed", factor_kernels.dispatch_compute_a_embed))
    (x, y), = _tokens(8)
    seen = []
    for remat in (False, True):
        for k in calls:
            calls[k] = 0
        model = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=True, remat=remat)
        for block in model.blocks:
            block.register_forward_pre_hook(lambda *_: calls.__setitem__("blocks", calls["blocks"] + 1))
        _captured_step(model, x, y)
        seen.append(dict(calls))
    # 4 dense layers per block (qkv once for its three splits) + the decoder
    assert seen[0] == {"dense": 4 * LAYERS + 1, "embed": 1, "blocks": LAYERS}
    assert seen[1] == {"dense": 4 * LAYERS + 1, "embed": 1, "blocks": 2 * LAYERS}


# ---------------------------------------------------------------- dropout


def test_dropout_forward_matches_jax_and_eval_is_deterministic():
    jmodel, _, params = _jax_lm(10)
    jdrop = jlm.get_model(VOCAB, **MODEL_KW, dropout=0.1)
    (x, _), = _tokens(11)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), train=True))
    model = _port_lm(params)
    model.train()
    with torch.no_grad():
        np.testing.assert_allclose(model(_t64(x)).numpy(), want, rtol=1e-4, atol=1e-5)
    want_eval = np.asarray(jdrop.apply({"params": params}, jnp.asarray(x), train=False))
    model = _port_lm(params, dropout=0.1)
    model.eval()
    with torch.no_grad():
        first, second = model(_t64(x)), model(_t64(x))
    assert torch.equal(first, second)
    np.testing.assert_allclose(first.numpy(), want_eval, rtol=1e-4, atol=1e-5)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(_t64(x))
    with torch.no_grad():
        a = model(_t64(x), generator=torch.Generator().manual_seed(1))
        b = model(_t64(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, first)


@pytest.mark.parametrize("qkv_lens", [False, True])
def test_dropout_remat_is_bitwise(qkv_lens):
    """At dropout 0.1 the recompute draws the block's masks again: remat on
    and off give the same statistics and gradients bit for bit, and leave
    the caller's generator in the same state."""
    (x, y), = _tokens(12)
    runs = []
    for remat in (False, True):
        model = transformer_lm.get_model(VOCAB, **MODEL_KW, dropout=0.1, qkv_lens=qkv_lens,
                                         remat=remat)
        model.train()
        gen = torch.Generator().manual_seed(13)
        runs.append((*_captured_step(model, x, y, gen), gen.get_state()))
    for want, got in zip(runs[0][:3], runs[1][:3]):
        _bitwise(got, want)
    assert torch.equal(runs[0][3], runs[1][3])
    nodrop = transformer_lm.get_model(VOCAB, **MODEL_KW, qkv_lens=qkv_lens)
    assert not torch.equal(_captured_step(nodrop, x, y)[2]["blocks.0.ff2.weight"],
                           runs[0][2]["blocks.0.ff2.weight"])
