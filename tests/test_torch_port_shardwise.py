"""The shard lenses: column- and row-sharded dense layers and the MoE bank.

Against the JAX package (``kfac_pytorch_tpu/shardwise/``,
``ops/factors.py``, ``models/layers.py``), at tiny widths on the CPU:

* the five factor functions (``compute_a_row_sharded``,
  ``compute_g_dense_sharded``, ``compute_a_moe``, ``compute_a_moe_onehot``,
  ``compute_g_moe``) within 1e-5 relative of JAX's; the MoE sums bitwise
  equal to the one-hot oracle, as the JAX test holds them; the stacks'
  rows equal to the dense functions on the slices;
* ``dispatch_compute_a_moe``'s plain version bitwise against JAX's Pallas
  kernel in interpret mode, and its ``"dense"`` route;
* ``moe_ema`` (an expert that saw no tokens keeps its history bit for
  bit), ``eigen_refresh`` (compared through the reconstructions, never Q)
  and ``precondition`` for the column, row and MoE forms, 1e-5 relative;
* one captured forward/backward of a tiny LM with ``tensor_parallel=2``
  and with ``moe_experts=2`` and carried weights: the logits' loss, every
  layer's A and G statistics and every weight gradient, at
  ``test_torch_port_lm.py``'s bounds (``2e-5·max|jax| + 1e-6``); under
  remat the MoE LM's statistics and gradients are bitwise those without,
  each bank's G computed once a capture step;
* ``KFAC.update`` over a refresh step and a capture step of a ``#c2``, a
  ``#r2`` and an ``#e3`` layer against JAX's (gradients, factors);
* the seven planner refusals with the JAX package's messages and rule
  names, the model's mutual exclusion and the layers' checks, and the
  twin's flags;
* the port-only oracles of JAX's ``tests/test_shardwise.py``: a
  column-sharded layer trains as the expand lens, a row-sharded one as
  the sum of its input slices' bias-free layers (1e-6 relative);
* the shard stacks and form-prefixed eigen entries through a checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import shardwise as jshardwise
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.models.layers import KFAC_ACTS, PERTURBATIONS
from kfac_pytorch_tpu.models.layers import KFACShardedDense as JShardedDense
from kfac_pytorch_tpu.ops import factor_kernels as jfk
from kfac_pytorch_tpu.ops import factors as jfactors
from kfac_pytorch_tpu.parallel.mesh import data_parallel_mesh
from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
from kfac_pytorch_tpu_torch import KFAC, capture, shardwise
from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
from kfac_pytorch_tpu_torch.interop import lm_layer_name_from_jax, lm_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.models.layers import KFACDense, KFACMoE, KFACShardedDense
from kfac_pytorch_tpu_torch.ops import factor_kernels, factors
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
    softmax_cross_entropy,
)
from tests import torch_dist_workers as workers

VOCAB, D_MODEL, HEADS, LAYERS, SEQ, BATCH = 64, 32, 2, 1, 16, 2
MODEL_KW = dict(max_len=SEQ, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
                kfac_embedding=True)
HP = dict(factor_decay=0.95, damping=0.003, kl_clip=0.001, fac_update_freq=1,
          kfac_update_freq=2)


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


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()) + 1e-6, err_msg=err_msg)


def _rel(got, want, err_msg="", rtol=1e-5):
    """Within ``rtol`` of the largest entry of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ factors


def test_sharded_factor_functions_match_jax():
    r = np.random.RandomState(1)
    x = r.randn(24, 12).astype(np.float32)
    g = r.randn(24, 12).astype(np.float32)
    row = factors.compute_a_row_sharded(_t(x), 3)
    _rel(row.numpy(), jfactors.compute_a_row_sharded(jnp.asarray(x), 3), "A row")
    for ba in (True, False):
        col = factors.compute_g_dense_sharded(_t(g), 3, ba)
        _rel(col.numpy(), jfactors.compute_g_dense_sharded(jnp.asarray(g), 3, ba), f"G col {ba}")
        for i in range(3):  # rows of the stacks: the dense functions on the slices
            _rel(col[i].numpy(), factors.compute_g_dense(_t(g[:, 4 * i:4 * i + 4]), ba).numpy(),
                 rtol=1e-6)
    for i in range(3):
        _rel(row[i].numpy(), factors.compute_a_dense(_t(x[:, 4 * i:4 * i + 4]), False).numpy(),
             rtol=1e-6)
    assert row.shape == (3, 4, 4)


def test_moe_factor_functions_match_jax_and_the_onehot_oracle_bitwise():
    r = np.random.RandomState(3)
    x = r.randn(32, 6).astype(np.float32)
    ids = r.randint(0, 4, size=(32,))
    ids[ids == 3] = 2  # expert 3 sees no token
    sparse = factors.compute_a_moe(_t(x), _t(ids), 4)
    assert torch.equal(sparse, factors.compute_a_moe_onehot(_t(x), _t(ids), 4))
    assert torch.equal(sparse[3], torch.zeros(6, 6))
    _rel(sparse.numpy(), jfactors.compute_a_moe(jnp.asarray(x), jnp.asarray(ids), 4), "S")
    _rel(factors.compute_a_moe_onehot(_t(x), _t(ids.reshape(4, 8)), 4).numpy(),
         jfactors.compute_a_moe_onehot(jnp.asarray(x), jnp.asarray(ids.reshape(4, 8)), 4))
    h = r.randn(4, 8, 4, 5).astype(np.float32)  # [B, T, E, m] cotangent
    h *= (np.arange(4)[None, None, :] == ids.reshape(4, 8)[..., None])[..., None]
    for ba in (True, False):
        _rel(factors.compute_g_moe(_t(h), ba).numpy(),
             jfactors.compute_g_moe(jnp.asarray(h), ba), f"G moe {ba}")


def test_moe_dispatch_matches_the_jax_kernel_bitwise():
    """The expert fractions: the plain version (a CPU tensor's route) and
    the dense oracle against JAX's Pallas token-count kernel (interpret
    mode) and its dense route, bit for bit; counted on kernel 2's counter
    only on CUDA."""
    ids = np.random.RandomState(4).randint(0, 4, size=(8, 64))
    with jfk.factor_kernel_scope("pallas"):
        want = np.asarray(jfk.dispatch_compute_a_moe(jnp.asarray(ids, jnp.int32), 4))
    with jfk.factor_kernel_scope("dense"):
        want_dense = np.asarray(jfk.dispatch_compute_a_moe(jnp.asarray(ids, jnp.int32), 4))
    np.testing.assert_array_equal(want, want_dense)
    before = factor_kernels.compute_a_embed_fused.launches
    for kind in ("auto", "dense"):
        for dtype in (torch.int32, torch.int64):
            got = factor_kernels.dispatch_compute_a_moe(_t(ids).to(dtype), 4, kind=kind)
            assert got.dtype == torch.float32 and got.shape == (4,)
            np.testing.assert_array_equal(got.numpy(), want)
    assert factor_kernels.compute_a_embed_fused.launches == before
    with pytest.raises(ValueError, match="factor_kernel='kernel'"):
        factor_kernels.dispatch_compute_a_moe(_t(ids), 4, kind="kernel")
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 4\)"):
        factor_kernels.dispatch_compute_a_moe(_t(ids) + 1, 4)


def test_moe_ema_matches_jax_and_keeps_an_idle_expert():
    e, a, m = 3, 5, 4
    r = np.random.RandomState(4)
    cur = {"A": r.randn(e, a, a).astype(np.float32), "G": r.randn(e, m, m).astype(np.float32)}
    f = np.asarray([0.75, 0.25, 0.0], np.float32)  # expert 2: no tokens
    s = r.randn(e, a, a).astype(np.float32) * f[:, None, None]
    g = r.randn(e, m, m).astype(np.float32) * f[:, None, None]
    got = shardwise.moe_ema({k: _t(v) for k, v in cur.items()}, {"S": _t(s), "f": _t(f)},
                            _t(g), 0.9)
    want = jshardwise.moe_ema({k: jnp.asarray(v) for k, v in cur.items()},
                              {"S": jnp.asarray(s), "f": jnp.asarray(f)}, jnp.asarray(g), 0.9)
    for k in ("A", "G"):
        np.testing.assert_array_equal(got[k][2].numpy(), cur[k][2])
        _rel(got[k].numpy(), want[k], k, rtol=1e-6)
    # ema_update routes the MoE form there, the column/row forms elementwise
    assert torch.equal(shardwise.ema_update("e", {k: _t(v) for k, v in cur.items()},
                                            {"S": _t(s), "f": _t(f)}, _t(g), 0.9)["A"], got["A"])
    col = shardwise.ema_update("c", {"A": _t(cur["A"][0]), "G": _t(cur["G"])},
                               _t(s[0]), _t(g), 0.9)
    assert torch.equal(col["G"], factors.update_running_avg(_t(g), _t(cur["G"]), 0.9))


def _spd(r, *shape):
    x = r.randn(*shape[:-1], 3 * shape[-1]).astype(np.float32)
    return (x @ np.swapaxes(x, -1, -2) / x.shape[-1]).astype(np.float32)


# form: (A, G, grad mat) shapes for count 2 (c, r) or 3 experts (e)
FORMS = {
    "c": ((9, 9), (2, 4, 4), (8, 9)),
    "r": ((2, 3, 3), (5, 5), (5, 6)),
    "e": ((3, 4, 4), (3, 5, 5), (3, 5, 4)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_eigen_refresh_and_precondition_match_jax(form):
    """Reconstructions ``Q diag(d) Qᵀ`` and the preconditioned matrices
    against JAX's (the bases themselves may differ in sign and order)."""
    r = np.random.RandomState(5)
    a_shape, g_shape, gm_shape = FORMS[form]
    facs = {"A": _spd(r, *a_shape), "G": _spd(r, *g_shape)}
    gm = r.randn(*gm_shape).astype(np.float32)
    count = 3 if form == "e" else 2
    got = shardwise.eigen_refresh(form, {k: _t(v) for k, v in facs.items()})
    want = jshardwise.eigen_refresh(form, {k: jnp.asarray(v) for k, v in facs.items()})
    qa, da, qg, dg = shardwise.EIGEN_KEYS[form]
    assert all(v.dtype == torch.float32 for v in got.values())
    for q, d, side in ((qa, da, "A"), (qg, dg, "G")):
        recon = got[q] @ torch.diag_embed(got[d]) @ got[q].transpose(-1, -2)
        _rel(recon.numpy(), facs[side], side, rtol=1e-5)
        np.testing.assert_allclose(got[d].numpy(), np.asarray(want[d]), rtol=1e-5, atol=1e-7)
    for damping in (0.003, 0.1):
        v = shardwise.precondition(form, count, _t(gm), got, damping)
        assert v.shape == gm.shape
        _rel(v.numpy(), jshardwise.precondition(form, count, jnp.asarray(gm), want, damping),
             f"v at {damping}", rtol=1e-5)
    ident = shardwise.identity_eigen(form, {k: _t(v) for k, v in facs.items()})
    assert shardwise.is_shard_eigen_entry(ident) and not shardwise.is_shard_eigen_entry(
        {"QA": 0, "dA": 0})
    # identity bases: the damped identity solve
    v = shardwise.precondition(form, count, _t(gm), ident, 1.0)
    np.testing.assert_allclose(v.numpy(), gm / 2.0, rtol=1e-6)


def test_shard_names_and_registry():
    from kfac_pytorch_tpu_torch.capture import split_shard_name

    for name in ("blocks.0.ff1#c2", "blocks.0.ff2#r4", "blocks.1.moe#e8", "blocks.0.qkv#s1",
                 "decoder"):
        assert split_shard_name(name) == jcapture.split_shard_name(name)
    names = ["a#c2", "b#r2", "c", "d#e4"]
    assert shardwise.shard_entries(names) == {"a#c2": ("a", "c", 2), "b#r2": ("b", "r", 2),
                                              "d#e4": ("d", "e", 4)}
    assert shardwise.has_shard_lens(names) and shardwise.has_moe(names)
    assert not shardwise.has_shard_lens(["d#e4"]) and not shardwise.has_moe(["a#c2"])
    assert capture.layer_base("blocks.1.moe#e8") == "blocks.1.moe"
    for form, shape, bias in (("c", (8, 6), True), ("r", (8, 6), False), ("e", (3, 6, 8), False)):
        got = shardwise.identity_factors(form, 3 if form == "e" else 2, shape, bias)
        jshape = (shape[1], shape[0]) if form != "e" else shape
        want = jshardwise.identity_factors(form, 3 if form == "e" else 2, jshape, bias)
        for k in ("A", "G"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------- layers, capture


def _jax_lm(seed, **kw):
    """The JAX LM, its init batch and its parameters (the init jitted: one
    compile costs less than the eager ops' first dispatches)."""
    model = jlm.get_model(VOCAB, **MODEL_KW, **kw)
    init = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = jax.jit(lambda k, x: model.init(k, x, train=True))(jax.random.PRNGKey(seed), init)
    return model, init, params["params"]


def _tokens(seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32),
            r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32))


def _jax_capture(jmodel, init, params, x, y):
    names = jcapture.discover_layers(jmodel, init, train=True)
    perts = jcapture.perturbation_zeros(jmodel, jnp.asarray(x), train=True)

    def loss_fn(p, pt):
        logits, mut = jmodel.apply({"params": p, PERTURBATIONS: pt}, jnp.asarray(x),
                                   train=True, mutable=[KFAC_ACTS])
        return jce(logits, jnp.asarray(y)), mut

    (jloss, mut), (jgrads, gperts) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, perts)
    return (names, jloss, jcapture.a_contribs(mut[KFAC_ACTS], names, perturb_grads=gperts),
            jcapture.g_factors(gperts, names, True, captured=mut[KFAC_ACTS]), jgrads)


@pytest.mark.parametrize("kw", [dict(tensor_parallel=2), dict(moe_experts=2)])
def test_lm_capture_matches_jax(kw):
    """One captured forward/backward of the sharded-MLP or MoE LM: the
    layer names, the loss, every A (the MoE pair's sums and fractions) and
    G, and the weight gradients, against JAX's capture."""
    jmodel, init, params = _jax_lm(1, **kw)
    x, y = _tokens(2)
    names, jloss, want_a, want_g, jgrads = _jax_capture(jmodel, init, params, x, y)
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kw)
    model.load_state_dict(lm_state_dict_from_jax(_np_tree(params)))  # strict
    cap = capture.Capture(model, capture.discover_layers(model))
    with cap.capturing("auto"):
        loss = softmax_cross_entropy(model(_t(x).long()), _t(y).long())
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(cap.a_contribs) == sorted(map(lm_layer_name_from_jax, names))
    assert set(cap.a_contribs) == set(cap.g_factor_stats)
    for jn in names:
        n = lm_layer_name_from_jax(jn)
        if isinstance(want_a[jn], dict):
            _close(cap.a_contribs[n]["S"].numpy(), want_a[jn]["S"], f"S {n}")
            np.testing.assert_array_equal(cap.a_contribs[n]["f"].numpy(), want_a[jn]["f"])
        else:
            _close(cap.a_contribs[n].numpy(), want_a[jn], f"A {n}")
        _close(cap.g_factor_stats[n].numpy(), want_g[jn], f"G {n}")
    want = lm_state_dict_from_jax(_np_tree(jgrads))
    for key, p in model.named_parameters():
        _close(p.grad.numpy(), want[key].numpy(), key)
    if "tensor_parallel" in kw:
        assert cap.g_factor_stats["blocks.0.ff1#c2"].shape == (2, 64, 64)
        assert cap.a_contribs["blocks.0.ff2#r2"].shape == (2, 64, 64)



def test_moe_remat_is_bitwise_and_takes_g_once(monkeypatch):
    """Under remat the bank's forward runs twice; its statistics and the
    gradients are bitwise those without remat, and its A sums, fractions
    and G are each computed once a capture step."""
    calls = {"S": 0, "f": 0, "G": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(factors, "compute_a_moe", counting("S", factors.compute_a_moe))
    monkeypatch.setattr(factor_kernels, "dispatch_compute_a_moe",
                        counting("f", factor_kernels.dispatch_compute_a_moe))
    monkeypatch.setattr(factors, "compute_g_moe", counting("G", factors.compute_g_moe))
    x, y = _tokens(3)
    runs = []
    for remat in (False, True):
        model = transformer_lm.get_model(VOCAB, **{**MODEL_KW, "n_layers": 2}, moe_experts=2,
                                         remat=remat)
        cap = capture.Capture(model, capture.discover_layers(model))
        with cap.capturing("auto"):
            softmax_cross_entropy(model(_t(x).long()), _t(y).long()).backward()
        runs.append((dict(cap.a_contribs), dict(cap.g_factor_stats),
                     {n: p.grad for n, p in model.named_parameters()}, dict(calls)))
        calls.update(S=0, f=0, G=0)
    for want, got in zip(runs[0][:3], runs[1][:3]):
        assert want.keys() == got.keys()
        for k in want:
            for a, b in zip(workers._leaves(want[k]), workers._leaves(got[k])):
                assert torch.equal(a, b), k
    assert runs[0][3] == runs[1][3] == {"S": 2, "f": 2, "G": 2}


def test_layer_checks_and_the_models_mutual_exclusion():
    """The layers' and the model's refusals, with the JAX package's messages."""
    x = jnp.zeros((2, 6))
    cases = [
        (dict(features=6, shards=2, sharding="diag"), (6, 6, 2), dict(sharding="diag")),
        (dict(features=6, shards=4), (6, 6, 4), {}),
        (dict(features=6, shards=4, sharding="row", use_bias=False), (6, 6, 4),
         dict(sharding="row", bias=False)),
        (dict(features=6, shards=2, sharding="row"), (6, 6, 2), dict(sharding="row")),
    ]
    for jkw, args, kw in cases:
        with pytest.raises(ValueError) as want:
            JShardedDense(**jkw).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError) as got:
            KFACShardedDense(*args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="num_experts=1 must be >= 2"):
        KFACMoE(6, 6, 1)
    with pytest.raises(ValueError) as want:
        _jax_lm(0, tensor_parallel=2, moe_experts=2)
    with pytest.raises(ValueError) as got:
        transformer_lm.get_model(VOCAB, **MODEL_KW, tensor_parallel=2, moe_experts=2)
    assert str(got.value) == str(want.value)


def test_sharded_layers_forward_and_write_back():
    """The column/row layers compute as a plain ``nn.Linear``; the MoE bank
    gates the chosen expert's output; every layer's gradients go through
    ``grad_mats`` and ``write_back`` unchanged."""
    torch.manual_seed(0)
    col = KFACShardedDense(6, 8, 2)
    row = KFACShardedDense(8, 6, 2, sharding="row", bias=False)
    lin = torch.nn.Linear(6, 8)
    lin.load_state_dict(col.state_dict())
    x = torch.randn(3, 5, 6)
    assert torch.equal(col(x), lin(x)) and row(col(x)).shape == (3, 5, 6)
    moe = KFACMoE(6, 4, 3)
    out = moe(x)
    logits = x.reshape(-1, 6) @ moe.router.weight.T
    idx = logits.argmax(-1)
    want = torch.stack([x.reshape(-1, 6)[i] @ moe.weight[e] for i, e in enumerate(idx)])
    want = want * torch.softmax(logits, -1).gather(-1, idx[:, None])
    torch.testing.assert_close(out.reshape(-1, 4), want, rtol=1e-6, atol=1e-6)
    net = torch.nn.Module()
    net.col, net.row, net.moe = col, row, moe
    names = capture.discover_layers(net)
    assert names == ["col#c2", "row#r2", "moe#e3"]
    grads = {n: torch.randn(p.shape) for n, p in net.named_parameters()}
    mats = capture.grad_mats(capture.layer_grads(grads, names))
    assert {n: tuple(m.shape) for n, m in mats.items()} == {
        "col#c2": (8, 7), "row#r2": (6, 8), "moe#e3": (3, 4, 6)}
    back = capture.write_back(grads, mats, torch.tensor(1.0))
    for n, g in grads.items():
        assert torch.equal(back[n], g) and back[n].is_contiguous(), n


# ------------------------------------------------------------ KFAC.update


UPDATE_CASES = {"c": "fc#c2", "r": "fc#r2", "e": "fc#e3"}  # form: layer name


def _update_case(form, r):
    """``(jax params, port module, [(a, g, jax grads, port grads)] × 2)``."""
    cin, m, b = 6, 8, 24
    x = r.randn(b, cin).astype(np.float32)
    steps = []
    if form == "e":
        e = 3
        jparams = {"fc": {"kernel": jnp.zeros((e, cin, m))}}
        module = torch.nn.Module()
        module.fc = KFACMoE(cin, m, e)
        ids = r.randint(0, e, size=(b,))
        for _ in range(2):
            h = r.randn(b, e, m).astype(np.float32) / b * (np.arange(e) == ids[:, None])[..., None]
            a = {"S": jfactors.compute_a_moe(jnp.asarray(x), jnp.asarray(ids), e),
                 "f": jfactors.compute_a_embed(jnp.asarray(ids), e)}
            k = r.randn(e, cin, m).astype(np.float32)
            steps.append((a, jfactors.compute_g_moe(jnp.asarray(h), True),
                          {"fc": {"kernel": jnp.asarray(k)}}, {"fc.weight": _t(k)}))
        return jparams, module, steps
    col = form == "c"
    jparams = {"fc": {"kernel": jnp.zeros((cin, m)), **({"bias": jnp.zeros((m,))} if col else {})}}
    module = torch.nn.Module()
    module.fc = KFACShardedDense(cin, m, 2, sharding="column" if col else "row", bias=col)
    for _ in range(2):
        gout = r.randn(b, m).astype(np.float32) / b
        if col:
            a = jfactors.compute_a_dense(jnp.asarray(x), has_bias=True)
            g = jfactors.compute_g_dense_sharded(jnp.asarray(gout), 2, True)
        else:
            a = jfactors.compute_a_row_sharded(jnp.asarray(x), 2)
            g = jfactors.compute_g_dense(jnp.asarray(gout), True)
        w = r.randn(m, cin).astype(np.float32)
        bias = r.randn(m).astype(np.float32)
        jg = {"fc": {"kernel": jnp.asarray(w.T), **({"bias": jnp.asarray(bias)} if col else {})}}
        tg = {"fc.weight": _t(w), **({"fc.bias": _t(bias)} if col else {})}
        steps.append((a, g, jg, tg))
    return jparams, module, steps


def _tree_t(tree):
    return {k: _tree_t(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)


@pytest.mark.parametrize("form", list(UPDATE_CASES))
def test_kfac_update_matches_jax(form):
    """A refresh step then a capture step over one shard-lens layer: the
    preconditioned gradients and the factors against the JAX package's."""
    jname = UPDATE_CASES[form]
    jparams, module, steps = _update_case(form, np.random.RandomState(8))
    hp = dict(damping=0.01, factor_decay=0.9)
    jk = JKFAC(layers=[jname], **hp)
    jstate = jk.init(jparams)
    tk = KFAC(layers=[jname], device="cpu", **hp)
    tstate = tk.init(module)
    assert tk.shard_layers == {jname: ("fc", form, int(jname[-1]))}
    for step, (a, g, jg, tg) in enumerate(steps):
        flags = dict(update_factors=True, update_eigen=step == 0)
        jnew, jstate = jk.update(jg, jstate, a_contribs={jname: a}, g_factor_stats={jname: g},
                                 lr=0.1, damping=0.01, **flags)
        tnew, tstate = tk.update(tg, tstate, a_contribs={jname: _tree_t(_np_tree(a))},
                                 g_factor_stats={jname: _t(g)}, lr=0.1, damping=0.01, **flags)
        want = np.asarray(jnew["fc"]["kernel"])
        _close(tnew["fc.weight"].numpy(), want if form == "e" else want.T, f"step {step}")
        if "fc.bias" in tg:
            _close(tnew["fc.bias"].numpy(), jnew["fc"]["bias"], f"step {step} bias")
    for side in ("A", "G"):
        _close(tstate["factors"][jname][side].numpy(), jstate["factors"][jname][side], side)
    keys = shardwise.EIGEN_KEYS[form]
    assert sorted(tstate["eigen"][jname]) == sorted(keys)
    assert not tstate["eigen_stacked"]


REFUSALS = [
    (dict(precond_method="inverse"), "shard_lens_vs_inverse"),
    (dict(diag_blocks=2), "shard_lens_vs_diag_blocks"),
    (dict(factor_sharding="owner"), "shard_lens_vs_owner_sharding"),
    (dict(eigh_chunks=2), "shard_lens_vs_chunks"),
    (dict(solver="streaming"), "shard_lens_vs_streaming"),
    (dict(service_devices=1), "service_vs_shard_lens"),
    (dict(factor_sharding="owner"), "moe_vs_owner_sharding"),
    (dict(factor_comm_freq=2), "moe_vs_deferred_comm"),
]


@pytest.mark.parametrize("kw,rule", REFUSALS)
def test_refusals_match_jax(kw, rule):
    """Each planner refusal with the JAX package's message and rule name,
    from an explicit layer list at construction and from the discovered
    one at ``init``."""
    name = "blk/moe#e4" if rule.startswith("moe") else "blk/ff1#c2"
    with pytest.raises(ValueError, match=rule) as want:
        JKFAC(damping=0.01, mesh=data_parallel_mesh(), layers=[name], **kw)
    with pytest.raises(ValueError, match=rule) as got:
        KFAC(damping=0.01, device="cpu", layers=[name.replace("/", ".")], **kw)
    assert str(got.value) == str(want.value)
    if "service_devices" in kw:
        return
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, **(
        dict(moe_experts=4) if rule.startswith("moe") else dict(tensor_parallel=2)))
    kfac = KFAC(damping=0.01, device="cpu", **kw)
    with pytest.raises(ValueError, match=rule):
        kfac.init(model)


def test_levers_that_compose_with_the_lenses():
    """What the JAX planner lets compose: the bf16 wire, rsvd on the other
    layers, diagnostics and the distributed apply (inert on one rank)
    build and train on the lens models."""
    for kw, extra in ((dict(tensor_parallel=2), dict(solver="rsvd", solver_rank=4,
                                                     solver_auto_threshold=16)),
                      (dict(moe_experts=2), dict(factor_comm_dtype="bf16",
                                                 track_diagnostics=True))):
        model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kw)
        kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **HP, **extra)
        losses, _ = _train(model, kfac, 3)
        assert all(np.isfinite(losses))


def _train(model, kfac, steps, seed=3):
    tx = make_sgd(0.9, 1e-5)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step = make_train_step(model, tx, kfac, sgd_hyper=(0.9, 1e-5), grad_clip=0.25)
    losses = []
    for i in range(steps):
        x, y = _tokens(seed + i)
        state, m = step(state, (_t(x).long(), _t(y).long()), 0.1, HP["damping"],
                        **kfac_flags_for_step(i, kfac))
        losses.append(float(m["loss"]))
    return losses, state


# ------------------------------------------------------ port-only oracles


def _cls_train(net, steps=6):
    """JAX ``tests/test_shardwise.py::_train``'s recipe: six steps, a
    refresh every second, damping 0.01, momentum 0.9, lr 0.1."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(16, 12).astype(np.float32))
    y = torch.from_numpy(r.randint(0, 8, size=(16,)))
    kfac = KFAC(layers=capture.discover_layers(net), device="cpu", damping=0.01,
                fac_update_freq=1, kfac_update_freq=2)
    tx = make_sgd(0.9)
    state = TrainState(step=0, model=net, opt_state=tx.init(dict(net.named_parameters())),
                       kfac_state=kfac.init(net))
    step = make_train_step(net, tx, kfac)
    losses = []
    for i in range(steps):
        state, m = step(state, (x, y), 0.1, 0.01, update_factors=True, update_eigen=i % 2 == 0)
        losses.append(float(m["loss"]))
    return losses, {k: v.clone() for k, v in net.state_dict().items()}


class _Net(torch.nn.Module):
    def __init__(self, fc1, out):
        super().__init__()
        self.fc1, self.out = fc1, out

    def forward(self, x):
        return self.out(torch.nn.functional.gelu(self.fc1(x), approximate="tanh"))


def test_column_lens_trains_as_the_expand_lens():
    torch.manual_seed(1)
    oracle = _Net(KFACDense(12, 16, lens_splits=2), KFACDense(16, 8))
    sharded = _Net(KFACShardedDense(12, 16, 2), KFACDense(16, 8))
    sharded.load_state_dict(oracle.state_dict())
    l_o, p_o = _cls_train(oracle)
    l_s, p_s = _cls_train(sharded)
    np.testing.assert_allclose(l_s, l_o, rtol=1e-6)
    for k, v in p_o.items():
        np.testing.assert_allclose(p_s[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    assert l_s[-1] < l_s[0]


class _RowNet(torch.nn.Module):
    def __init__(self, sharded):
        super().__init__()
        self.fc0 = KFACDense(12, 16)
        if sharded:
            self.fc1 = KFACShardedDense(16, 8, 2, sharding="row", bias=False)
        else:
            self.fc1a = KFACDense(8, 8, bias=False)
            self.fc1b = KFACDense(8, 8, bias=False)

    def forward(self, x):
        h = torch.tanh(self.fc0(x))
        if hasattr(self, "fc1"):
            return self.fc1(h)
        return self.fc1a(h[..., :8]) + self.fc1b(h[..., 8:])


def test_row_lens_trains_as_the_slice_sum():
    torch.manual_seed(2)
    sharded, oracle = _RowNet(True), _RowNet(False)
    w = sharded.fc1.weight.detach()
    oracle.load_state_dict({"fc0.weight": sharded.fc0.weight, "fc0.bias": sharded.fc0.bias,
                            "fc1a.weight": w[:, :8], "fc1b.weight": w[:, 8:]})
    l_s, p_s = _cls_train(sharded)
    l_o, p_o = _cls_train(oracle)
    np.testing.assert_allclose(l_s, l_o, rtol=1e-6)
    np.testing.assert_allclose(p_s["fc1.weight"].numpy(),
                               torch.cat([p_o["fc1a.weight"], p_o["fc1b.weight"]], 1).numpy(),
                               rtol=1e-6, atol=1e-7)
    for k in ("fc0.weight", "fc0.bias"):
        np.testing.assert_allclose(p_s[k].numpy(), p_o[k].numpy(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("kw", [dict(tensor_parallel=2), dict(moe_experts=2)])
def test_shard_stacks_checkpoint_round_trip(tmp_path, kw):
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kw)
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
    _, state = _train(model, kfac, 2)
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    fresh_model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kw,
                                           generator=torch.Generator().manual_seed(9))
    tx = make_sgd(0.9, 1e-5)
    fresh = TrainState(step=0, model=fresh_model,
                       opt_state=tx.init(dict(fresh_model.named_parameters())),
                       kfac_state=kfac.init(fresh_model))
    back = ckpt.restore_checkpoint(str(tmp_path), 0, fresh, kfac)
    assert back.step == 2
    want, got = workers._np(state.kfac_state), workers._np(back.kfac_state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    key = "blocks.0.ff1#c2" if "tensor_parallel" in kw else "blocks.0.moe#e2"
    assert got["factors"][key]["G"].shape[0] == 2
    assert sorted(got["eigen"][key])[0] in ("cQA", "eQA")
    for k, v in model.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[k], v)


# ----------------------------------------------------------------- the twin


TINY = ["--synthetic", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1",
        "--steps-per-epoch", "3", "--device", "cpu", "--kfac-embedding"]


def test_twin_flags():
    """``--moe-experts`` trains and ``--tensor-parallel`` parses (a world
    of one cannot split); ``--fsdp`` parses and refuses ``--seq-parallel``
    and ``--service-devices``; the JAX trainer's composition checks and the
    MoE bank's lever refusals."""
    args = trainer.parse_args([*TINY, "--moe-experts", "4", "--tensor-parallel", "2"])
    assert (args.moe_experts, args.tensor_parallel) == (4, 2)
    args = trainer.parse_args([*TINY, "--fsdp", "2", "--tensor-parallel", "2"])
    assert (args.fsdp, args.tensor_parallel) == (2, 2)
    with pytest.raises(SystemExit, match="it does not compose with --seq-parallel"):
        trainer.parse_args([*TINY, "--fsdp", "1", "--seq-parallel", "2"])
    with pytest.raises(SystemExit, match="not compose with --seq-parallel, --tensor-parallel or --fsdp"):
        trainer.parse_args([*TINY, "--fsdp", "1", "--service-devices", "1"])
    with pytest.raises(SystemExit, match="genuine --tensor-parallel"):
        trainer.parse_args([*TINY, "--fsdp", "1", "--tensor-parallel", "2",
                            "--moe-experts", "2"])
    with pytest.raises(SystemExit, match=r"\[moe_vs_deferred_comm\] MoE expert banks"):
        trainer.main([*TINY, "--moe-experts", "2", "--factor-comm-freq", "2"])
    with pytest.raises(SystemExit, match="--tensor-parallel 2 must divide device count 1"):
        trainer.main([*TINY, "--tensor-parallel", "2"])
    hist = trainer.main([*TINY, "--moe-experts", "2"])
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
