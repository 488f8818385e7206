"""The LM slice: transformer-LM training of the port against the JAX package.

A tiny JAX ``TransformerLM`` (d_model 32, 2 heads, 2 layers, vocab 64,
T 16, a K-FAC token embedding) is initialized and its weights carried into
the port's model with ``interop.lm_state_dict_from_jax``; both take the same
three train steps on the same numpy token batches: forward → CE over every
token → backward → global-norm clip → ``KFAC.update`` → SGD, with K-FAC on
(``kfac_update_freq=2``: steps 0 and 2 refresh, every step captures) and
off. After each step the loss and every parameter must agree. The JAX side
runs its default (dense, exact-attention) routes on the CPU; the port runs
its ``"auto"`` routes, i.e. its kernels' plain versions.

Also: the weight converter round-trips bit for bit; the forward logits and
the eval step match flax with either of the port's attentions (exact, and
the flash op's plain route); the preconditioner's diagonal-A solve, the
flattened CE, the global-norm clip and the data helpers match; the trainer
twin runs on the CPU, with the flags that later slices ported, and
refuses those still to come.

Tolerances: float32 with other summation orders; K-FAC's damped solve
amplifies rounding by up to 1/λ (λ = 0.003). Losses hold to 1e-5
relative, logits to rtol 1e-4 / atol 1e-5, and every parameter to
``|port − jax| ≤ 2e-5·max|jax| + 1e-6`` per tensor (the ResNet slice's
bound).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_eval_step as jmake_eval_step
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import lm_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.ops import flash_attention as tflash
from kfac_pytorch_tpu_torch.parallel.context import full_attention
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_eval_step,
    make_sgd,
    make_train_step,
    softmax_cross_entropy,
)

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


def _jax_init(seed):
    model = jlm.get_model(VOCAB, **MODEL_KW)
    init = jnp.zeros((BATCH, SEQ), jnp.int32)
    # jitted: one compile costs less than the eager ops' first dispatches
    params = jax.jit(lambda k, x: model.init(k, x, train=True))(jax.random.PRNGKey(seed), init)
    return model, init, params["params"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_model(params, attention_fn=full_attention):
    model = transformer_lm.get_model(VOCAB, attention_fn=attention_fn, **MODEL_KW)
    model.load_state_dict(lm_state_dict_from_jax(_np_tree(params)))  # strict
    return model


def _tokens(seed, n=STEPS):
    r = np.random.RandomState(seed)
    return [
        (r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32),
         r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32))
        for _ in range(n)
    ]


def _torch_batch(x, y):
    return torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64))


def _jax_tree_from_port(sd):
    """The inverse of ``lm_state_dict_from_jax``, for the round trip."""
    g = lambda key: sd[key].numpy()  # noqa: E731

    def dense(p):
        return {"bias": g(f"{p}.bias"), "kernel": g(f"{p}.weight").T}

    def ln(p):
        return {"bias": g(f"{p}.bias"), "scale": g(f"{p}.weight")}

    tree = {
        "tok_embed": {"embedding": g("tok_embed.weight")},
        "pos_embed": {"embedding": g("pos_embed.weight")},
        "ln_f": ln("ln_f"),
        "decoder": dense("decoder"),
    }
    for i in range(LAYERS):
        p = f"blocks.{i}"
        tree[f"block_{i}"] = {
            "ln_attn": ln(f"{p}.ln_attn"), "qkv": dense(f"{p}.qkv"),
            "out": dense(f"{p}.out"), "ln_mlp": ln(f"{p}.ln_mlp"),
            "ff1": dense(f"{p}.ff1"), "ff2": dense(f"{p}.ff2"),
        }
    return tree


def test_lm_state_dict_from_jax_round_trips_bitwise():
    _, _, params = _jax_init(1)
    want = _np_tree(params)
    model = _port_model(params)
    back = _jax_tree_from_port(model.state_dict())
    wl, wt = jax.tree_util.tree_flatten(dict(want))
    gl, gt = jax.tree_util.tree_flatten(back)
    assert wt == gt
    for a, b in zip(wl, gl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_lm_forward_and_eval_match_flax(attention):
    jmodel, _, params = _jax_init(2)
    (x, y), = _tokens(3, n=1)
    fn = full_attention if attention == "full" else tflash.flash_attention
    model = _port_model(params, fn)
    want = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    jm = jmake_eval_step(jmodel, eval_kwargs={"train": False})(
        JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                    opt_state=None),
        (jnp.asarray(x), jnp.asarray(y)),
    )
    tm = make_eval_step(model)(None, _torch_batch(x, y))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"])


@pytest.mark.parametrize("use_kfac", [True, False])
def test_lm_train_steps_match_jax(use_kfac):
    jmodel, init, params = _jax_init(0)
    model = _port_model(params)
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = tk = None
    if use_kfac:
        jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), **HP)
        tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
        assert sorted(n.replace("block_", "blocks.").replace("/", ".") for n in jk.layers) \
            == sorted(tk.layers)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params) if jk else None,
    )
    tstate = TrainState(
        step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=tk.init(model) if tk else None,
    )
    sgd_hyper = (MOMENTUM, WD) if use_kfac else None
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True},
                             grad_clip=CLIP, sgd_hyper=sgd_hyper)
    tstep = make_train_step(model, tx, tk, sgd_hyper=sgd_hyper, grad_clip=CLIP)

    for i, (x, y) in enumerate(_tokens(4)):
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        assert jf == tf
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        tstate, tm = tstep(tstate, _torch_batch(x, y), LR, HP["damping"], **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        want = lm_state_dict_from_jax(_np_tree(jstate.params))
        got = model.state_dict()
        for key, w in want.items():
            w, g = w.numpy(), got[key].numpy()
            bound = 2e-5 * float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"step {i}: {key}")
    if use_kfac:
        assert tstate.kfac_state["step"] == STEPS
        assert set(tstate.kfac_state["factors"]["tok_embed"]) == {"A_diag", "G"}


def test_embedding_preconditioning_matches_jax():
    """The diagonal-A solve and its KL partial beside a dense layer."""
    from kfac_pytorch_tpu.ops import precondition as jp
    from kfac_pytorch_tpu_torch.ops import precondition as tp

    r = np.random.RandomState(5)

    def orth(n):
        return np.linalg.qr(r.randn(n, n))[0].astype(np.float32)

    eigen = {
        "emb": {"QG": orth(6), "dG": r.rand(6).astype(np.float32) + 0.1,
                "dA": r.rand(11).astype(np.float32)},
        "fc": {"QA": orth(7), "dA": r.rand(7).astype(np.float32) + 0.1,
               "QG": orth(5), "dG": r.rand(5).astype(np.float32) + 0.1},
    }
    gmats = {"fc": r.randn(5, 7).astype(np.float32), "emb": r.randn(6, 11).astype(np.float32)}
    jeig = jax.tree_util.tree_map(jnp.asarray, eigen)
    teig = {n: {k: torch.from_numpy(v) for k, v in e.items()} for n, e in eigen.items()}
    want = jp.precondition_all({n: jnp.asarray(g) for n, g in gmats.items()}, jeig, 0.003)
    assert tp.diag_a_names(teig) == {"emb"}
    for kind in ("dense", "auto"):
        got, vg = tp.precondition_all_with_vg(
            {n: torch.from_numpy(g) for n, g in gmats.items()}, teig, 0.003, kind=kind
        )
        assert list(got) == ["emb", "fc"]  # diagonal-A first, then the groups
        for n in gmats:
            w = np.asarray(want[n])
            np.testing.assert_allclose(got[n].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        if vg is not None:
            for n, t in zip(got, vg):
                np.testing.assert_allclose(float(t), float((got[n] * torch.from_numpy(gmats[n])).sum()),
                                           rtol=1e-6)


def test_loss_clip_and_data_helpers_match_jax():
    from kfac_pytorch_tpu.training import data as jdata
    from kfac_pytorch_tpu.training.step import clip_by_global_norm as jclip
    from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
    from kfac_pytorch_tpu_torch.training import data
    from kfac_pytorch_tpu_torch.training.step import clip_by_global_norm, softmax_cross_entropy

    r = np.random.RandomState(6)
    logits = r.randn(2, 5, 9).astype(np.float32) * 3
    labels = r.randint(0, 9, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6,
    )
    grads = {"a": r.randn(4, 3).astype(np.float32), "b": r.randn(7).astype(np.float32)}
    for max_norm in (0.25, 100.0):
        want = jclip({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
        got = clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    for kw in ({}, {"vocab_size": 50, "length": 3001, "seed": 3}):
        (js, jw), (ts, tw) = jdata.synthetic_corpus(**kw), data.synthetic_corpus(**kw)
        assert jw == tw and list(js) == list(ts)
        for split in js:
            np.testing.assert_array_equal(ts[split], js[split])
        jstream = jdata.batchify_tokens(js["train"], 4)
        tstream = data.batchify_tokens(ts["train"], 4)
        np.testing.assert_array_equal(tstream, jstream)
        for (jx, jy), (tx, ty) in zip(jdata.bptt_batches(jstream, 128),
                                      data.bptt_batches(tstream, 128), strict=True):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


TINY = ["--synthetic", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1",
        "--steps-per-epoch", "3", "--device", "cpu", "--kfac-embedding"]


@pytest.mark.parametrize("kfac_freq", ["2", "0"])
def test_lm_trainer_runs_on_cpu(kfac_freq):
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    hist = trainer.main([*TINY, "--kfac-update-freq", kfac_freq])
    assert len(hist["loss"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
    want = ["refresh", "capture", "refresh"] if kfac_freq == "2" else ["plain"] * 3
    assert hist["kind"] == want
    assert len(hist["val_loss"]) == 1 and math.isfinite(hist["val_loss"][0])


@pytest.mark.parametrize("argv,item", [
    (["--qkv-lens"], "item 8"),
    (["--remat"], "item 8"),
    (["--seq-parallel", "2"], "item 8"),
    (["--factor-sharding", "owner"], "item 7"),
    (["--factor-comm-dtype", "bf16"], "item 6"),
    (["--service-devices", "1"], "item 9d"),
    (["--tensor-parallel", "2"], "item 8b"),
    (["--fsdp", "1"], "item 8c"),
    (["--fsdp", "1", "--seq-parallel", "2"], "does not compose with --seq-parallel"),
    (["--moe-experts", "2"], "item 8b"),
])
def test_lm_trainer_refuses_flags_of_later_slices(argv, item):
    """Each flag was refused naming its ROADMAP item until that item was
    ported; item 6b's factor comm flags, item 7b's ``--factor-sharding``,
    item 8a's ``--qkv-lens`` and ``--remat``, item 8b's
    ``--moe-experts`` and item 8c's ``--fsdp 1`` (the 3-D world of one
    rank) now train (inert on one process: owner sharding
    warns and runs replicated, as in the JAX trainer), and
    ``--seq-parallel 2`` and ``--tensor-parallel 2`` need two ranks, as the
    JAX trainer needs two devices (they train on gloo ranks in
    ``test_torch_port_context.py`` and ``test_torch_port_moe.py``), and
    item 9d's ``--service-devices 1`` needs a rank left to train (the
    twins train with it on gloo ranks in ``test_torch_port_service.py``);
    ``--fsdp`` refuses ``--seq-parallel`` with the JAX trainer's message."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    if argv in (["--factor-comm-dtype", "bf16"], ["--factor-sharding", "owner"], ["--qkv-lens"],
                ["--remat"], ["--moe-experts", "2"], ["--fsdp", "1"]):
        hist = trainer.main([*TINY, *argv])
        assert len(hist["loss"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
        return
    if argv[0] in ("--seq-parallel", "--tensor-parallel"):
        with pytest.raises(SystemExit, match=f"{argv[0]} 2 must divide device count 1"):
            trainer.main([*TINY, *argv])
        return
    if argv[0] == "--service-devices":
        # the carve takes trailing ranks: one process leaves none to train
        with pytest.raises(ValueError, match="leaves no training devices"):
            trainer.main([*TINY, *argv])
        return
    with pytest.raises(SystemExit, match=item):
        trainer.main([*TINY, *argv])


@pytest.mark.parametrize("kwargs", [{"qkv_lens": True}, {"tensor_parallel": 2},
                                    {"remat": True}, {"moe_experts": 2}])
def test_lm_model_refuses_options_of_later_slices(kwargs):
    """Each option was refused naming its ROADMAP item until that item was
    ported: ``qkv_lens`` and ``remat`` (item 8a) and the shardwise options
    ``tensor_parallel`` and ``moe_experts`` (item 8b) now build and run."""
    model = transformer_lm.get_model(VOCAB, **MODEL_KW, **kwargs)
    (x, y), = _tokens(7, n=1)
    logits = model(torch.from_numpy(x.astype(np.int64)))
    softmax_cross_entropy(logits, torch.from_numpy(y.astype(np.int64))).backward()
    assert all(p.grad is not None for p in model.parameters())
