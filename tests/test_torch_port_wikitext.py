"""The WikiText RNN slice: corpus, model, LM train step and trainer twin.

* ``build_corpus``/``find_wikitext`` on ``wiki.{train,valid,test}.tokens``
  files the test writes equal the JAX package's (the port's
  ``find_wikitext`` looks only in the directory it is given).
* ``RNNModel`` forward over two BPTT segments with the carry threaded, for
  all four ``RNN_TYPES``, tied (with a K-FAC embedding) and untied, with
  random flax weights carried through ``interop.rnn_state_dict_from_jax``
  (strict ``load_state_dict``: the extra biases are no parameters): logits
  and carries within 1e-5 of flax's.
* 3 ``make_lm_train_step`` steps of a tiny LSTM with a K-FAC embedding
  against the JAX package's, dropout 0, K-FAC on (``kfac_update_freq=2``)
  and off, at the recipe's momentum 0: each loss to 1e-5 relative, every
  parameter to ``|port − jax| ≤ 2e-5·max|jax| + 1e-6``.
* The twin on the CPU: synthetic and written WikiText data, ``--tied`` with
  and without ``--kfac-embedding``, the cell types, a bitwise resume with
  dropout on, and the refusals of later flags.
* The spectral split that decomposes factors wider than cuSOLVER's
  ``syevd`` takes (a WikiText-2 decoder's G), run here at a small
  ``limit``: eigenvalues against ``jnp.linalg.eigh`` within 1e-5 of the
  largest, ``Q diag(d) Qᵀ`` within 1e-5 of the matrix, ``QᵀQ`` within 1e-5
  of the identity, for a decaying PSD spectrum, a K-FAC-like identity plus
  low rank, an exact identity and an indefinite matrix, one and stacked,
  and with parts split again below the limit.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import wikitext_rnn as jrnn
from kfac_pytorch_tpu.training import data as jdata
from kfac_pytorch_tpu.training.lm_step import init_carry as jinit_carry
from kfac_pytorch_tpu.training.lm_step import make_lm_train_step as jmake_lm_train_step
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer
from kfac_pytorch_tpu_torch.interop import rnn_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import wikitext_rnn
from kfac_pytorch_tpu_torch.ops import eigh as teigh
from kfac_pytorch_tpu_torch.training import data
from kfac_pytorch_tpu_torch.training.lm_step import init_carry, make_lm_eval_step, make_lm_train_step
from kfac_pytorch_tpu_torch.training.step import TrainState, kfac_flags_for_step, make_sgd

VOCAB, D, LAYERS, BATCH, SEQ, STEPS = 40, 8, 2, 3, 5, 3
LR, MOMENTUM, WD, CLIP = 2.0, 0.0, 1e-5, 0.25
HP = dict(factor_decay=0.95, damping=0.003, kl_clip=0.001,
          fac_update_freq=1, kfac_update_freq=2)
TINY = ["--emsize", "8", "--nhid", "8", "--batch-size", "4", "--bptt", "6", "--epochs", "1",
        "--steps-per-epoch", "3", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_wikitext(root, seed=0, n_words=30):
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(n_words)]
    for split, lines in (("train", 40), ("valid", 12), ("test", 6)):
        with open(os.path.join(root, f"wiki.{split}.tokens"), "w", encoding="utf-8") as fh:
            for _ in range(lines):
                fh.write(" ".join(r.choice(words, size=r.randint(0, 12))) + " \n")
    return root


def test_build_corpus_and_find_wikitext_equal_jax(tmp_path):
    root = _write_wikitext(str(tmp_path / "wt"))
    got, gv = data.build_corpus(root)
    want, wv = jdata.build_corpus(root)
    assert gv == wv and set(got) == set(want) == {"train", "valid", "test"}
    for k in got:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert data.find_wikitext(root) == jdata.find_wikitext(root) == root
    assert data.find_wikitext(None) is None
    assert data.find_wikitext(str(tmp_path)) is None
    os.remove(os.path.join(root, "wiki.test.tokens"))
    assert set(data.build_corpus(root)[0]) == {"train", "valid"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_rnn(rnn_type, tied, seed, dropout=0.0):
    model = jrnn.get_model(rnn_type, VOCAB, D, D, LAYERS, dropout, tied, kfac_embedding=tied)
    tokens = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                        tokens, train=False)["params"]
    return model, tokens, params


def _randomized(params, seed):
    """Every leaf drawn from numpy (the biases non-zero)."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray((0.5 * r.randn(*v.shape)).astype(np.float32)), params)


def _port_rnn(rnn_type, tied, params, dropout=0.0):
    model = wikitext_rnn.get_model(rnn_type, VOCAB, D, D, LAYERS, dropout, tied,
                                   kfac_embedding=tied)
    model.load_state_dict(rnn_state_dict_from_jax(_np_tree(params), rnn_type))  # strict
    return model


def _flat_carry(carry):
    return [np.asarray(c) for c in jax.tree_util.tree_leaves(carry)]


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("rnn_type", wikitext_rnn.RNN_TYPES)
def test_rnn_forward_matches_flax_across_segments(rnn_type, tied):
    jmodel, tokens, params = _jax_rnn(rnn_type, tied, 0)
    params = _randomized(params, 170)
    model = _port_rnn(rnn_type, tied, params).eval()
    assert not any("zero_bias" in k for k in model.state_dict())
    apply = jax.jit(lambda p, x, c: jmodel.apply({"params": p}, x, carry=c, train=False))
    r = np.random.RandomState(171)
    jc, tc = jinit_carry(jmodel, params, tokens), init_carry(model, BATCH, "cpu")
    for _ in range(2):
        x = r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
        jl, jc = apply(params, jnp.asarray(x), jc)
        with torch.no_grad():
            tl, tc = model(torch.from_numpy(x.astype(np.int64)), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        tflat = [c.numpy() for x_ in tc for c in (x_ if isinstance(x_, tuple) else (x_,))]
        for a, b in zip(tflat, _flat_carry(jc)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kfac", [True, False])
def test_lm_train_steps_match_jax(use_kfac):
    jmodel = jrnn.get_model("LSTM", VOCAB, D, D, LAYERS, 0.0, False, kfac_embedding=True)
    tokens = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = jmodel.init({"params": jax.random.PRNGKey(2)}, tokens, train=False)["params"]
    model = wikitext_rnn.get_model("LSTM", VOCAB, D, D, LAYERS, 0.0, False, kfac_embedding=True)
    model.load_state_dict(rnn_state_dict_from_jax(_np_tree(params), "LSTM"))
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = tk = None
    if use_kfac:
        jk = JKFAC(layers=jcapture.discover_layers(jmodel, tokens, train=True), **HP)
        tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
        assert sorted(jk.layers) == sorted(tk.layers) == ["decoder", "encoder"]
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                         opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params) if jk else None)
    tstate = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                        kfac_state=tk.init(model) if tk else None)
    sgd_hyper = (MOMENTUM, WD) if use_kfac else None
    jstep = jmake_lm_train_step(jmodel, jtx, jk, grad_clip=CLIP, sgd_hyper=sgd_hyper)
    tstep = make_lm_train_step(model, tx, tk, grad_clip=CLIP, sgd_hyper=sgd_hyper)
    jc, tc = jinit_carry(jmodel, params, tokens), init_carry(model, BATCH, "cpu")
    r = np.random.RandomState(172)
    stream = r.randint(0, VOCAB, size=(BATCH, STEPS * SEQ + 1)).astype(np.int32)
    for i, (x, y) in enumerate(data.bptt_batches(stream, SEQ)):
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        assert jf == tf
        jstate, jc, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jc,
                               jax.random.PRNGKey(i), jnp.float32(LR),
                               jnp.float32(HP["damping"]), **jf)
        tstate, tc, tm = tstep(tstate, (torch.from_numpy(x.astype(np.int64)),
                                        torch.from_numpy(y.astype(np.int64))),
                               tc, None, LR, HP["damping"], **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["ppl"]), float(jm["ppl"]), rtol=1e-5)
        want = rnn_state_dict_from_jax(_np_tree(jstate.params), "LSTM")
        got = model.state_dict()
        for key, w in want.items():
            w, g = w.numpy(), got[key].numpy()
            bound = 2e-5 * float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"step {i}: {key}")
    assert i == STEPS - 1
    if use_kfac:
        assert tstate.kfac_state["step"] == STEPS
    m, _ = make_lm_eval_step(model)(tstate, (torch.from_numpy(x.astype(np.int64)),
                                             torch.from_numpy(y.astype(np.int64))), tc)
    assert math.isfinite(float(m["loss"]))


def test_dropout_masks_follow_the_generator():
    model = wikitext_rnn.get_model("GRU", VOCAB, D, D, LAYERS, 0.5, False).train()
    x = torch.randint(0, VOCAB, (BATCH, SEQ), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(x, None, torch.Generator().manual_seed(5))[0]
        b = model(x, None, torch.Generator().manual_seed(5))[0]
        c = model(x, None, torch.Generator().manual_seed(6))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    with pytest.raises(ValueError, match="nhid == ninp"):
        wikitext_rnn.get_model("LSTM", VOCAB, D, 2 * D, LAYERS, tied=True)


@pytest.mark.parametrize("argv,layers", [
    (["--synthetic"], "['decoder']"),
    (["--synthetic", "--tied", "--kfac-embedding"], "['encoder']"),
    (["--synthetic", "--model", "GRU", "--kfac-embedding"], "['encoder', 'decoder']"),
    (["--synthetic", "--model", "RNN_TANH", "--tied"], None),
])
def test_wikitext_trainer_runs_on_cpu(argv, layers, capsys):
    hist = trainer.main([*argv, *TINY, "--kfac-update-freq", "2"])
    out = capsys.readouterr().out
    assert len(hist["loss"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
    if layers is None:
        assert "no preconditionable layers" in out and "running plain SGD" in out
        assert hist["kind"] == ["plain"] * 3
    else:
        assert f"K-FAC layers: {layers}" in out
        assert hist["kind"] == ["refresh", "capture", "refresh"]
    assert len(hist["val_loss"]) == 1 and math.isfinite(hist["val_loss"][0])
    assert hist["val_ppl"][0] == pytest.approx(math.exp(hist["val_loss"][0]))


def test_wikitext_trainer_reads_data_and_resumes_bitwise(tmp_path, capsys):
    root = _write_wikitext(str(tmp_path / "wt"), seed=1)
    common = ["--data-dir", root, "--model", "LSTM", "--emsize", "8", "--nhid", "8",
              "--batch-size", "2", "--bptt", "5", "--steps-per-epoch", "3",
              "--kfac-update-freq", "2", "--kfac-embedding", "--device", "cpu"]
    ck_a, ck_b = str(tmp_path / "a"), str(tmp_path / "b")
    full = trainer.main([*common, "--epochs", "2", "--checkpoint-dir", ck_a])
    assert f"vocab={len(data.build_corpus(root)[1])}" in capsys.readouterr().out
    trainer.main([*common, "--epochs", "1", "--checkpoint-dir", ck_b])
    resumed = trainer.main([*common, "--epochs", "2", "--checkpoint-dir", ck_b])
    assert "resumed from epoch 0" in capsys.readouterr().out
    assert resumed["loss"] == full["loss"][3:]
    assert resumed["val_loss"] == full["val_loss"][1:]
    trainer.main(["--data-dir", str(tmp_path / "none"), *TINY])
    assert "no wikitext data found; falling back to --synthetic" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["--factor-sharding", "owner"], "item 7"),
    (["--factor-comm-dtype", "bf16"], "item 6"),
    (["--preempt-save-dir", "d"], "item 9c"),
    (["--profile", "safe"], "item 9b"),
])
def test_wikitext_trainer_refuses_flags_of_later_slices(argv, item):
    """Each flag was refused naming its ROADMAP item until that item was
    ported; item 6b's factor comm flags, item 7b's ``--factor-sharding``,
    item 9b's ``--profile`` and item 9c's ``--preempt-save-dir`` now parse
    onto their arguments."""
    if argv[0] == "--preempt-save-dir":
        args = trainer.parse_args(argv)
        assert args.preempt_save_dir == argv[1] and args.snapshot_every == 0
        return
    if argv[0] == "--profile":
        assert trainer.parse_args(argv).profile == argv[1]
        return
    if argv[0] == "--factor-comm-dtype":
        assert trainer.parse_args(argv).factor_comm_dtype == argv[1]
        return
    if argv[0] == "--factor-sharding":
        args = trainer.parse_args(argv)
        assert args.factor_sharding == argv[1] and args.comm_overlap is False
        return
    with pytest.raises(SystemExit, match=item):
        trainer.parse_args(argv)


def _split_case(kind, n, r):
    if kind == "decaying":
        x = r.randn(n, n // 4)
        return x @ np.diag(1.0 / np.arange(1, n // 4 + 1)) @ x.T / n
    if kind == "identity_plus_low_rank":  # a G factor after one capture step
        x = r.randn(n, 12)
        return 0.95 * np.eye(n) + 0.05 * (x @ x.T)
    if kind == "identity":
        return np.eye(n)
    x = r.randn(n, n)
    return (x + x.T) / 2


@pytest.mark.parametrize("kind,leaf", [("decaying", 120), ("identity_plus_low_rank", 120),
                                       ("identity", 120), ("indefinite", 120), ("decaying", 50)])
def test_eigh_split_beyond_the_syevd_limit(monkeypatch, kind, leaf):
    """``leaf`` 50: parts wider than 50 (and up to the limit) split again."""
    monkeypatch.setattr(teigh, "SPLIT_LEAF_N", leaf)
    n, limit = 160, 120
    r = np.random.RandomState(175)
    mats = np.stack([_split_case(kind, n, r) for _ in range(2)]).astype(np.float32)
    got_d, got_q = teigh.eigh_symmetric(torch.from_numpy(mats), limit=limit)
    assert got_d.shape == (2, n) and got_q.shape == (2, n, n)
    for a, d, q in zip(mats, got_d.numpy(), got_q.numpy()):
        want = np.asarray(jnp.linalg.eigh(jnp.asarray(a))[0])
        top = float(np.abs(want).max())
        np.testing.assert_allclose(d, want, rtol=0, atol=1e-5 * top)
        assert np.all(np.diff(d) >= 0)
        np.testing.assert_allclose(q @ np.diag(d) @ q.T, a, rtol=0, atol=1e-5 * top)
        np.testing.assert_allclose(q.T @ q, np.eye(n), rtol=0, atol=1e-5)
    d1, q1 = teigh.eigh_symmetric(torch.from_numpy(mats[0]), limit=limit)
    torch.testing.assert_close(d1, got_d[0], rtol=0, atol=0)
