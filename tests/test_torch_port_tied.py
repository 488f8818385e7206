"""The tied embedding/decoder head and its reduce lens against the JAX package.

* ``compute_g_diag`` equals the JAX package's (``[N, V]`` and ``[B, T, V]``
  gradients, batch-averaged or not), to 1e-6 relative.
* ``KFACEmbed.attend`` and the reduce lens: one captured forward/backward of
  a tied RNN LM (LSTM, K-FAC embedding, random weights) gives the shared
  table's factors — A = the lookup's token frequencies + the decoder's
  logit-gradient diagonal, G = the lookup's output-gradient covariance + the
  decoder's query covariance — equal to JAX's ``capture.a_contribs`` and
  ``capture.g_factors`` with ``perturb_grads``/``captured`` on the same
  inputs (A to 1e-6, G to 1e-5 of its largest entry), and the table's
  gradient (summed over both use sites) to JAX's.
* One train step (capture and refresh) of a tied transformer LM with a
  K-FAC embedding matches the JAX package's: the loss to 1e-5 relative,
  every parameter to ``|port − jax| ≤ 2e-5·max|jax| + 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.models import wikitext_rnn as jrnn
from kfac_pytorch_tpu.models.layers import KFAC_ACTS, PERTURBATIONS
from kfac_pytorch_tpu.ops import factors as jfactors
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import lm_state_dict_from_jax, rnn_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import transformer_lm, wikitext_rnn
from kfac_pytorch_tpu_torch.ops import factors
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
    softmax_cross_entropy,
)

VOCAB, D, BATCH, SEQ = 48, 8, 3, 6


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


@pytest.mark.parametrize("batch_averaged", [True, False])
@pytest.mark.parametrize("shape", [(7, 11), (2, 5, 11)])
def test_compute_g_diag_matches_jax(shape, batch_averaged):
    g = np.random.RandomState(180).randn(*shape).astype(np.float32)
    got = factors.compute_g_diag(torch.from_numpy(g), batch_averaged)
    want = jfactors.compute_g_diag(jnp.asarray(g), batch_averaged)
    assert got.shape == (shape[-1],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    dense = factors.compute_g_dense(torch.from_numpy(g), batch_averaged)
    np.testing.assert_allclose(got.numpy(), torch.diagonal(dense).numpy(), rtol=1e-5)


def test_reduce_lens_factors_match_jax():
    jmodel = jrnn.get_model("LSTM", VOCAB, D, D, 1, 0.0, True, kfac_embedding=True)
    r = np.random.RandomState(181)
    tokens = r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    targets = r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    params = jmodel.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(tokens),
                         train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray((0.5 * r.randn(*v.shape)).astype(np.float32)), params)
    names = jcapture.discover_layers(jmodel, jnp.asarray(tokens), train=True)
    assert names == ["encoder"]
    perts = jcapture.perturbation_zeros(jmodel, jnp.asarray(tokens), train=True)

    def loss_fn(p, pt):
        (logits, _), mut = jmodel.apply({"params": p, PERTURBATIONS: pt}, jnp.asarray(tokens),
                                        train=True, mutable=[KFAC_ACTS])
        return jce(logits.reshape(-1, VOCAB), jnp.asarray(targets).reshape(-1)), mut

    (jloss, mut), (jgrads, gperts) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, perts)
    want_a = jcapture.a_contribs(mut[KFAC_ACTS], names, perturb_grads=gperts,
                                 batch_averaged=True)["encoder"]
    want_g = jcapture.g_factors(gperts, names, True, captured=mut[KFAC_ACTS])["encoder"]

    model = wikitext_rnn.get_model("LSTM", VOCAB, D, D, 1, 0.0, True, kfac_embedding=True)
    model.load_state_dict(rnn_state_dict_from_jax(_np_tree(params), "LSTM"))
    cap = capture.Capture(model, capture.discover_layers(model))
    with cap.capturing("auto"):
        logits, _ = model(torch.from_numpy(tokens.astype(np.int64)))
        loss = softmax_cross_entropy(logits, torch.from_numpy(targets.astype(np.int64)))
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    got_a, got_g = cap.a_contribs["encoder"], cap.g_factor_stats["encoder"]
    assert got_a.shape == (VOCAB,) and got_g.shape == (D, D)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-7)
    w = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    # both use sites contribute: the lookup's statistics alone differ
    lookup_a = factors.compute_a_embed(torch.from_numpy(tokens), VOCAB)
    assert not torch.allclose(got_a, lookup_a)
    w = np.asarray(jgrads["encoder"]["embedding"])
    np.testing.assert_allclose(model.encoder.weight.grad.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    cap.remove()
    with torch.no_grad():  # no hook left: attend is a plain product
        torch.testing.assert_close(model.encoder.attend(torch.ones(2, D)),
                                   torch.ones(2, D) @ model.encoder.weight.T)


def test_tied_transformer_step_matches_jax():
    kw = dict(max_len=SEQ, d_model=16, n_heads=2, n_layers=1, kfac_embedding=True,
              tie_embeddings=True)
    hp = dict(factor_decay=0.95, damping=0.003, kl_clip=0.001, fac_update_freq=1,
              kfac_update_freq=2)
    lr, clip = 0.1, 0.25
    jmodel = jlm.get_model(VOCAB, **kw)
    init = jnp.zeros((BATCH, SEQ), jnp.int32)
    # jitted: one compile costs less than the eager ops' first dispatches
    params = jax.jit(lambda k, x: jmodel.init(k, x, train=True))(jax.random.PRNGKey(4),
                                                                 init)["params"]
    assert "decoder" not in params
    model = transformer_lm.get_model(VOCAB, **kw)
    model.load_state_dict(lm_state_dict_from_jax(_np_tree(params)))  # strict
    assert model.decoder is None
    jtx, tx = jmake_sgd(0.9, 1e-5), make_sgd(0.9, 1e-5)
    jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), **hp)
    tk = KFAC(layers=capture.discover_layers(model), device="cpu", **hp)
    assert "tok_embed" in jk.layers and "tok_embed" in tk.layers
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                         opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params))
    tstate = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                        kfac_state=tk.init(model))
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True}, grad_clip=clip,
                             sgd_hyper=(0.9, 1e-5))
    tstep = make_train_step(model, tx, tk, sgd_hyper=(0.9, 1e-5), grad_clip=clip)
    r = np.random.RandomState(182)
    x = r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    y = r.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
    jf, tf = jflags(0, jk), kfac_flags_for_step(0, tk)
    assert jf == tf and tf["update_eigen"]
    jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(lr),
                       jnp.float32(hp["damping"]), **jf)
    tstate, tm = tstep(tstate, (torch.from_numpy(x.astype(np.int64)),
                                torch.from_numpy(y.astype(np.int64))), lr, hp["damping"], **tf)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = lm_state_dict_from_jax(_np_tree(jstate.params))
    got = model.state_dict()
    assert set(want) == set(got)
    for key, w in want.items():
        w, g = w.numpy(), got[key].numpy()
        bound = 2e-5 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=key)
    want_a = np.asarray(jstate.kfac_state["factors"]["tok_embed"]["A_diag"])
    np.testing.assert_allclose(tstate.kfac_state["factors"]["tok_embed"]["A_diag"].numpy(),
                               want_a, rtol=1e-5, atol=1e-7)
