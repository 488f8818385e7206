"""The trainer twins' bf16 flags and the ImageNet and LM twins' bookkeeping.

* Both image twins take ``--bf16``, ``--eigen-dtype`` and
  ``--precond-precision`` into their model and ``KFAC``; the CIFAR twin
  trains with all three on the CPU.
* The ImageNet twin: ``--batches-per-allreduce 2`` and ``--precond-method
  inverse`` each hold against the JAX package for 2 steps of the tiny
  ResNeXt of ``tests/test_torch_port_imagenet.py`` (its bounds: each loss
  to 1e-5 relative, every tensor to ``2e-5·max|jax| + 1e-6``);
  ``--log-dir`` writes ``scalars.jsonl`` with the JAX trainer's tags;
  ``--checkpoint-dir`` resumes an interrupted run, which then repeats the
  uninterrupted run's losses bit for bit (the CPU is deterministic), in
  the bf16 modes, whose state holds bfloat16 eigenvectors.
* The LM twin: ``--kfac-diagnostics`` with ``--log-dir`` writes the JAX
  trainer's tags (the per-epoch mean of every ``kfac_*`` diagnostic of
  the JAX package's registry); ``--checkpoint-dir`` resumes bit for bit.
* A checkpoint of a state with bfloat16 ``Q*`` (or ``iA``/``iG``) restores
  bitwise with ``weights_only=True``; a restore into a run of the other
  ``--eigen-dtype`` raises, naming both types.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.observability.diagnostics import SCALAR_KEYS as JAX_DIAG_KEYS
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar_trainer
from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as imagenet_trainer
from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
from kfac_pytorch_tpu_torch.interop import imagenet_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.models.layers import KFACConv
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
)
from tests.test_torch_port_imagenet import (
    CLASSES, HP, LR, MOMENTUM, SIZE, SMOOTH, TINY, WD, _nchw, _np_tree, _tiny_pair,
)

PRECISION_FLAGS = ["--bf16", "--eigen-dtype", "bf16", "--precond-precision", "default"]
IMAGENET_CPU = ["--synthetic", "--model", "tiny_resnext", "--image-size", "32",
                "--batch-size", "2", "--device", "cpu", "--kfac-update-freq", "2"]
LM_CPU = ["--synthetic", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
          "--seq-len", "16", "--batch-size", "2", "--kfac-embedding", "--device", "cpu",
          "--kfac-update-freq", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_in_the_zoo(monkeypatch):
    """The tiny ResNeXt under a zoo name, so the trainer twin's own code
    path runs it on the CPU in seconds."""
    monkeypatch.setitem(imagenet_resnet._MODELS, "tiny_resnext",
                        (imagenet_resnet.Bottleneck, (1, 1), 4, 4))


# ------------------------------------------------------------ the bf16 flags


@pytest.mark.parametrize("twin", ["cifar", "imagenet"])
def test_image_twins_take_the_bf16_flags(twin, tiny_in_the_zoo):
    trainer, base = ((cifar_trainer, ["--synthetic", "--model", "resnet20", "--device", "cpu"])
                     if twin == "cifar" else (imagenet_trainer, IMAGENET_CPU))
    args = trainer.parse_args([*base, *PRECISION_FLAGS])
    assert (args.bf16, args.eigen_dtype, args.precond_precision) == (True, "bf16", "default")
    model, kfac, state, _ = trainer.build(args, torch.device("cpu"))
    convs = [m for m in model.modules() if isinstance(m, KFACConv)]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (kfac.eigen_dtype, kfac.precond_precision) == (torch.bfloat16, "default")
    qa = next(e["QA"] for e in state.kfac_state["eigen"].values() if "QA" in e)
    assert qa.dtype == torch.bfloat16
    plain = trainer.parse_args(base)
    assert (plain.bf16, plain.eigen_dtype, plain.precond_precision) == (False, "f32", None)
    with pytest.raises(SystemExit):
        trainer.parse_args([*base, "--eigen-dtype", "fp16"])


def test_cifar_twin_trains_in_the_bf16_modes():
    hist = cifar_trainer.main(["--synthetic", "--model", "resnet20", "--batch-size", "8",
                               "--epochs", "1", "--steps-per-epoch", "4", "--device", "cpu",
                               "--kfac-update-freq", "2", *PRECISION_FLAGS])
    assert hist["kind"] == ["refresh", "capture"] * 2
    assert all(np.isfinite(hist["loss"]))


# ------------------------------------------------- ImageNet options vs JAX


IMAGENET_OPTIONS = {
    "accum": (dict(), dict(accum_steps=2)),
    "inverse": (dict(precond_method="inverse"), dict()),
}


@pytest.mark.parametrize("option", list(IMAGENET_OPTIONS))
def test_imagenet_options_match_jax(option):
    """2 steps (a refresh, a capture step) of the tiny ResNeXt with the
    option the ImageNet twin's ``--batches-per-allreduce 2`` or
    ``--precond-method inverse`` builds, in both packages."""
    kfac_kw, step_kw = IMAGENET_OPTIONS[option]
    accum = step_kw.get("accum_steps", 1)
    batch = 4
    jmodel, init, params, stats, model = _tiny_pair(0)
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = JKFAC(layers=jcapture.discover_layers(jmodel, init[: batch // accum], train=True),
               **HP, **kfac_kw)
    tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP, **kfac_kw)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params))
    tstate = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                        kfac_state=tk.init(model))
    jstep = jmake_train_step(jmodel, jtx, jk, label_smoothing=SMOOTH,
                             train_kwargs={"train": True}, sgd_hyper=(MOMENTUM, WD), **step_kw)
    tstep = make_train_step(model, tx, tk, sgd_hyper=(MOMENTUM, WD), label_smoothing=SMOOTH,
                            **step_kw)
    r = np.random.RandomState(170)
    for i in range(2):
        x = r.randn(batch, SIZE, SIZE, 3).astype(np.float32)
        y = r.randint(0, CLASSES, size=batch).astype(np.int32)
        xt, yt = _nchw(x), torch.from_numpy(y)
        if accum > 1:
            x, y = x.reshape(accum, -1, *x.shape[1:]), y.reshape(accum, -1)
            xt, yt = xt.reshape(accum, -1, *xt.shape[1:]), yt.reshape(accum, -1)
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        assert jf == tf
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        tstate, tm = tstep(tstate, (xt, yt), LR, HP["damping"], **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        want = imagenet_state_dict_from_jax(_np_tree(jstate.params),
                                            _np_tree(jstate.batch_stats), TINY)
        got = model.state_dict()
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            w, g = w.numpy(), got[key].numpy()
            bound = 2e-5 * float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"step {i}: {key}")


def test_imagenet_twin_runs_the_options(tiny_in_the_zoo, tmp_path):
    """The twin's own loop with both options (and the bf16 modes):
    ``--batches-per-allreduce 2`` feeds [2, batch] microbatches, the inverse
    method keeps its inverses in bfloat16; ``--log-dir`` writes the JAX
    trainer's tags per epoch."""
    logs = str(tmp_path / "logs")
    hist = imagenet_trainer.main([
        *IMAGENET_CPU, "--epochs", "2", "--steps-per-epoch", "2",
        "--batches-per-allreduce", "2", "--precond-method", "inverse", *PRECISION_FLAGS,
        "--log-dir", logs,
    ])
    assert hist["kind"] == ["refresh", "capture"] * 2
    assert all(np.isfinite(hist["loss"])) and len(hist["accuracy"]) == 4
    with open(os.path.join(logs, "scalars.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert {r["tag"] for r in rows} == {"train/loss", "train/accuracy", "train/lr"}
    assert sorted({r["step"] for r in rows}) == [0, 1]
    assert all(set(r) == {"ts", "tag", "value", "step"} for r in rows)


# ------------------------------------------------------------- checkpoints


def _resume_repeats(trainer, argv, tmp_path, epochs=2):
    """Run ``argv`` for ``epochs`` epochs with a checkpoint directory, then
    again from only its ``checkpoint-0``: the resumed epochs' losses."""
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    whole = trainer.main([*argv, "--epochs", str(epochs), "--checkpoint-dir", full])
    assert sorted(os.listdir(full)) == [f"checkpoint-{e}" for e in range(epochs)]
    os.makedirs(cut)
    shutil.copy(ckpt.checkpoint_path(full, 0), cut)
    resumed = trainer.main([*argv, "--epochs", str(epochs), "--checkpoint-dir", cut])
    assert len(resumed["restore_ms"]) == 1
    return whole, resumed


def test_imagenet_twin_resume_repeats_the_run(tiny_in_the_zoo, tmp_path):
    argv = [*IMAGENET_CPU, "--steps-per-epoch", "3", *PRECISION_FLAGS]
    whole, resumed = _resume_repeats(imagenet_trainer, argv, tmp_path)
    assert resumed["loss"] == whole["loss"][3:]  # bit for bit
    assert resumed["kind"] == whole["kind"][3:]


def test_lm_twin_resume_repeats_the_run(tmp_path):
    argv = [*LM_CPU, "--steps-per-epoch", "3"]
    whole, resumed = _resume_repeats(lm_trainer, argv, tmp_path)
    assert resumed["loss"] == whole["loss"][3:]
    assert resumed["val_loss"] == whole["val_loss"][1:]


def test_lm_twin_logs_the_jax_diagnostic_tags(tmp_path):
    logs = str(tmp_path / "logs")
    hist = lm_trainer.main([*LM_CPU, "--epochs", "1", "--steps-per-epoch", "3",
                            "--kfac-diagnostics", "--log-dir", logs])
    with open(os.path.join(logs, "scalars.jsonl")) as fh:
        tags = {json.loads(line)["tag"] for line in fh}
    diag = {f"kfac/{k}_mean" for k in (*JAX_DIAG_KEYS, "cond_max")}
    assert tags == {"train/loss", "train/ppl", "val/loss", "val/ppl"} | diag
    assert len(hist["kfac_nu"]) == 3 and all(0.0 < v <= 1.0 for v in hist["kfac_nu"])
    lm_trainer.parse_args([*LM_CPU, "--checkpoint-dir", "c", "--log-dir", "l"])


@pytest.mark.parametrize("method", ["eigen", "inverse"])
def test_bf16_state_checkpoint_round_trips_and_keeps_its_eigen_dtype(method, tmp_path):
    from tests.test_torch_port_kfac import LAYERS, ConvDenseNet, _problem

    a_c, g_s, _, tgrads = _problem(171)

    def state(eigen_dtype):
        model = ConvDenseNet()
        kfac = KFAC(layers=list(LAYERS), precond_method=method, eigen_dtype=eigen_dtype,
                    device="cpu")
        tx = make_sgd(0.9, 0.0)
        return TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                          kfac_state=kfac.init(model)), kfac

    saved, kfac = state(torch.bfloat16)
    _, kstate = kfac.update(tgrads, saved.kfac_state,
                            a_contribs={n: torch.from_numpy(v) for n, v in a_c.items()},
                            g_factor_stats={n: torch.from_numpy(v) for n, v in g_s.items()},
                            lr=0.1, damping=0.003, update_factors=True, update_eigen=True)
    saved = TrainState(step=1, model=saved.model, opt_state=saved.opt_state, kfac_state=kstate)
    ckpt.save_checkpoint(str(tmp_path), 0, saved)
    key = "iA" if method == "inverse" else "QA"
    restored = ckpt.restore_checkpoint(str(tmp_path), 0, state(torch.bfloat16)[0])
    for n, e in saved.kfac_state["eigen"].items():
        for k, v in e.items():
            got = restored.kfac_state["eigen"][n][k]
            assert got.dtype == v.dtype and torch.equal(got, v), (n, k)
    assert restored.kfac_state["eigen"]["c0"][key].dtype == torch.bfloat16
    assert restored.kfac_state["eigen"]["c0"][key].any()
    with pytest.raises(ValueError, match=r"saved torch.bfloat16 .*target holds torch.float32"):
        ckpt.restore_checkpoint(str(tmp_path), 0, state(torch.float32)[0])
