"""The port's CIFAR data, evaluation, logs and checkpoints, on the CPU.

* The CIFAR-10 loader, ``find_cifar10``, ``epoch_batches`` (shuffled and
  augmented), ``eval_batches`` (ragged tail) and the learnable stand-in
  ``synthetic_cifar_like`` against the JAX package, bit for bit (the port's
  NCHW images equal the JAX package's NHWC ones transposed), on
  ``cifar-10-batches-py`` pickles the test writes;
* the masked full-split evaluation sums and the BatchNorm recalibration
  against the JAX package's, on a ResNet-20 carried over with
  ``interop.state_dict_from_jax``, at 1e-5 relative;
* ``ScalarWriter``'s ``scalars.jsonl`` schema;
* a checkpoint round trip: saved, restored into a fresh state, and the run
  resumed from it goes on bit for bit as the uninterrupted run (CPU
  arithmetic repeats exactly); a kept ``SGDPlan`` would survive it, since
  every restored tensor keeps its storage;
* the trainer twin on that data with ``--device cpu``: it evaluates the
  whole split each epoch, logs, checkpoints, and a resumed run repeats the
  uninterrupted run's second epoch bit for bit.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.training import data as jdata
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import make_bn_recal_step as jmake_bn_recal_step
from kfac_pytorch_tpu.training.step import make_masked_eval_step as jmake_masked_eval_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import state_dict_from_jax
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training import data
from kfac_pytorch_tpu_torch.training.metrics import Metric, ScalarWriter
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_bn_recal_step,
    make_masked_eval_step,
    make_sgd,
    make_train_step,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_cifar(root, n_train, n_test, seed=0):
    """A ``cifar-10-batches-py`` directory under ``root``: five train batches
    of ``n_train`` images and a test batch of ``n_test`` (uint8 rows of
    3·32·32 channel-major pixels, integer labels)."""
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    r = np.random.RandomState(seed)
    for name, n in [(f"data_batch_{i}", n_train) for i in range(1, 6)] + [("test_batch", n_test)]:
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": r.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in r.randint(0, 10, n)]}, fh)
    return base


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


# ------------------------------------------------------------ data, bitwise


def test_cifar_data_matches_jax_bitwise(tmp_path):
    base = write_cifar(str(tmp_path), 7, 5)
    assert data.find_cifar10(str(tmp_path)) == str(tmp_path)
    assert data.find_cifar10(base) == base
    assert data.find_cifar10(str(tmp_path / "nothing")) is None and data.find_cifar10(None) is None
    for train in (True, False):
        jx, jy = jdata.load_cifar10(str(tmp_path), train)
        tx, ty = data.load_cifar10(str(tmp_path), train)
        assert tx.shape == (35 if train else 5, 3, 32, 32) and tx.dtype == np.float32
        np.testing.assert_array_equal(_nhwc(tx), jx)
        np.testing.assert_array_equal(ty, jy)
    jx, jy = jdata.load_cifar10(base, True)
    tx, ty = data.load_cifar10(base, True)
    for bs, shuffle, augment in [(8, True, True), (6, False, True), (5, True, False)]:
        jb = list(jdata.epoch_batches(jx, jy, bs, shuffle, augment, seed=3))
        tb = list(data.epoch_batches(tx, ty, bs, shuffle, augment, seed=3))
        assert len(tb) == len(jb) == 35 // bs
        for (a, b), (c, d) in zip(tb, jb):
            np.testing.assert_array_equal(_nhwc(a), c)
            np.testing.assert_array_equal(b, d)
    jb = list(jdata.eval_batches(jx, jy, 8))
    tb = list(data.eval_batches(tx, ty, 8))
    assert len(tb) == len(jb) == 5
    for (a, b, m), (c, d, n) in zip(tb, jb):
        np.testing.assert_array_equal(_nhwc(a), c)
        np.testing.assert_array_equal(b, d)
        np.testing.assert_array_equal(m, n)
    assert sum(m.sum() for _, _, m in tb) == 35


def test_synthetic_cifar_like_matches_jax_bitwise():
    kw = dict(n_train=40, n_test=12, num_classes=5, prototypes_per_class=3,
              label_noise=0.25, val_label_noise=0.1, seed=4)
    (jx, jy), (jvx, jvy) = jdata.synthetic_cifar_like(**kw)
    (tx, ty), (tvx, tvy) = data.synthetic_cifar_like(**kw)
    assert tx.shape == (40, 3, 32, 32) and tx.flags.c_contiguous
    for a, b in ((tx, jx), (tvx, jvx)):
        np.testing.assert_array_equal(_nhwc(a), b)
    for a, b in ((ty, jy), (tvy, jvy)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- evaluation, BN recal


def test_masked_eval_and_bn_recal_match_jax():
    jmodel = jresnet.get_model("resnet20")
    init = jnp.zeros((4, 32, 32, 3), jnp.float32)
    # jitted: one compile costs less than the eager ops' first dispatches
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=True))(jax.random.PRNGKey(5), init)
    params, stats = variables["params"], variables["batch_stats"]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    model = cifar_resnet.get_model("resnet20")
    model.load_state_dict(state_dict_from_jax(np_tree(params), np_tree(stats), "resnet20"))
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=None)
    tstate = TrainState(step=0, model=model, opt_state={})
    (x, y), _ = data.synthetic_cifar_like(n_train=11, n_test=1, seed=6)

    # two recalibration forwards move the running statistics off init
    jrecal, trecal = jmake_bn_recal_step(jmodel, {"train": True}), make_bn_recal_step(model)
    for lo in (0, 4):
        jstate = jrecal(jstate, jnp.asarray(_nhwc(x[lo:lo + 4])))
        tstate = trecal(tstate, torch.from_numpy(x[lo:lo + 4]))
    want = state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.batch_stats), "resnet20")
    got = model.state_dict()
    for key in want:
        if "running" in key:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert not np.allclose(got["bn1.running_var"].numpy(), 1.0)

    for ls in (0.0, 0.1):
        jeval = jmake_masked_eval_step(jmodel, label_smoothing=ls, eval_kwargs={"train": False})
        teval = make_masked_eval_step(model, label_smoothing=ls)
        jsum = np.zeros(3)
        tsum = np.zeros(3)
        for xb, yb, mb in data.eval_batches(x, y, 4):  # 11 images: a ragged tail of 3
            jm = jeval(jstate, (jnp.asarray(_nhwc(xb)), jnp.asarray(yb), jnp.asarray(mb)))
            tm = teval(tstate, (torch.from_numpy(xb), torch.from_numpy(yb), torch.from_numpy(mb)))
            jsum += [float(jm[k]) for k in ("loss_sum", "correct", "count")]
            tsum += [float(tm[k]) for k in ("loss_sum", "correct", "count")]
        assert tsum[2] == jsum[2] == 11
        np.testing.assert_allclose(tsum, jsum, rtol=1e-5)


# ---------------------------------------------------------------- logs


def test_scalar_writer_writes_the_jax_schema(tmp_path):
    w = ScalarWriter(str(tmp_path / "run"))
    w.add_scalar("train/loss", 1.5, 0)
    w.add_scalar("val/accuracy", np.float32(0.25), 3)
    w.close()
    rows = [json.loads(line) for line in open(tmp_path / "run" / "scalars.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("train/loss", 1.5, 0), ("val/accuracy", 0.25, 3)]
    assert all(set(r) == {"ts", "tag", "value", "step"} for r in rows)
    ScalarWriter(None).add_scalar("x", 1.0, 0)  # disabled: writes nothing
    m = Metric("m")
    for v in (1.0, 2.0, 4.5):
        m.update(v)
    assert m.avg == 2.5


# ----------------------------------------------------------- checkpoints


def _setup(seed):
    model = cifar_resnet.get_model("resnet20", generator=torch.Generator().manual_seed(seed))
    kfac = KFAC(layers=capture.discover_layers(model), kfac_update_freq=2, damping=0.003,
                track_diagnostics=True, device="cpu")
    tx = make_sgd(0.9, 5e-4)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    return kfac, state, make_train_step(model, tx, kfac, sgd_hyper=(0.9, 5e-4))


def _run(kfac, state, step_fn, batches, first):
    losses = []
    for i, (x, y) in enumerate(batches):
        state, m = step_fn(state, (x, y), 0.1, 0.003, **kfac_flags_for_step(first + i, kfac))
        losses.append(float(m["loss"]))
    return state, losses


def test_checkpoint_round_trip_resumes_bitwise(tmp_path):
    r = np.random.RandomState(7)
    batches = [(torch.from_numpy(r.randn(4, 3, 8, 8).astype(np.float32)),
                torch.from_numpy(r.randint(0, 10, 4).astype(np.int64))) for _ in range(5)]
    kfac, state, step_fn = _setup(0)
    state, _ = _run(kfac, state, step_fn, batches[:3], 0)
    path = ckpt.save_checkpoint(str(tmp_path), 2, state)
    assert os.path.basename(path) == "checkpoint-2" and not os.path.exists(path + ".tmp")
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    assert ckpt.latest_epoch(str(tmp_path)) == 2
    assert ckpt.latest_epoch(str(tmp_path / "none")) is None
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, want = _run(kfac, state, step_fn, batches[3:], 3)

    kfac2, fresh, step_fn2 = _setup(1)  # other weights: the restore must replace them
    params = {n: p.data_ptr() for n, p in fresh.model.named_parameters()}
    momenta = {n: m.data_ptr() for n, m in fresh.opt_state.items()}
    restored, epoch = ckpt.auto_resume(str(tmp_path), fresh)
    assert epoch == 3 and restored.step == 3 and restored.kfac_state["step"] == 3
    # restored in place: a kept SGDPlan's storages are still the tensors'
    assert {n: p.data_ptr() for n, p in restored.model.named_parameters()} == params
    assert {n: m.data_ptr() for n, m in restored.opt_state.items()} == momenta
    assert restored.opt_state is fresh.opt_state
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    weights = ckpt.restore_weights_only(str(tmp_path), 2)
    assert all(torch.equal(weights[k], saved[k]) for k in saved)
    _, got = _run(kfac2, restored, step_fn2, batches[3:], 3)
    assert got == want  # bit for bit

    # a target of another structure is refused, naming the entry
    other = KFAC(layers=capture.discover_layers(fresh.model), device="cpu")
    mismatched = TrainState(step=0, model=fresh.model, opt_state=fresh.opt_state,
                            kfac_state=other.init(fresh.model))
    with pytest.raises(ValueError, match="kfac_state"):
        ckpt.restore_checkpoint(str(tmp_path), 2, mismatched)


# ------------------------------------------------------------- the twin


def test_trainer_evaluates_logs_checkpoints_and_resumes_on_cpu(tmp_path):
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    write_cifar(str(tmp_path / "data"), 8, 21)
    common = ["--data-dir", str(tmp_path / "data"), "--model", "resnet20", "--batch-size", "8",
              "--val-batch-size", "8", "--device", "cpu", "--kfac-update-freq", "2",
              "--kfac-diagnostics", "--bn-recal-batches", "2", "--seed", "3"]
    full = trainer.main([*common, "--epochs", "2", "--log-dir", str(tmp_path / "logs"),
                         "--checkpoint-dir", str(tmp_path / "full")])
    assert len(full["loss"]) == 10 and full["kind"][:3] == ["refresh", "capture", "refresh"]
    assert full["val_count"] == [21, 21] and len(full["val_accuracy"]) == 2
    assert len(full["checkpoint_ms"]) == 2 and full["restore_ms"] == []
    assert all(0 < v <= 1 for v in full["kfac_nu"])
    assert min(full["kfac_min_damped_eig"]) >= 0.003 * (1 - 1e-6)
    assert sorted(os.listdir(tmp_path / "full")) == ["checkpoint-0", "checkpoint-1"]
    tags = {json.loads(line)["tag"] for line in open(tmp_path / "logs" / "scalars.jsonl")}
    assert {"train/loss", "train/accuracy", "train/lr", "val/loss", "val/accuracy",
            "kfac/nu_min", "kfac/nu_mean", "kfac/min_damped_eig", "kfac/cond_max_mean",
            "kfac/update_grad_cos_mean", "kfac/eigen_stale_steps_mean"} <= tags

    first = trainer.main([*common, "--epochs", "1", "--checkpoint-dir", str(tmp_path / "cut")])
    assert first["loss"] == full["loss"][:5]
    resumed = trainer.main([*common, "--epochs", "2", "--checkpoint-dir", str(tmp_path / "cut")])
    assert len(resumed["restore_ms"]) == 1 and len(resumed["loss"]) == 5
    assert resumed["loss"] == full["loss"][5:]  # bit for bit on the CPU
    assert resumed["val_loss"] == full["val_loss"][1:]
