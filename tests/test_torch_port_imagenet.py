"""The ImageNet slice: ResNet/ResNeXt models, interop, train steps, trainer.

* ``interop.imagenet_state_dict_from_jax`` is bitwise: at
  ``resnext50_32x4d`` and ``resnet18`` (and the tiny test model, named by
  ``(block, stage_sizes)``) the JAX package's ``convert_state_dict`` gives
  the JAX trees back exactly. Tree shapes come from ``jax.eval_shape`` and
  values from numpy, so no full-size model is compiled.
* The nine architectures build with torchvision's parameter counts.
* On a tiny ResNeXt (``ImageNetResNet(Bottleneck, (1, 1), groups=4,
  width_per_group=4)``, 32×32 images, batch 4), ``discover_layers`` gives
  the JAX package's pseudo-layer set (module paths spelled the torchvision
  way), the eval forward matches, and 2 train steps (a refresh, a capture
  step) with label smoothing 0.1 match the JAX package with K-FAC on
  (``kfac_update_freq=2``) and off.
* The trainer twin runs 3 CPU steps; its unported flags raise naming their
  ROADMAP items. ``diag_warmup`` with one diagonal block changes nothing.

Tolerances as ``tests/test_torch_port_train.py``: each loss to 1e-5
relative, every tensor to ``|port − jax| ≤ 2e-5·max|jax| + 1e-6``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import imagenet_resnet as jir
from kfac_pytorch_tpu.torch_interop import convert_state_dict
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_eval_step as jmake_eval_step
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import imagenet_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import imagenet_resnet
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_eval_step,
    make_sgd,
    make_train_step,
)

TINY = ("bottleneck", (1, 1))
BATCH, SIZE, STEPS, CLASSES = 4, 32, 2, 10
LR, MOMENTUM, WD, SMOOTH = 0.1, 0.9, 5e-5, 0.1
HP = dict(lr=LR, factor_decay=0.95, damping=0.003, kl_clip=0.001,
          fac_update_freq=1, kfac_update_freq=2)


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


def _jax_tiny():
    return jir.ImageNetResNet(block=jir.Bottleneck, stage_sizes=TINY[1], groups=4,
                              width_per_group=4, num_classes=CLASSES)


def _port_tiny():
    return imagenet_resnet.ImageNetResNet(imagenet_resnet.Bottleneck, TINY[1], CLASSES, 4, 4)


def _jax_init(seed):
    model = _jax_tiny()
    init = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    # jitted: one compile instead of op-by-op dispatch of the whole init
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(jax.random.PRNGKey(seed), init)
    return model, init, variables["params"], variables["batch_stats"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _random_trees(model, seed):
    """``(params, batch_stats)`` of ``model``'s shapes filled from numpy."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True)
    )
    r = np.random.RandomState(seed)
    fill = lambda s: r.randn(*s.shape).astype(np.float32)  # noqa: E731
    return (jax.tree_util.tree_map(fill, shapes["params"]),
            jax.tree_util.tree_map(fill, shapes["batch_stats"]))


@pytest.mark.parametrize("arch", ["resnext50_32x4d", "resnet18", "tiny"])
def test_imagenet_state_dict_from_jax_round_trips_bitwise(arch):
    if arch == "tiny":
        jmodel, port, spec = _jax_tiny(), _port_tiny(), TINY
    else:
        jmodel, spec = jir.get_model(arch), arch
        with torch.device("meta"):
            port = imagenet_resnet.ImageNetResNet(*imagenet_resnet._MODELS[arch][:2], 1000,
                                                  *imagenet_resnet._MODELS[arch][2:])
        port = port.to_empty(device="cpu")
    p, s = _random_trees(jmodel, 140)
    sd = imagenet_state_dict_from_jax(p, s, spec)
    port.load_state_dict(sd)  # strict: every key, every shape
    if arch == "tiny":
        return  # convert_state_dict knows the zoo only
    back_p, back_s = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, arch)
    for want, got in ((p, back_p), (s, back_s)):
        wl, wt = jax.tree_util.tree_flatten(want)
        gl, gt = jax.tree_util.tree_flatten(got)
        assert wt == gt
        for a, b in zip(wl, gl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        imagenet_state_dict_from_jax(p, s, "resnet19")


TORCHVISION_PARAMS = {
    "resnet18": 11689512, "resnet34": 21797672, "resnet50": 25557032,
    "resnet101": 44549160, "resnet152": 60192808, "resnext50_32x4d": 25028904,
    "resnext101_32x8d": 88791336, "wide_resnet50_2": 68883240,
    "wide_resnet101_2": 126886696,
}


def test_all_nine_architectures_build():
    assert set(imagenet_resnet._MODELS) == set(jir._MODELS) == set(TORCHVISION_PARAMS)
    for name, (block, sizes, groups, width) in imagenet_resnet._MODELS.items():
        with torch.device("meta"):
            model = imagenet_resnet.ImageNetResNet(block, sizes, 1000, groups, width)
        assert sum(p.numel() for p in model.parameters()) == TORCHVISION_PARAMS[name], name
        grouped = capture.group_counts(capture.discover_layers(model))
        assert grouped == ({f"layer{s + 1}.{i}.conv2": groups
                            for s, n in enumerate(sizes) for i in range(n)}
                           if groups > 1 else {})
    with pytest.raises(ValueError, match="unknown imagenet model"):
        imagenet_resnet.get_model("resnext9")


def _port_name(jname, stages):
    """A JAX layer path of the ImageNet ResNet, spelled the port's way."""
    head, _, group = jname.partition("#")
    parts = head.split("/")
    names = {"KFACConv_0": "conv1", "KFACDense_0": "fc"}
    if len(parts) == 1:
        out = names[parts[0]]
    else:
        b = int(parts[0].rpartition("_")[2])
        stage = next(s for s in range(len(stages)) if b < sum(stages[: s + 1]))
        j = int(parts[1].rpartition("_")[2])
        conv = "downsample.0" if j == 3 else f"conv{j + 1}"
        out = f"layer{stage + 1}.{b - sum(stages[:stage])}.{conv}"
    return f"{out}#{group}" if group else out


def test_discover_layers_matches_jax():
    init = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    jnames = jcapture.discover_layers(_jax_tiny(), init, train=True)
    names = capture.discover_layers(_port_tiny())
    assert len(names) == len(set(names)) == 16
    assert {_port_name(n, TINY[1]) for n in jnames} == set(names)
    assert capture.group_counts(names) == {"layer1.0.conv2": 4, "layer2.0.conv2": 4}


def _tiny_pair(seed):
    jmodel, init, params, stats = _jax_init(seed)
    model = _port_tiny()
    model.load_state_dict(imagenet_state_dict_from_jax(_np_tree(params), _np_tree(stats), TINY))
    return jmodel, init, params, stats, model


def test_eval_forward_matches_jax():
    """Inference mode: BatchNorm normalizes with the carried running stats."""
    jmodel, _, params, stats = _jax_init(2)
    r = np.random.RandomState(141)
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.abs(r.randn(*v.shape)).astype(np.float32) + 0.5), stats
    )
    model = _port_tiny()
    model.load_state_dict(imagenet_state_dict_from_jax(_np_tree(params), _np_tree(stats), TINY))
    x = r.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = r.randint(0, CLASSES, size=BATCH).astype(np.int32)
    want = jmake_eval_step(jmodel, label_smoothing=SMOOTH, eval_kwargs={"train": False})(
        JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                    opt_state=None), (jnp.asarray(x), jnp.asarray(y)))
    got = make_eval_step(model, label_smoothing=SMOOTH)(None, (_nchw(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["accuracy"]), float(want["accuracy"]))
    logits = jax.jit(lambda v: jmodel.apply({"params": params, "batch_stats": stats}, v,
                                            train=False))(jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(model(_nchw(x)).numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_kfac", [True, False])
def test_tiny_resnext_train_steps_match_jax(use_kfac):
    jmodel, init, params, stats, model = _tiny_pair(0)
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = tk = None
    if use_kfac:
        jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), **HP)
        tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params) if jk else None,
    )
    tstate = TrainState(
        step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=tk.init(model) if tk else None,
    )
    sgd_hyper = (MOMENTUM, WD) if use_kfac else None
    jstep = jmake_train_step(jmodel, jtx, jk, label_smoothing=SMOOTH,
                             train_kwargs={"train": True}, sgd_hyper=sgd_hyper)
    tstep = make_train_step(model, tx, tk, sgd_hyper=sgd_hyper, label_smoothing=SMOOTH)
    r = np.random.RandomState(142)
    for i in range(STEPS):
        x = r.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
        y = r.randint(0, CLASSES, size=BATCH).astype(np.int32)
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        assert jf == tf
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        tstate, tm = tstep(tstate, (_nchw(x), torch.from_numpy(y)), LR, HP["damping"], **tf)
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
    if use_kfac:
        assert tstate.kfac_state["step"] == STEPS


@pytest.fixture
def tiny_in_the_zoo(monkeypatch):
    """The tiny ResNeXt under a zoo name, so the trainer twin's own code
    path runs it on the CPU in seconds."""
    monkeypatch.setitem(imagenet_resnet._MODELS, "tiny_resnext",
                        (imagenet_resnet.Bottleneck, (1, 1), 4, 4))


@pytest.mark.parametrize("kfac_freq", ["2", "0"])
def test_trainer_runs_on_cpu(tiny_in_the_zoo, kfac_freq):
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer

    hist = trainer.main([
        "--synthetic", "--model", "tiny_resnext", "--image-size", "32", "--batch-size", "2",
        "--epochs", "1", "--steps-per-epoch", "3", "--device", "cpu",
        "--kfac-update-freq", kfac_freq,
    ])
    assert len(hist["loss"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
    want = ["refresh", "capture", "refresh"] if kfac_freq == "2" else ["plain"] * 3
    assert hist["kind"] == want


@pytest.mark.parametrize("flag,item", [
    (["--num-workers", "2"], "9"),
    (["--distribute-layer-factors", "true"], "6"),
    (["--precond-comm-dtype", "bf16"], "6"),
    (["--distribute-precondition"], "6"),
    (["--grad-comm-dtype", "bf16"], "6"),
    (["--profile-epoch", "1"], "9b"),
])
def test_trainer_refuses_unported_flags(flag, item):
    """Each flag was refused naming its ROADMAP item until that item was
    ported: the native loader (item 9a), the data-parallel levers (item
    6a) and ``--profile-epoch`` (item 9b) now parse onto their arguments;
    no flag of the JAX trainer is refused any more."""
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer

    ported = {"--num-workers": 2, "--distribute-layer-factors": True,
              "--precond-comm-dtype": "bf16", "--distribute-precondition": True,
              "--grad-comm-dtype": "bf16", "--profile-epoch": 1}
    if flag[0] in ported:
        args = trainer.parse_args(["--synthetic", *flag])
        assert getattr(args, flag[0][2:].replace("-", "_")) == ported[flag[0]]
        return
    with pytest.raises(SystemExit, match=f"queue 1 item {item}"):
        trainer.parse_args(["--synthetic", *flag])


def test_trainer_refuses_real_data_and_diag_blocks(tiny_in_the_zoo, capsys):
    """Real ImageNet data was refused until the shard path was ported; now,
    without ``--synthetic`` and without shards in ``--data-dir``, the twin
    says so and trains on synthetic batches, as the JAX trainer does
    (``tests/test_torch_port_imagenet_data.py`` trains on shards).
    ``--diag-blocks > 1`` was refused too until the block-diagonal refresh
    was ported; now the twin trains with it, one block in the
    ``--diag-warmup`` epoch, then two."""
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer

    hist = trainer.main(["--model", "tiny_resnext", "--image-size", "32", "--batch-size", "2",
                         "--epochs", "1", "--steps-per-epoch", "1", "--device", "cpu",
                         "--kfac-update-freq", "0", "--data-dir", "no-such-dir"])
    assert "no data found; falling back to --synthetic" in capsys.readouterr().out
    assert hist["kind"] == ["plain"] and hist["val_loss"] == []
    hist = trainer.main([
        "--synthetic", "--model", "tiny_resnext", "--image-size", "32", "--batch-size", "2",
        "--epochs", "2", "--steps-per-epoch", "2", "--device", "cpu", "--kfac-update-freq", "2",
        "--diag-blocks", "2", "--diag-warmup", "1",
    ])
    assert hist["kind"] == ["refresh", "capture"] * 2
    assert all(math.isfinite(v) for v in hist["loss"])


def test_diag_warmup_with_one_block_changes_nothing():
    """``diag_warmup`` picks between ``diag_blocks`` and 1 block, so with one
    block the steps are bitwise those of ``diag_warmup=0``, and so are those
    of ``diag_blocks=2`` while its warm-up lasts."""
    r = np.random.RandomState(143)
    batches = [(_nchw(r.randn(2, 32, 32, 3).astype(np.float32)),
                torch.from_numpy(r.randint(0, CLASSES, size=2)))
               for _ in range(3)]
    runs = []
    for blocks, warmup in ((1, 0), (1, 5), (2, 5)):
        torch.manual_seed(144)
        model = _port_tiny()
        kfac = KFAC(layers=capture.discover_layers(model), diag_blocks=blocks,
                    diag_warmup=warmup, device="cpu", **HP)
        tx = make_sgd(MOMENTUM, WD)
        state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                           kfac_state=kfac.init(model))
        step = make_train_step(model, tx, kfac, sgd_hyper=(MOMENTUM, WD), label_smoothing=SMOOTH)
        for i, batch in enumerate(batches):
            flags = kfac_flags_for_step(i, kfac, epoch=0)
            assert flags["diag_warmup_done"] == (warmup == 0)
            state, _ = step(state, batch, LR, HP["damping"], **flags)
        runs.append(model.state_dict())
    for key, v in runs[0].items():
        assert torch.equal(v, runs[1][key]) and torch.equal(v, runs[2][key]), key
