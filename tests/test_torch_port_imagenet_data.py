"""The ImageNet data path of the port against the JAX package.

* The numpy transforms (RandomResizedCrop + flip, Resize + CenterCrop, on
  uint8 and on float shards, square and not, and the crop fallback) equal
  the JAX package's bit for bit, transposed to NCHW, and leave the
  ``RandomState`` where the JAX package leaves it; ``synthetic_imagenet_like``
  equals the JAX package's.
* The twin's shard batches in all three train modes (``rrc``,
  ``centercrop``, ``none``) on shards the test writes (a 2-image 40×48
  set, and a 32×32 set for ``none``) equal the JAX trainer's numpy
  pipeline, and the twin trains and evaluates on them.
* ``run_imagenet_validation`` on a tiny ResNeXt with the same weights
  (JAX's masked eval step against the port's) over a split with a ragged
  last batch, in the pass-through and Resize + CenterCrop modes: loss and
  accuracy within 1e-5 relative.
* ``--init-from-torch`` for both image twins loads a reference-format file
  bit for bit; JAX's ``convert_state_dict``/``convert_cifar_state_dict`` of
  the same file, carried back through the port's converters, equals what
  the port loaded; a missing, leftover, misshapen or mistyped entry and a
  clash with auto-resume raise as in the JAX package.
* ``examples/evaluate.py`` on the CPU reproduces the twin's last
  validation numbers from its checkpoint and from a reference-format file.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.models import imagenet_resnet as jir
from kfac_pytorch_tpu.parallel.mesh import data_parallel_mesh
from kfac_pytorch_tpu.torch_interop import convert_cifar_state_dict, convert_state_dict
from kfac_pytorch_tpu.training import data as jdata
from kfac_pytorch_tpu.training.evaluation import run_imagenet_validation as jrun_validation
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import make_masked_eval_step as jmake_masked_eval_step
from kfac_pytorch_tpu_torch import interop
from kfac_pytorch_tpu_torch.examples import evaluate
from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar_trainer
from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet
from kfac_pytorch_tpu_torch.training import data
from kfac_pytorch_tpu_torch.training.evaluation import run_imagenet_validation
from kfac_pytorch_tpu_torch.training.step import TrainState, make_masked_eval_step

CLASSES = 10


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
    """A tiny ResNeXt (one bottleneck in each of two stages, 4 groups of 4)
    under a zoo name, so the twins' own code paths run it in seconds."""
    monkeypatch.setitem(imagenet_resnet._MODELS, "tiny_resnext",
                        (imagenet_resnet.Bottleneck, (1, 1), 4, 4))


def _images(seed, n, h, w, dtype):
    r = np.random.RandomState(seed)
    if dtype == np.uint8:
        return r.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    return r.randn(n, h, w, 3).astype(np.float32)


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("hw", [(40, 48), (37, 37), (6, 64)])
def test_transforms_equal_jax_bitwise(dtype, hw):
    """(6, 64) drives RandomResizedCrop's ratio-clamped fallback."""
    x = _images(150, 5, *hw, dtype)
    r_port, r_jax = np.random.RandomState(151), np.random.RandomState(151)
    got = data.imagenet_train_augment(x, 24, r_port)
    want = jdata.imagenet_train_augment(x, 24, r_jax)
    assert got.dtype == np.float32 and got.shape == (5, 3, 24, 24)
    np.testing.assert_array_equal(_nhwc(got), want)
    assert r_port.randint(1 << 30) == r_jax.randint(1 << 30)
    for resize in (24, 30):
        got = data.imagenet_eval_transform(x, 24, resize_size=resize)
        np.testing.assert_array_equal(_nhwc(got), jdata.imagenet_eval_transform(x, 24, resize))
    with pytest.raises(ValueError, match="must cover the center crop"):
        data.imagenet_eval_transform(x, 24, resize_size=20)
    for h, w in ((40, 48), (6, 64), (64, 6)):
        rp, rj = np.random.RandomState(152), np.random.RandomState(152)
        for _ in range(20):
            assert data.random_resized_crop_params(h, w, rp) == \
                jdata.random_resized_crop_params(h, w, rj)


def test_synthetic_imagenet_like_equals_jax():
    kw = dict(num_classes=3, size=32, n_train=10, n_val=5, label_noise=0.2, seed=3)
    for (gx, gy), (wx, wy) in zip(data.synthetic_imagenet_like(**kw),
                                  jdata.synthetic_imagenet_like(**kw)):
        assert gx.dtype == np.uint8 and gx.shape == wx.shape
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _write_shards(root, seed, n_train, n_val, h, w):
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        np.save(os.path.join(root, f"{split}_x.npy"),
                r.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8))
        np.save(os.path.join(root, f"{split}_y.npy"),
                r.randint(0, CLASSES, size=n).astype(np.int32))
    return root


def _jax_trainer_batches(x_train, y_train, batch, steps, mode, im, val_resize, seed):
    """The JAX trainer's numpy pipeline (``examples/train_imagenet_resnet.py``,
    one process): the seeded permutation, sorted indices per batch, the
    transform with the same RandomState."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(x_train) // batch * batch)
    for b in range(steps):
        take = np.sort(order[b * batch:(b + 1) * batch])
        xb, yb = x_train[take], np.asarray(y_train[take], np.int32)
        if mode == "rrc":
            xb = jdata.imagenet_train_augment(xb, im, rng)
        elif mode == "centercrop":
            xb = jdata.imagenet_eval_transform(xb, im, resize_size=val_resize)
        else:
            xb = (np.asarray(xb, np.float32) / 255.0 - jdata.IMAGENET_MEAN) / jdata.IMAGENET_STD
        yield xb, yb


@pytest.mark.parametrize("mode,hw", [("rrc", (40, 48)), ("centercrop", (40, 48)),
                                     ("none", (32, 32))])
def test_shard_batches_equal_the_jax_trainers(tmp_path, mode, hw):
    root = _write_shards(str(tmp_path / "shards"), 153, 2, 1, *hw)
    x, y = trainer._npy_shards(root, "train")
    assert isinstance(x, np.memmap) and trainer._npy_shards(root, "test") is None
    assert trainer.train_mode(x, 32, mode == "rrc") == mode
    for epoch in range(2):
        ms = []
        got = list(trainer.shard_batches(x, y, 2, 1, mode, 32, 36, 42 + epoch, ms))
        want = list(_jax_trainer_batches(x, y, 2, 1, mode, 32, 36, 42 + epoch))
        assert len(got) == len(want) == len(ms) == 1
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == (2, 3, 32, 32) and gx.dtype == np.float32
            np.testing.assert_array_equal(_nhwc(gx), wx)
            np.testing.assert_array_equal(gy, wy)


def _tiny_pair():
    jmodel = jir.ImageNetResNet(block=jir.Bottleneck, stage_sizes=(1, 1), groups=4,
                                width_per_group=4, num_classes=CLASSES)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=True))(
        jax.random.PRNGKey(7), jnp.zeros((2, 32, 32, 3), jnp.float32))
    r = np.random.RandomState(154)
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.abs(r.randn(*v.shape)).astype(np.float32) + 0.5),
        variables["batch_stats"])
    params = variables["params"]
    model = imagenet_resnet.ImageNetResNet(imagenet_resnet.Bottleneck, (1, 1), CLASSES, 4, 4)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model.load_state_dict(interop.imagenet_state_dict_from_jax(
        np_tree(params), np_tree(stats), ("bottleneck", (1, 1))))
    return jmodel, params, stats, model


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_run_imagenet_validation_matches_jax(hw):
    """5 images in batches of 2: the last batch holds 1 image and a mask."""
    jmodel, params, stats, model = _tiny_pair()
    x = _images(155, 5, *hw, np.uint8)
    y = np.random.RandomState(156).randint(0, CLASSES, size=5).astype(np.int32)
    mesh = data_parallel_mesh(jax.devices()[:1])
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=None)
    jstep = jmake_masked_eval_step(jmodel, label_smoothing=0.1, eval_kwargs={"train": False})
    want = jrun_validation(jstep, mesh, jstate, x, y, image_size=32, val_resize=36,
                           local_batch=2)
    got = run_imagenet_validation(
        make_masked_eval_step(model, label_smoothing=0.1), TrainState(0, model, {}), x, y,
        image_size=32, val_resize=36, batch_size=2, device=torch.device("cpu"))
    assert got[2] == 5
    np.testing.assert_allclose(got[:2], want, rtol=1e-5)
    with pytest.raises(ValueError, match="empty val split"):
        run_imagenet_validation(
            make_masked_eval_step(model), TrainState(0, model, {}), x[:0], y[:0],
            image_size=32, val_resize=36, batch_size=2, device=torch.device("cpu"))


def _trainer_argv(root, *extra):
    return ["--data-dir", root, "--model", "tiny_resnext", "--image-size", "32",
            "--val-resize", "36", "--batch-size", "2", "--val-batch-size", "2",
            "--epochs", "1", "--device", "cpu", "--kfac-update-freq", "2", *extra]


def test_trainer_trains_and_evaluates_on_shards(tiny_in_the_zoo, tmp_path, capsys):
    root = _write_shards(str(tmp_path / "shards"), 157, 6, 3, 40, 48)
    hist = trainer.main(_trainer_argv(root))
    out = capsys.readouterr().out
    assert "ImageNet shards: 6 train / 3 val, stored (40, 48) uint8, train=rrc" in out
    assert hist["kind"] == ["refresh", "capture", "refresh"]
    assert len(hist["transform_ms"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
    assert hist["val_count"] == [3.0] and math.isfinite(hist["val_loss"][0])
    hist = trainer.main(_trainer_argv(root, "--no-augment", "--steps-per-epoch", "1"))
    assert "train=centercrop" in capsys.readouterr().out and len(hist["loss"]) == 1
    with pytest.raises(SystemExit, match="--val-resize .30. must be >= --image-size"):
        trainer.main(_trainer_argv(root, "--val-resize", "30"))


def _torch_file(tmp_path, sd, name="ref.pth", wrap=True):
    path = str(tmp_path / name)
    torch.save({"model": sd, "optimizer": {}} if wrap else sd, path)
    return path


def _random_state_dict(model, seed):
    r = np.random.RandomState(seed)
    return {k: (torch.from_numpy(r.randn(*v.shape).astype(np.float32))
                if v.is_floating_point() else v.clone())
            for k, v in model.state_dict().items()}


def _built_model(monkeypatch, module):
    """Run ``module.main`` with ``--epochs 0`` and keep the model it built."""
    built = {}
    build = module.build

    def keep(args, device, *world):
        out = build(args, device, *world)
        built["model"] = out[0]
        return out

    monkeypatch.setattr(module, "build", keep)
    return built


@pytest.mark.parametrize("twin", ["imagenet", "cifar"])
def test_init_from_torch_loads_a_reference_file(monkeypatch, tmp_path, twin):
    if twin == "imagenet":
        module, arch = trainer, "resnet18"
        ref = imagenet_resnet.get_model(arch)
        argv = ["--synthetic", "--model", arch, "--image-size", "32"]
    else:
        module, arch = cifar_trainer, "resnet20"
        ref = cifar_resnet.get_model(arch)
        argv = ["--synthetic", "--model", arch]
    sd = _random_state_dict(ref, 158)
    path = _torch_file(tmp_path, sd, wrap=twin == "imagenet")
    built = _built_model(monkeypatch, module)
    module.main([*argv, "--epochs", "0", "--device", "cpu", "--init-from-torch", path])
    loaded = built["model"].state_dict()
    for key, want in sd.items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(loaded[key], want, rtol=0, atol=0)
    # the JAX package's converter of the same file, carried back
    flat = {k: v.numpy() for k, v in sd.items()}
    if twin == "imagenet":
        back = interop.imagenet_state_dict_from_jax(*convert_state_dict(flat, arch), arch)
    else:
        back = interop.state_dict_from_jax(*convert_cifar_state_dict(flat, arch), arch)
    assert set(back) == set(loaded)
    for key, want in back.items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(loaded[key], want, rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["missing", "leftover", "shape", "dtype"])
def test_init_from_torch_refuses_a_wrong_file(tmp_path, fault):
    arch = "resnet18"
    model = imagenet_resnet.get_model(arch)
    sd = _random_state_dict(model, 159)
    if fault == "missing":
        del sd["layer2.0.conv1.weight"]
    elif fault == "leftover":
        sd["layer5.0.conv1.weight"] = torch.zeros(1)
    elif fault == "shape":
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 512), torch.zeros(10)
    else:
        sd["fc.weight"] = sd["fc.weight"].half()
    path = _torch_file(tmp_path, sd)
    err = {"missing": KeyError, "leftover": ValueError}.get(fault, SystemExit)
    with pytest.raises(err):
        interop.init_from_torch_checkpoint(path, model, arch)
    if fault in ("missing", "leftover"):  # the JAX converter raises the same
        with pytest.raises(err):
            convert_state_dict({k: v.numpy() for k, v in sd.items()}, arch)
    if fault in ("shape", "dtype"):
        with pytest.raises(SystemExit, match="fc.weight"):
            interop.init_from_torch_checkpoint(path, model, arch)


def test_init_from_torch_refuses_to_resume_over_it(tiny_in_the_zoo, tmp_path):
    ref = imagenet_resnet.get_model("tiny_resnext")
    path = _torch_file(tmp_path, ref.state_dict())
    argv = ["--synthetic", "--model", "tiny_resnext", "--image-size", "32", "--batch-size",
            "2", "--epochs", "1", "--steps-per-epoch", "1", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck")]
    trainer.main(argv)
    with pytest.raises(SystemExit, match="auto-resume just restored"):
        trainer.main([*argv, "--epochs", "2", "--init-from-torch", path])


def test_evaluate_reproduces_the_twins_validation(tiny_in_the_zoo, tmp_path, capsys):
    root = _write_shards(str(tmp_path / "shards"), 160, 4, 5, 40, 48)
    ck = str(tmp_path / "ck")
    hist = trainer.main(_trainer_argv(root, "--checkpoint-dir", ck))
    common = ["--data-dir", root, "--model", "tiny_resnext", "--image-size", "32",
              "--val-resize", "36", "--batch-size", "2", "--device", "cpu"]
    loss, acc = evaluate.main([*common, "--checkpoint-dir", ck])
    assert f"({5} images)" in capsys.readouterr().out
    np.testing.assert_allclose([loss, acc], [hist["val_loss"][-1], hist["val_accuracy"][-1]],
                               rtol=1e-6)
    model = imagenet_resnet.get_model("tiny_resnext")
    model.load_state_dict(torch.load(os.path.join(ck, "checkpoint-0"), weights_only=True)["model"])
    path = _torch_file(tmp_path, model.state_dict())
    assert evaluate.main([*common, "--init-from-torch", path]) == (loss, acc)
    with pytest.raises(SystemExit, match="exactly one of"):
        evaluate.main([*common, "--checkpoint-dir", ck, "--init-from-torch", path])
    # --num-workers was refused until the native loader was ported: 0 is now
    # the numpy transform, the default 4 the native loader's
    assert evaluate.parse_args([*common, "--num-workers", "0"]).num_workers == 0
    np.testing.assert_allclose(
        evaluate.main([*common, "--checkpoint-dir", ck, "--num-workers", "0"]), (loss, acc),
        rtol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main([a for a in common if a not in ("--device", "cpu")]
                          + ["--checkpoint-dir", ck])
