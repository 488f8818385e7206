"""The port's native loader (``kfac_pytorch_tpu_torch/runtime/loader.py``)
against the JAX package's binding of the same C++ pipeline.

Both build ``loader.cpp`` with ``g++`` here. For the same inputs, seed,
mode, worker count and shard, the port's batches are the JAX binding's
bit for bit, transposed to NCHW. The checks of ``tests/test_native_loader.py``
are ported: worker-count invariance, disjoint shards, the padded crop,
RandomResizedCrop's determinism and ranges, Resize + CenterCrop against
numpy. ``training.data``'s sharded ``epoch_batches``/``eval_batches`` equal
the JAX functions', and ``--num-workers > 0`` without a buildable library
raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import runtime as jruntime
from kfac_pytorch_tpu.training import data as jdata
from kfac_pytorch_tpu_torch.runtime import loader as tloader
from kfac_pytorch_tpu_torch.training import data as tdata


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def _dataset(mode, n=30, seed=0):
    """NHWC inputs of each mode's caller: float32 CIFAR-like images for
    ``padcrop``, uint8 ImageNet-like shards (normalized) for the others."""
    r = np.random.RandomState(seed)
    y = np.arange(n, dtype=np.int32)
    if mode == "padcrop":
        return r.randn(n, 8, 8, 3).astype(np.float32), y, {}, None
    hw = (12, 12) if mode == "none" else (20, 16)
    x = r.randint(0, 256, size=(n, *hw, 3), dtype=np.uint8)
    out = None if mode == "none" else (8, 8)
    return x, y, dict(mean=MEAN, std=STD), out


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("mode", ["none", "padcrop", "rrc", "centercrop"])
def test_batches_equal_the_jax_binding(mode, workers):
    x, y, norm, out = _dataset(mode)
    for shards in (1, 2, 3):
        for index in range(shards):
            kw = dict(num_shards=shards, shard_index=index, num_workers=workers,
                      mode=mode, out_size=out, resize_size=10, **norm)
            mine = tloader.NativeEpochLoader(x, y, 4, shuffle=True, **kw)
            theirs = jruntime.NativeEpochLoader(x, y, 4, shuffle=True, **kw)
            assert mine.num_batches == 0 or mine.num_batches == theirs.num_batches
            for seed in (3, 4):
                got, want = list(mine.epoch(seed)), list(theirs.epoch(seed))
                assert len(got) == len(want) == (len(x) // shards) // 4
                for (gx, gy), (wx, wy) in zip(got, want):
                    assert gx.flags["C_CONTIGUOUS"] and gx.shape[1] == 3
                    np.testing.assert_array_equal(_nhwc(gx), wx)
                    np.testing.assert_array_equal(gy, wy)
            assert mine.num_batches == theirs.num_batches
            mine.close()
            theirs.close()


@pytest.mark.parametrize("mode", ["rrc", "centercrop"])
def test_native_transform_equals_the_jax_binding(mode):
    x = np.random.RandomState(1).randint(0, 256, size=(5, 24, 20, 3), dtype=np.uint8)
    for workers in (1, 3):
        kw = dict(mode=mode, resize_size=18, mean=MEAN, std=STD, seed=5, num_workers=workers)
        got = tloader.native_transform(x, (16, 16), **kw)
        assert got.shape == (5, 3, 16, 16)
        np.testing.assert_array_equal(_nhwc(got), jruntime.native_transform(x, (16, 16), **kw))


def test_mode_none_equals_the_numpy_pipeline():
    x = np.random.RandomState(2).randn(64, 8, 8, 3).astype(np.float32)
    y = np.random.RandomState(3).randint(0, 10, size=64).astype(np.int32)
    native = list(tloader.native_epoch_batches(x, y, 16, shuffle=False, augment=False, seed=0))
    ref = list(tdata.epoch_batches(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y, 16,
                                   shuffle=False, augment=False, seed=0))
    assert len(native) == len(ref) == 4
    for (nx, ny), (rx, ry) in zip(native, ref):
        np.testing.assert_array_equal(nx, rx)
        np.testing.assert_array_equal(ny, ry)


def test_workers_shards_and_the_padded_crop():
    """Worker-count invariance, disjoint shards of equal batch counts, and
    every padcrop sample one (crop, flip) of its pad-4 source."""
    x = np.random.RandomState(4).randn(60, 8, 8, 3).astype(np.float32)
    y = np.arange(60, dtype=np.int32)
    one = list(tloader.native_epoch_batches(x, y, 8, True, True, seed=3, num_workers=1))
    four = list(tloader.native_epoch_batches(x, y, 8, True, True, seed=3, num_workers=4))
    for (ax, ay), (bx, by) in zip(one, four):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)
    shards = []
    for s in range(2):
        batches = list(tloader.native_epoch_batches(x, y, 10, True, False, seed=5,
                                                    num_shards=2, shard_index=s))
        assert len(batches) == 3
        shards.append(np.concatenate([by for _, by in batches]))
    assert len(np.intersect1d(*shards)) == 0
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    for xb, yb in one:
        for img, label in zip(_nhwc(xb), yb):
            crops = [padded[label, dy:dy + 8, dx:dx + 8] for dy in range(9) for dx in range(9)]
            assert any(np.array_equal(img, c) or np.array_equal(img, c[:, ::-1]) for c in crops)


def test_rrc_is_deterministic_and_in_range():
    """RandomResizedCrop: thread-count invariant, seed dependent, uint8 →
    [0, 1] without normalization, horizontal flips at about half the
    samples (a constant-per-row image shows a flip as a reversed row)."""
    n = 256
    ramp = np.broadcast_to(np.arange(16, dtype=np.uint8)[None, None, :, None] * 16,
                           (n, 16, 16, 3)).copy()
    y = np.arange(n, dtype=np.int32)

    def run(workers, seed):
        loader = tloader.NativeEpochLoader(ramp, y, n, shuffle=False, mode="rrc",
                                           out_size=(8, 8), num_workers=workers)
        (xb, _), = list(loader.epoch(seed))
        loader.close()
        return xb

    a = run(1, 9)
    np.testing.assert_array_equal(a, run(4, 9))
    assert not np.array_equal(a, run(4, 10))
    assert a.shape == (n, 3, 8, 8) and a.min() >= 0.0 and a.max() <= 1.0
    rows = a[:, 0, 0, :]
    flipped = np.mean(rows[:, 0] > rows[:, -1])
    assert 0.35 < flipped < 0.65


def test_centercrop_matches_the_numpy_transform():
    x = np.random.RandomState(7).randint(0, 256, size=(3, 50, 36, 3), dtype=np.uint8)
    loader = tloader.NativeEpochLoader(
        x, np.arange(3, dtype=np.int32), 3, shuffle=False, mode="centercrop",
        out_size=(24, 24), resize_size=30, mean=tdata.IMAGENET_MEAN, std=tdata.IMAGENET_STD)
    (xb, _), = list(loader.epoch(0))
    loader.close()
    want = tdata.imagenet_eval_transform(x, 24, resize_size=30)
    np.testing.assert_allclose(xb, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_epoch_and_eval_batches_equal_jax(shards):
    x = np.random.RandomState(8).randn(23, 4, 4, 3).astype(np.float32)
    y = np.arange(23, dtype=np.int32)
    xt = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    for index in range(shards):
        got = list(tdata.epoch_batches(xt, y, 3, shuffle=True, augment=True, seed=9,
                                       num_shards=shards, shard_index=index))
        want = list(jdata.epoch_batches(x, y, 3, shuffle=True, augment=True, seed=9,
                                        num_shards=shards, shard_index=index))
        assert len(got) == len(want) == (23 // shards) // 3
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(_nhwc(gx), wx)
            np.testing.assert_array_equal(gy, wy)
        got = list(tdata.eval_batches(xt, y, 4, num_shards=shards, shard_index=index))
        want = list(jdata.eval_batches(x, y, 4, num_shards=shards, shard_index=index))
        assert len(got) == len(want)
        for (gx, gy, gm), (wx, wy, wm) in zip(got, want):
            np.testing.assert_array_equal(_nhwc(gx), wx)
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(gm, wm)


def test_no_fallback_without_a_library(monkeypatch, tmp_path):
    """A library that cannot be built raises, in the binding and in the
    twins at ``--num-workers > 0``; ``--num-workers 0`` is the numpy
    pipeline and needs none."""
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from tests.test_torch_port_data import write_cifar

    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "LIBRARY", tmp_path / "build" / "libkfacloader.so")
    monkeypatch.setattr(tloader, "CXX", str(tmp_path / "no-such-g++"))
    x, y, _, _ = _dataset("padcrop")
    with pytest.raises(RuntimeError, match="could not be built"):
        tloader.NativeEpochLoader(x, y, 4, shuffle=True)
    with pytest.raises(RuntimeError, match="could not be built"):
        tloader.native_transform(x.astype(np.uint8), (4, 4), mode="centercrop", resize_size=4)
    write_cifar(str(tmp_path / "data"), 4, 5)
    argv = ["--data-dir", str(tmp_path / "data"), "--model", "resnet20", "--batch-size", "4",
            "--val-batch-size", "5", "--epochs", "1", "--device", "cpu",
            "--kfac-update-freq", "0"]
    with pytest.raises(RuntimeError, match="could not be built"):
        trainer.main([*argv, "--num-workers", "2"])
    torch.manual_seed(0)
    hist = trainer.main([*argv, "--num-workers", "0"])
    assert len(hist["loss"]) == 5 and hist["val_count"] == [5]
