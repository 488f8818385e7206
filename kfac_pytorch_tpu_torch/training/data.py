"""Input pipelines: CIFAR-10 from local pickle batches, and synthetic data.

Port of ``training/data.py``: the CIFAR part (``load_cifar10``,
``find_cifar10``, the pad-4 crop + flip augmentation, ``epoch_batches``,
``eval_batches`` and the learnable stand-in ``synthetic_cifar_like``) and
``synthetic_batches``, ``synthetic_corpus``, ``batchify_tokens``,
``bptt_batches``.

The port keeps its own numpy copies: it imports nothing of the JAX package.
The random draws are the JAX package's, call for call, so both packages see
the same data for the same seed. Images come out NCHW, the port's layout
(the JAX package's, transposed, bit for bit); token streams come out as
they are.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def load_cifar10(data_dir: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Raw CIFAR-10 from the standard ``cifar-10-batches-py`` layout (the
    five ``data_batch_*`` files, or ``test_batch``): normalized float32 NCHW
    images and int32 labels. ``data_dir`` is that directory or its parent."""
    base = data_dir
    if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")):
        base = os.path.join(data_dir, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    x = (x - CIFAR10_MEAN[:, None, None]) / CIFAR10_STD[:, None, None]
    return x, np.concatenate(ys)


def find_cifar10(data_dir: Optional[str]) -> Optional[str]:
    """``data_dir`` if it holds CIFAR-10 (a ``cifar-10-batches-py``
    directory or the batch files themselves), else ``None``. Unlike the JAX
    package, which also searches fixed data directories, the port looks
    only where it is told."""
    if not data_dir:
        return None
    if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")) or os.path.isfile(
        os.path.join(data_dir, "data_batch_1")
    ):
        return data_dir
    return None


def _augment(x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Pad-4 random crop + horizontal flip of NCHW images."""
    n, _, h, w = x.shape
    padded = np.pad(x, ((0, 0), (0, 0), (4, 4), (4, 4)))
    out = np.empty_like(x)
    ys = rng.randint(0, 9, size=n)
    xs = rng.randint(0, 9, size=n)
    flip = rng.rand(n) < 0.5
    for i in range(n):
        img = padded[i, :, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
        out[i] = img[:, :, ::-1] if flip[i] else img
    return out


def epoch_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    shuffle: bool,
    augment: bool,
    seed: int,
) -> Iterator[Batch]:
    """One epoch of full batches (drops the ragged tail, like drop_last):
    the seeded permutation first, then per batch the augmentation's draws.
    The JAX package's ``num_shards``/``shard_index`` (multi-host) are ROADMAP
    queue 1 item 6."""
    rng = np.random.RandomState(seed)
    idx = np.arange(len(x))
    if shuffle:
        rng.shuffle(idx)
    for b in range(len(x) // batch_size):
        take = idx[b * batch_size : (b + 1) * batch_size]
        xb = x[take]
        if augment:
            xb = _augment(xb, rng)
        yield xb, y[take]


def eval_batches(
    x: np.ndarray, y: np.ndarray, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Full-split evaluation batches: ``(images, labels, mask)``, the ragged
    tail padded up to ``batch_size`` by repeating sample 0 with a zero mask
    entry, so masked sums over all batches are sums over the whole split."""
    idx = np.arange(len(x))
    for b in range(-(-len(x) // batch_size)):
        take = idx[b * batch_size : (b + 1) * batch_size]
        k = len(take)
        mask = np.zeros(batch_size, np.float32)
        mask[:k] = 1.0
        if k < batch_size:
            take = np.concatenate([take, np.zeros(batch_size - k, idx.dtype)])
        yield x[take], y[take], mask


def _make_prototypes(
    rng: np.random.RandomState,
    num_classes: int,
    per_class: int,
    size: int,
    low: int,
    blur_passes: int,
) -> np.ndarray:
    """Smoothed low-res-noise prototypes, ``[classes, per_class, H, W, 3]``
    (channel-last, as the JAX package draws them)."""
    up = size // low
    if low * up != size:
        raise ValueError(
            f"size {size} must be a multiple of its prototype grid {low} "
            f"(choose a size divisible by {low})"
        )
    protos = np.empty((num_classes, per_class, size, size, 3), np.float32)
    for c in range(num_classes):
        for p in range(per_class):
            base = rng.randn(low, low, 3).astype(np.float32)
            img = base.repeat(up, axis=0).repeat(up, axis=1)
            for _ in range(blur_passes):  # cheap separable blur per axis
                img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)) / 3.0
                img = (img + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 3.0
            protos[c, p] = img
    return protos


def _prototype_split(
    protos: np.ndarray,
    n: int,
    split_seed: int,
    noise: float,
    flip_labels: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """One split from a prototype bank: per-sample prototype pick, cyclic
    shift (±25%), horizontal flip, brightness/contrast jitter, additive
    pixel noise, and optional always-wrong-class label flips. Built
    channel-last in the JAX package's order, returned NCHW."""
    num_classes, per_class, size = protos.shape[0], protos.shape[1], protos.shape[2]
    r = np.random.RandomState(split_seed)
    y = r.randint(0, num_classes, size=n).astype(np.int32)
    pick = r.randint(0, per_class, size=n)
    x = protos[y, pick].copy()
    max_shift = size // 4
    dy = r.randint(-max_shift, max_shift + 1, size=n)
    dx = r.randint(-max_shift, max_shift + 1, size=n)
    flip = r.rand(n) < 0.5
    bright = r.uniform(-0.3, 0.3, size=n).astype(np.float32)
    contrast = r.uniform(0.8, 1.2, size=n).astype(np.float32)
    for i in range(n):
        img = np.roll(x[i], (dy[i], dx[i]), axis=(0, 1))
        if flip[i]:
            img = img[:, ::-1]
        x[i] = img * contrast[i] + bright[i]
    # chunked noise: one randn over the split would hold a float64
    # temporary of 8x its size
    for lo in range(0, n, 2048):
        hi = min(lo + 2048, n)
        x[lo:hi] += r.randn(hi - lo, size, size, 3).astype(np.float32) * noise
    if flip_labels > 0.0:
        # flips after the images are built, never back onto the true class:
        # a flip rate f caps attainable accuracy at exactly 1 - f
        hit = r.rand(n) < flip_labels
        y = y.copy()
        y[hit] = (y[hit] + r.randint(1, num_classes, size=int(hit.sum()))) % num_classes
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y


def synthetic_cifar_like(
    n_train: int = 50_000,
    n_test: int = 10_000,
    num_classes: int = 10,
    size: int = 32,
    prototypes_per_class: int = 10,
    noise: float = 0.55,
    label_noise: float = 0.08,
    val_label_noise: float = 0.0,
    seed: int = 0,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """A deterministic, learnable CIFAR-shaped dataset: the stand-in the
    trainer uses when no CIFAR-10 is on disk. Each class is a mixture of
    smoothed random prototypes; each sample is one of them, shifted,
    flipped, jittered and noised. ``label_noise`` flips that share of TRAIN
    labels, ``val_label_noise`` of VAL labels (always to a wrong class: a
    hard accuracy ceiling of ``1 - f``). Returns ``((x_train, y_train),
    (x_test, y_test))`` with normalized float32 NCHW images, as
    :func:`load_cifar10`."""
    rng = np.random.RandomState(seed)
    protos = _make_prototypes(
        rng, num_classes, prototypes_per_class, size, low=size // 4, blur_passes=1,
    )
    return (
        _prototype_split(protos, n_train, seed + 1, noise, label_noise),
        _prototype_split(protos, n_test, seed + 2, noise, val_label_noise),
    )


def synthetic_batches(
    batch_size: int,
    image_shape: Tuple[int, int, int],
    num_classes: int,
    steps: int,
    seed: int = 0,
) -> Iterator[Batch]:
    """Deterministic fake data: a pool of up to 8 pre-generated batches cycled.

    ``image_shape`` is ``(C, H, W)``. The random draws are the JAX package's
    (which draws ``(H, W, C)`` images from the same ``RandomState``), moved
    to channel-first, so both packages see the same pixels.
    """
    c, h, w = image_shape
    rng = np.random.RandomState(seed)
    pool = []
    for _ in range(min(steps, 8)):
        x = rng.randn(batch_size, h, w, c).astype(np.float32)
        y = rng.randint(0, num_classes, size=batch_size).astype(np.int32)
        pool.append((np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y))
    for i in range(steps):
        yield pool[i % len(pool)]


def synthetic_corpus(
    vocab_size: int = 1000, length: int = 200_000, seed: int = 0
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Zipf-distributed synthetic token stream (zero-egress stand-in for
    WikiText): ``({'train', 'valid', 'test'} int32 id arrays split 80/10/10,
    vocab words)``."""
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, vocab_size + 1)
    probs /= probs.sum()
    ids = rng.choice(vocab_size, size=length, p=probs).astype(np.int32)
    return {"train": ids[: int(0.8 * length)],
            "valid": ids[int(0.8 * length): int(0.9 * length)],
            "test": ids[int(0.9 * length):]}, [f"w{i}" for i in range(vocab_size)]


def batchify_tokens(ids: np.ndarray, batch_size: int) -> np.ndarray:
    """``[N] -> [batch_size, N // batch_size]`` contiguous streams per row."""
    n = len(ids) // batch_size
    return ids[: n * batch_size].reshape(batch_size, n)


def bptt_batches(stream: np.ndarray, bptt: int) -> Iterator[Batch]:
    """``(tokens, next-token targets)`` ``[B, bptt]`` segments in order; the
    last segment start is ``n − 1 − bptt`` so its targets stay in range."""
    _, n = stream.shape
    for i in range(0, n - bptt, bptt):
        yield stream[:, i : i + bptt], stream[:, i + 1 : i + 1 + bptt]
