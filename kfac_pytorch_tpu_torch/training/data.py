"""Input pipelines: CIFAR-10 from local pickle batches, and synthetic data.

Port of ``training/data.py``: the CIFAR part (``load_cifar10``,
``find_cifar10``, the pad-4 crop + flip augmentation, ``epoch_batches``,
``eval_batches`` and the learnable stand-in ``synthetic_cifar_like``), the
ImageNet part (the numpy transforms ``imagenet_train_augment`` —
RandomResizedCrop + flip — and ``imagenet_eval_transform`` — Resize +
CenterCrop —, ``random_resized_crop_params`` and the uint8 stand-in
``synthetic_imagenet_like``), the WikiText part (``build_corpus``,
``find_wikitext``) and ``synthetic_batches``, ``synthetic_corpus``,
``batchify_tokens``, ``bptt_batches``.

The port keeps its own numpy copies: it imports nothing of the JAX package.
The random draws are the JAX package's, call for call, so both packages see
the same data for the same seed. Images come out NCHW, the port's layout
(the JAX package's, transposed, bit for bit); token streams come out as
they are. ImageNet shards stay in their on-disk layout, NHWC
(``{train,val}_{x,y}.npy``, as ``scripts/make_imagenet_shards.py`` writes
them): the transforms read NHWC batches and return NCHW float32. These
are the numpy pipeline (``--num-workers 0``); the native threaded loader is
``runtime/loader.py``. Data is read only
from the directory a caller names: unlike the JAX package, nothing searches
fixed data directories.
"""

from __future__ import annotations

import math
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
    num_shards: int = 1,
    shard_index: int = 0,
) -> Iterator[Batch]:
    """One epoch of full batches (drops the ragged tail, like drop_last):
    the seeded permutation first, then per batch the augmentation's draws.

    ``num_shards``/``shard_index`` are the ``DistributedSampler`` split of
    the JAX package's multi-host trainer: every rank draws the same seeded
    permutation and takes its interleaved slice ``shard_index::num_shards``,
    so shards are disjoint; the batch count comes from the shortest shard,
    so every rank takes the same number of steps. ``batch_size`` is the
    per-shard size."""
    rng = np.random.RandomState(seed)
    idx = np.arange(len(x))
    if shuffle:
        rng.shuffle(idx)
    n_batches = (len(x) // num_shards) // batch_size
    if num_shards > 1:
        idx = idx[shard_index::num_shards]
    for b in range(n_batches):
        take = idx[b * batch_size : (b + 1) * batch_size]
        xb = x[take]
        if augment:
            xb = _augment(xb, rng)
        yield xb, y[take]


def eval_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    num_shards: int = 1,
    shard_index: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Full-split evaluation batches: ``(images, labels, mask)``, the ragged
    tail padded up to ``batch_size`` by repeating sample 0 with a zero mask
    entry, so masked sums over all batches are sums over the whole split.
    With ``num_shards`` > 1 a rank takes the interleaved slice
    ``shard_index::num_shards``, and every rank yields the batch count of
    the longest shard (shorter ones pad more), so the ranks' reductions
    stay in step."""
    idx = np.arange(len(x))
    if num_shards > 1:
        idx = idx[shard_index::num_shards]
    longest_shard = (len(x) + num_shards - 1) // num_shards
    for b in range(-(-longest_shard // batch_size)):
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


def synthetic_imagenet_like(
    num_classes: int = 200,
    size: int = 64,
    n_train: int = 20_000,
    n_val: int = 4_000,
    prototypes_per_class: int = 4,
    noise: float = 0.45,
    label_noise: float = 0.0,
    seed: int = 0,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """A learnable ImageNet-class stand-in as uint8 shards: ``((x_train,
    y_train), (x_val, y_val))`` with NHWC uint8 images in the shard layout
    (``{train,val}_x.npy``), fed through the same loader and transforms real
    shards would take. The recipe of :func:`synthetic_cifar_like` with the
    class structure at a coarser scale (``size // 8`` prototypes, two blur
    passes) so RandomResizedCrop keeps it; ``label_noise`` flips that share
    of TRAIN labels. Equal to the JAX package's, bit for bit."""
    rng = np.random.RandomState(seed)
    protos = _make_prototypes(
        rng, num_classes, prototypes_per_class, size,
        low=max(size // 8, 4), blur_passes=2,
    )

    def quantize(split):
        # float ~N(0, ~1.2) -> uint8 with 3.5 sigma of headroom, back to NHWC
        x, y = split
        x = np.clip(x.transpose(0, 2, 3, 1) * 36.0 + 128.0, 0.0, 255.0)
        return np.ascontiguousarray(x.astype(np.uint8)), y

    return (
        quantize(_prototype_split(protos, n_train, seed + 1, noise, label_noise)),
        quantize(_prototype_split(protos, n_val, seed + 2, noise, 0.0)),
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


# ---------------------------------------------------------------------------
# ImageNet transforms (numpy, on the host)
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1]; float input passes through
    (already preprocessed)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _bilinear_window(
    img: np.ndarray, oh: int, ow: int, oy: float, ox: float, sy: float, sx: float,
    lo_y: float, hi_y: float, lo_x: float, hi_x: float,
) -> np.ndarray:
    """``align_corners=False`` bilinear sample of one HWC image: output
    pixel (r, c) reads source coordinate ((r+0.5)·sy − 0.5 + oy,
    (c+0.5)·sx − 0.5 + ox), clamped per axis to [lo, hi]."""
    h, w = img.shape[:2]
    fy = np.clip((np.arange(oh) + 0.5) * sy - 0.5 + oy, lo_y, hi_y)
    fx = np.clip((np.arange(ow) + 0.5) * sx - 0.5 + ox, lo_x, hi_x)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    p00 = img[y0][:, x0]
    p01 = img[y0][:, x1]
    p10 = img[y1][:, x0]
    p11 = img[y1][:, x1]
    return (
        p00 * (1 - wy) * (1 - wx)
        + p01 * (1 - wy) * wx
        + p10 * wy * (1 - wx)
        + p11 * wy * wx
    )


def random_resized_crop_params(
    h: int, w: int, rng: np.random.RandomState,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision ``RandomResizedCrop.get_params``: ``(top, left, height,
    width)`` from 10 attempts of (area, log-aspect) sampling, then the
    ratio-clamped center crop."""
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch + 1)
            j = rng.randint(0, w - cw + 1)
            return i, j, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _nchw(out: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(out.transpose(0, 3, 1, 2))


def normalize_imagenet(x: np.ndarray) -> np.ndarray:
    """An NHWC batch stored at the crop size, as the model takes it: uint8
    decoded to [0, 1] and normalized with the ImageNet statistics, float
    (pre-normalized) passed through; NCHW float32."""
    if x.dtype == np.uint8:
        return _nchw((np.asarray(x, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    return _nchw(np.asarray(x, np.float32))


def imagenet_train_augment(
    x: np.ndarray, out_size: int, rng: np.random.RandomState, normalize: bool = True,
) -> np.ndarray:
    """RandomResizedCrop(out_size) + horizontal flip over an NHWC batch, in
    ``rng``'s order (per image: the crop, then the flip). uint8 input is
    scaled to [0, 1] and normalized with the ImageNet statistics; float
    input is taken as pre-normalized. Returns NCHW float32."""
    n = x.shape[0]
    out = np.empty((n, out_size, out_size, x.shape[3]), np.float32)
    for idx in range(n):
        img = _to_float(x[idx])
        h, w = img.shape[:2]
        i, j, ch, cw = random_resized_crop_params(h, w, rng)
        o = _bilinear_window(
            img, out_size, out_size, float(i), float(j),
            ch / out_size, cw / out_size, i, i + ch - 1, j, j + cw - 1,
        )
        if rng.rand() < 0.5:
            o = o[:, ::-1]
        out[idx] = o
    if normalize and x.dtype == np.uint8:
        out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return _nchw(out)


def imagenet_eval_transform(
    x: np.ndarray, out_size: int, resize_size: int = 256, normalize: bool = True
) -> np.ndarray:
    """Resize(shorter side -> resize_size) + CenterCrop(out_size) over an
    NHWC batch (the reference's validation transform). Returns NCHW
    float32."""
    if resize_size < out_size:
        raise ValueError(
            f"resize_size ({resize_size}) must cover the center crop "
            f"({out_size}); smaller values would replicate borders instead "
            "of torchvision CenterCrop's zero-padding"
        )
    n = x.shape[0]
    out = np.empty((n, out_size, out_size, x.shape[3]), np.float32)
    for idx in range(n):
        img = _to_float(x[idx])
        h, w = img.shape[:2]
        scale = resize_size / min(h, w)
        rh, rw = int(round(h * scale)), int(round(w * scale))
        sy, sx = h / rh, w / rw
        ty, tx = (rh - out_size) // 2, (rw - out_size) // 2
        out[idx] = _bilinear_window(
            img, out_size, out_size, ty * sy, tx * sx, sy, sx, 0, h - 1, 0, w - 1
        )
    if normalize and x.dtype == np.uint8:
        out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return _nchw(out)


# ---------------------------------------------------------------------------
# WikiText (word-level LM)
# ---------------------------------------------------------------------------


def build_corpus(data_dir: str) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Word-level corpus from ``wiki.{train,valid,test}.tokens`` (the
    WikiText-2/103 layout): ``(splits, vocab)``, each split present on disk
    an int32 id array, every line's words followed by ``<eos>``; ids in
    order of first appearance after ``<unk>`` (0) and ``<eos>`` (1)."""
    vocab = {"<unk>": 0, "<eos>": 1}
    words = ["<unk>", "<eos>"]

    def encode(path):
        ids = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                for w in line.split() + ["<eos>"]:
                    if w not in vocab:
                        vocab[w] = len(words)
                        words.append(w)
                    ids.append(vocab[w])
        return np.asarray(ids, np.int32)

    splits = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(data_dir, f"wiki.{split}.tokens")
        if os.path.isfile(p):
            splits[split] = encode(p)
    return splits, words


def find_wikitext(data_dir: Optional[str]) -> Optional[str]:
    """``data_dir`` if it holds ``wiki.train.tokens``, else ``None``.
    Unlike the JAX package, which also searches fixed data directories, the
    port looks only where it is told."""
    if data_dir and os.path.isfile(os.path.join(data_dir, "wiki.train.tokens")):
        return data_dir
    return None
