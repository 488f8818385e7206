"""Synthetic data (port of ``training/data.py``: ``synthetic_batches``,
``synthetic_corpus``, ``batchify_tokens``, ``bptt_batches``).

The port keeps its own numpy copies: it imports nothing of the JAX package.
The random draws are the JAX package's, call for call, so both packages see
the same data for the same seed. Images come out NCHW, the port's layout
(the JAX package's, transposed); token streams come out as they are.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


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
