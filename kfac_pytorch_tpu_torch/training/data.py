"""Synthetic batches (port of ``training/data.py::synthetic_batches``).

The port keeps its own numpy copy: it imports nothing of the JAX package.
Images come out NCHW, the port's layout; the values are the JAX package's
for the same seed, transposed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

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
