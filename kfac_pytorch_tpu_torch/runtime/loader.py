"""ctypes binding of the native threaded batch pipeline (``csrc/loader.cpp``).

Port of ``kfac_pytorch_tpu/runtime/loader.py``. The C++ pipeline is host
code: ``g++`` builds it at first use into ``build/kfac_torch_loader/`` at
the repository root (beside ``ops/kernel_build.py``'s
``build/kfac_torch_kernels/``; ``.gitignore`` lists ``build/``), through a
process-unique temporary file renamed into place, so that concurrent
processes never load a half-written library. It is rebuilt when the
source is newer.

There is no fallback: where the library cannot be built or loaded, every
entry point raises ``RuntimeError`` with the compiler's output. (The JAX
binding degrades to its numpy pipeline instead; a caller of the port
chooses the numpy pipeline explicitly, ``--num-workers 0`` in the
trainers.)

Augmentation modes (``loader.cpp``'s header; the reference's torchvision
transform stacks):
  'none'        — pass-through (plus dtype conversion and normalization)
  'padcrop'     — CIFAR pad-4 random crop + flip
  'rrc'         — ImageNet RandomResizedCrop(out_size) + flip
  'centercrop'  — ImageNet eval Resize(resize_size) + CenterCrop(out_size)

Inputs are NHWC (float32 or uint8), as the C++ pipeline reads them; every
batch comes back NCHW float32 (the JAX binding's batch, transposed), with
int32 labels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from kfac_pytorch_tpu_torch.ops.kernel_build import BUILD_DIR as _KERNEL_BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
LIBRARY = _KERNEL_BUILD_DIR.parent / "kfac_torch_loader" / "libkfacloader.so"
CXX = "g++"

MODES = {"none": 0, "padcrop": 1, "rrc": 2, "centercrop": 3}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """Compile ``SOURCE`` into ``LIBRARY``; raises with the compiler's output."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [CXX, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the native loader could not be built ({' '.join(cmd)}): {e}; "
            "use the numpy pipeline (--num-workers 0) on a machine without g++"
        ) from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native loader failed to build ({' '.join(cmd)}, exit "
            f"{res.returncode}):\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, LIBRARY)


def load_library() -> ctypes.CDLL:
    """The loaded pipeline library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        built = not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime
        if built:
            _build()
        try:
            lib = ctypes.CDLL(str(LIBRARY))
        except OSError as e:
            if built:
                raise RuntimeError(f"the native loader {LIBRARY} does not load: {e}") from e
            # a library left by another machine or toolchain: build it here
            _build()
            try:
                lib = ctypes.CDLL(str(LIBRARY))
            except OSError as e2:
                raise RuntimeError(f"the native loader {LIBRARY} does not load: {e2}") from e2
        lib.kl_create.restype = ctypes.c_void_p
        lib.kl_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # x, y, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, shards, shard_idx
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # shuffle, mode, pad
            ctypes.c_int, ctypes.c_int,  # threads, depth
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, oh, ow, resize
        ]
        lib.kl_set_norm.restype = None
        lib.kl_set_norm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.kl_transform.restype = ctypes.c_int
        lib.kl_transform.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,  # x, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c, dtype
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # out, oh, ow
            ctypes.c_int, ctypes.c_int,  # mode, resize
            ctypes.c_void_p, ctypes.c_void_p,  # mean, std
            ctypes.c_uint64, ctypes.c_int,  # seed, threads
        ]
        lib.kl_start_epoch.restype = None
        lib.kl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.kl_num_batches.restype = ctypes.c_int64
        lib.kl_num_batches.argtypes = [ctypes.c_void_p]
        lib.kl_next.restype = ctypes.c_int
        lib.kl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.kl_destroy.restype = None
        lib.kl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _input(x: np.ndarray, copy: bool) -> Tuple[np.ndarray, int]:
    """``(array, in_dtype)`` in the layout the C side reads: C-contiguous
    uint8 (1) or float32 (0). ``copy=False`` takes an already contiguous
    array as it is (a memory-mapped uint8 shard is never copied whole)."""
    if x.ndim != 4:
        raise ValueError(f"the native loader takes NHWC images, got shape {x.shape}")
    if x.dtype == np.uint8:
        return (x if (not copy and x.flags["C_CONTIGUOUS"]) else np.ascontiguousarray(x)), 1
    if not copy and x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]:
        return x, 0
    return np.ascontiguousarray(x, np.float32), 0


def _norm(mean, std, channels: int):
    """Per-channel ``(mean, std)`` float32 arrays, or ``(None, None)``."""
    if std is not None and mean is None:
        raise ValueError("std given without mean — pass both or neither")
    if mean is None:
        return None, None
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std if std is not None else [1, 1, 1], np.float32)
    if len(m) != min(channels, 3) or len(s) != len(m):
        raise ValueError(
            f"normalization needs {min(channels, 3)} per-channel values; "
            f"got mean[{len(m)}], std[{len(s)}]"
        )
    return m, s


def _nchw(xb: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(xb.transpose(0, 3, 1, 2))


class NativeEpochLoader:
    """Reusable epoch iterator over the C++ worker pool.

    ``training.data.epoch_batches``' semantics (a seeded global shuffle,
    interleaved shards ``shard_index::num_shards``, drop-last, every shard
    the same batch count) with the batches filled on ``num_workers`` native
    threads and ``depth`` buffers of lookahead, so host data preparation
    overlaps the device's steps. The shuffle and the augmentation draw from
    the C side's splitmix64 streams (not numpy's), so batches equal the JAX
    binding's, not the numpy pipeline's; they are byte-identical for any
    worker count. ``mode`` selects the augmentation (module docstring;
    default ``padcrop`` with ``augment``, else ``none``); uint8 inputs
    become [0, 1] float32 and, with ``mean``/``std``, are normalized per
    channel in the worker threads.
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        shuffle: bool,
        augment: bool = False,
        num_shards: int = 1,
        shard_index: int = 0,
        pad: int = 4,
        num_workers: int = 4,
        depth: int = 4,
        mode: Optional[str] = None,
        out_size: Optional[Tuple[int, int]] = None,
        resize_size: int = 256,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
        copy: bool = True,
    ):
        self._ptr = None
        lib = load_library()
        self._lib = lib
        if mode is None:
            mode = "padcrop" if augment else "none"
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {sorted(MODES)}")
        if num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got {num_workers}")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        # the C side borrows these buffers: keep them alive with the loader
        self._x, in_dtype = _input(x, copy)
        self._y = np.ascontiguousarray(y, np.int32)
        if len(self._y) != len(self._x):
            raise ValueError(f"{len(self._x)} images but {len(self._y)} labels")
        n, h, w, c = self._x.shape
        oh, ow = out_size if out_size else (h, w)
        m, s = _norm(mean, std, c)
        self.batch_size = batch_size
        self._sample_shape = (oh, ow, c)
        self._ptr = lib.kl_create(
            self._x.ctypes.data, self._y.ctypes.data, n, h, w, c,
            batch_size, num_shards, shard_index,
            int(shuffle), MODES[mode], pad, num_workers, depth,
            in_dtype, oh, ow, resize_size,
        )
        if not self._ptr:
            raise RuntimeError(
                f"kl_create refused the configuration (mode {mode!r}, stored "
                f"{h}x{w}, out {oh}x{ow}, resize {resize_size})"
            )
        if m is not None:
            lib.kl_set_norm(self._ptr, m.ctypes.data, s.ctypes.data)

    def epoch(self, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Start a (re)shuffled epoch and yield its ``(NCHW images, labels)``."""
        if not self._ptr:
            raise RuntimeError("NativeEpochLoader is closed")
        self._lib.kl_start_epoch(self._ptr, ctypes.c_uint64(seed & (2**64 - 1)))
        h, w, c = self._sample_shape
        while True:
            xb = np.empty((self.batch_size, h, w, c), np.float32)
            yb = np.empty((self.batch_size,), np.int32)
            if not self._lib.kl_next(self._ptr, xb.ctypes.data, yb.ctypes.data):
                return
            yield _nchw(xb), yb

    @property
    def num_batches(self) -> int:
        if not self._ptr:
            return 0
        return int(self._lib.kl_num_batches(self._ptr))

    def close(self) -> None:
        if self._ptr:
            self._lib.kl_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


def native_transform(
    x: np.ndarray,
    out_size: Tuple[int, int],
    mode: str = "centercrop",
    resize_size: int = 256,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    seed: int = 0,
    num_workers: int = 4,
) -> np.ndarray:
    """One threaded transform (``rrc`` or ``centercrop``) of the NHWC batch
    ``x``, returned NCHW float32: for callers that bring their own batching,
    such as the masked evaluation (``training.evaluation``)."""
    lib = load_library()
    if mode not in ("rrc", "centercrop"):
        raise ValueError(f"unsupported one-shot mode {mode!r}")
    xc, in_dtype = _input(x, copy=False)
    n, h, w, c = xc.shape
    oh, ow = out_size
    m, s = _norm(mean, std, c)
    out = np.empty((n, oh, ow, c), np.float32)
    ok = lib.kl_transform(
        xc.ctypes.data, n, h, w, c, in_dtype,
        out.ctypes.data, oh, ow, MODES[mode], resize_size,
        m.ctypes.data if m is not None else None,
        s.ctypes.data if m is not None else None,
        ctypes.c_uint64(seed & (2**64 - 1)), num_workers,
    )
    if not ok:
        raise RuntimeError(
            f"kl_transform refused the batch (mode {mode!r}, stored {h}x{w}, "
            f"out {oh}x{ow}, resize {resize_size})"
        )
    return _nchw(out)


def native_epoch_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    shuffle: bool,
    augment: bool,
    seed: int,
    num_shards: int = 1,
    shard_index: int = 0,
    num_workers: int = 4,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch through the native pipeline (``epoch_batches``' signature)."""
    loader = NativeEpochLoader(
        x, y, batch_size, shuffle, augment,
        num_shards=num_shards, shard_index=shard_index, num_workers=num_workers,
    )
    try:
        yield from loader.epoch(seed)
    finally:
        loader.close()
