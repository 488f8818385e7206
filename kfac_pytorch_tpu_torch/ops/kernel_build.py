"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Builds happen at first use, into
``build/kfac_torch_kernels/`` at the repository root (``.gitignore`` lists
``build/``), and are reused while the library is newer than its source.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing is built or loaded at import time: this module imports on machines
without ``nvcc`` or a GPU, where only the plain PyTorch versions of the
kernels run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kfac_torch_kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points of each source: name -> argtypes (every entry returns the
# cudaError_t of its launches as an int).
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "patch_cov": {
        # x, part, out, B, C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW,
        # has_bias, splits, rows_per_split, scale, stream
        "kfac_patch_cov": (_P, _P, _P) + (_I,) * 16 + (_L, _F, _P),
    },
    "fused_apply": {
        # gm, qa, da, qg, dg, lam, scratch1, scratch2, out, vg, k, g, a, stream
        "kfac_fused_precondition": (_P,) * 10 + (_I, _I, _I, _P),
    },
    "fused_sgd": {
        # params**, grads**, trace**, sizes*, count, lr, momentum, wd, stream
        "kfac_fused_sgd": (_P, _P, _P, _P, _I, _F, _F, _F, _P),
    },
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ at "
        "first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compile every stale source in parallel; returns the wall seconds.

    Raises with the compiler's output if any build fails. ``-Xptxas -v``
    reports (registers, shared memory, spills) are kept beside each
    library as ``lib<name>.log``.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    failures = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"lib{n}.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, library_path(n))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launches."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def current_stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream
