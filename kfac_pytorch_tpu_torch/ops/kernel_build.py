"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Builds happen at first use, into
``build/kfac_torch_kernels/`` at the repository root (``.gitignore`` lists
``build/``), and are reused while the library is newer than its source and
every header of ``csrc/`` that the source includes.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing is built or loaded at import time: this module imports on machines
without ``nvcc`` or a GPU, where only the plain PyTorch versions of the
kernels run.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

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
        # has_bias, groups, x is bfloat16, int[7] plan, scale, stream
        "kfac_patch_cov": (_P, _P, _P) + (_I,) * 17 + (_P, _F, _P),
        # x, B, C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, has_bias,
        # groups, x is bfloat16, int[7] out -> the plan (tile, copy bytes,
        # layout, splits, output rows and columns per stage, partial side)
        "kfac_patch_cov_plan": (_P,) + (_I,) * 17 + (_P,),
    },
    "fused_apply": {
        # gm, qa, da, qg, dg, lam, scratch1, scratch2, out, vg, k, g, a,
        # Q is bfloat16, stream
        "kfac_fused_precondition": (_P,) * 10 + (_I, _I, _I, _I, _P),
        # k, g, a, gm, qa, qg, Q is bfloat16 -> the plan's tile and copy
        # widths (bits)
        "kfac_fused_apply_route": (_I, _I, _I, _P, _P, _P, _I),
    },
    "fused_sgd": {
        # LeafTable<cap>*, cap, blocks, lr, momentum, wd, stream
        "kfac_fused_sgd": (_P, _I, _I, _P, _F, _F, _P),
        # cap -> sizeof(LeafTable<cap>)
        "kfac_fused_sgd_table_bytes": (_I,),
    },
    "token_count": {
        # ids, ids_int64, n, vocab, bins per block, clusters, out, tally, stream
        "kfac_token_count": (_P, _I, _L, _I, _I, _I, _P, _P, _P),
    },
    "flash_attention": {
        # q, k, v, strides*, o, lse, B, T, H, D, causal, scale, stream
        "kfac_flash_fwd": (_P,) * 6 + (_I,) * 5 + (_F, _P),
        # q, k, v, dO, strides*, lse, delta, dq, B, T, H, D, causal, scale,
        # stream
        "kfac_flash_dq": (_P,) * 8 + (_I,) * 5 + (_F, _P),
        # q, k, v, dO, strides*, lse, delta, dk, dv, chunk rows, B, T, H,
        # D, causal, scale, stream
        "kfac_flash_dkv": (_P,) * 9 + (_I,) * 6 + (_F, _P),
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files or not path.exists():
            continue
        files.append(path)
        todo.extend(CSRC / inc for inc in _INCLUDE.findall(path.read_text()))
    return files


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < path.stat().st_mtime for path in _inputs(name))


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
