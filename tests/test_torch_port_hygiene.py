"""The port stands alone, and its trainer runs end to end on the CPU.

* Import hygiene: in a fresh interpreter, import every module of
  ``kfac_pytorch_tpu_torch`` and ``chip_smoke``; nothing of JAX (``jax``,
  ``jaxlib``, ``flax``, ``optax``) or of the JAX package may be loaded.
* Packaging: both ``setup.py`` and the port's own ``setup_torch.py``
  ship every CUDA source and header `ops/kernel_build.py` compiles, and
  ``setup_torch.py`` requires nothing of JAX.
* The trainer twin runs a few steps of a small ResNet on the CPU when
  asked to (``--device cpu``), with K-FAC on and off.
"""

import ast
import math
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import kfac_pytorch_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    banned = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "kfac_pytorch_tpu")
    )
    print(len(names), "modules;", "banned:", banned)
    sys.exit(1 if banned else 0)
    """
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20, res.stdout


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke would run for real")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "CUDA is not available" in res.stderr


def _setup_requires(path):
    """``install_requires`` of the ``setup(...)`` call in ``path``."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "setup":
            for kw in node.keywords:
                if kw.arg == "install_requires":
                    return ast.literal_eval(kw.value)
    return []


@pytest.mark.parametrize("setup_file", ["setup.py", "setup_torch.py"])
def test_packaging_ships_every_kernel_input(tmp_path, setup_file):
    """``build_py`` of a copy of the tree ships each CUDA source and every
    ``csrc/`` header it includes (``kernel_build._inputs``): an installed
    copy can build every kernel. Nothing is written into the repository."""
    from kfac_pytorch_tpu_torch.ops import kernel_build

    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(os.path.join(REPO, setup_file), tree)
    for pkg in ("kfac_pytorch_tpu", "kfac_pytorch_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), tree / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"))
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, setup_file, "-q", "build_py", "-d", str(out)], cwd=tree,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    shipped = {p.name for p in (out / "kfac_pytorch_tpu_torch" / "csrc").iterdir()}
    needed = {p.name for name in kernel_build.SIGNATURES for p in kernel_build._inputs(name)}
    assert "tf32_mma.cuh" in needed and needed <= shipped, needed - shipped
    if setup_file == "setup_torch.py":
        assert not (out / "kfac_pytorch_tpu").exists()
        requires = _setup_requires(tree / setup_file)
        assert "torch" in requires
        assert not {r for r in requires if r.split("=")[0].split(">")[0].strip()
                    in ("jax", "jaxlib", "flax", "optax", "orbax-checkpoint")}


@pytest.mark.parametrize("kfac_freq", ["2", "0"])
def test_trainer_runs_on_cpu(kfac_freq):
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    hist = trainer.main([
        "--synthetic", "--model", "resnet20", "--batch-size", "4", "--epochs", "1",
        "--steps-per-epoch", "3", "--device", "cpu", "--kfac-update-freq", kfac_freq,
    ])
    assert len(hist["loss"]) == 3 and all(math.isfinite(v) for v in hist["loss"])
    want = ["refresh", "capture", "refresh"] if kfac_freq == "2" else ["plain"] * 3
    assert hist["kind"] == want


def test_trainer_refuses_real_data_for_now():
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    with pytest.raises(SystemExit, match="synthetic"):
        trainer.main(["--device", "cpu"])
