"""The port stands alone, and its trainer runs end to end on the CPU.

* Import hygiene: in a fresh interpreter, import every module of
  ``kfac_pytorch_tpu_torch`` and ``chip_smoke``; nothing of JAX (``jax``,
  ``jaxlib``, ``flax``, ``optax``) or of the JAX package may be loaded.
* The trainer twin runs a few steps of a small ResNet on the CPU when
  asked to (``--device cpu``), with K-FAC on and off.
"""

import math
import os
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
