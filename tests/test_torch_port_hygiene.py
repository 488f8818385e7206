"""The port stands alone, and its trainer runs end to end on the CPU.

* Import hygiene: in a fresh interpreter, import every module of
  ``kfac_pytorch_tpu_torch`` and ``chip_smoke``; nothing of JAX (``jax``,
  ``jaxlib``, ``flax``, ``optax``) or of the JAX package may be loaded.
* Packaging: both ``setup.py`` and the port's own ``setup_torch.py``
  ship every CUDA source and header `ops/kernel_build.py` compiles, and
  ``setup_torch.py`` requires nothing of JAX.
* The trainer twin runs a few steps of a small ResNet on the CPU when
  asked to (``--device cpu``), with K-FAC on and off, and on the learnable
  stand-in when no CIFAR-10 is found; every flag of the JAX CIFAR trainer,
  and of the JAX WikiText trainer, either parses in its twin or is refused
  naming its ROADMAP item.
"""

import ast
import functools
import math
import os
import re
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
    print(" ".join(names))
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
    # the native loader, the data-parallel modules, the factor comm plane,
    # the shard lenses, the 3-D world's compute split and fsdp parts, the
    # elastic runtime and the curvature service among them
    imported = set(res.stdout.splitlines()[1].split())
    assert {f"kfac_pytorch_tpu_torch.{m}" for m in (
        "runtime", "runtime.loader", "parallel.launch", "parallel.mesh",
        "parallel.assignment", "parallel.sharded_eigh", "parallel.comm",
        "parallel.tensor", "parallel.fsdp", "shardwise", "shardwise.lenses",
        "elastic", "elastic.state_io", "elastic.replan", "elastic.supervisor",
        "elastic.faults", "service", "service.mailbox", "service.worker",
        "service.client")} <= imported, res.stdout


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
    ``csrc/`` header it includes (``kernel_build._inputs``), and the native
    loader's C++ source (``runtime/loader.py``): an installed copy can build
    every kernel and the loader. Nothing is written into the repository."""
    from kfac_pytorch_tpu_torch.ops import kernel_build
    from kfac_pytorch_tpu_torch.runtime import loader

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
    needed.add(loader.SOURCE.name)
    assert {"tf32_mma.cuh", "loader.cpp"} <= needed and needed <= shipped, needed - shipped
    # the port's Python modules ship too, the factor comm plane among them
    assert (out / "kfac_pytorch_tpu_torch" / "parallel" / "comm.py").is_file()
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


def test_trainer_without_data_uses_the_stand_in(monkeypatch, capsys):
    """No ``--synthetic`` and no CIFAR-10 in ``--data-dir``: the twin trains
    on the learnable stand-in (made smaller here) and evaluates its whole
    validation split, as the JAX trainer does; next to real data the
    stand-in's flags are refused (``test_torch_port_data.py`` covers the
    loader and the run on data)."""
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training import data

    small = functools.partial(data.synthetic_cifar_like, n_train=16, n_test=10)
    monkeypatch.setattr(trainer.data_lib, "synthetic_cifar_like", small)
    hist = trainer.main([
        "--data-dir", os.path.join(REPO, "no-such-dir"), "--model", "resnet20",
        "--batch-size", "8", "--val-batch-size", "4", "--epochs", "1", "--device", "cpu",
        "--synth-prototypes", "2",
    ])
    out = capsys.readouterr().out
    assert "synthetic-learnable stand-in" in out and "16 train / 10 val" in out
    assert len(hist["loss"]) == 2 and hist["val_count"] == [10]
    args = trainer.parse_args(["--synth-noise", "0.3"])
    monkeypatch.setattr(trainer.data_lib, "find_cifar10", lambda d: "/cifar")
    with pytest.raises(SystemExit, match="--synth-noise only apply to the learnable stand-in"):
        trainer.load_data(args)


def _jax_trainer_flags(script="train_cifar10_resnet.py"):
    """Every ``--flag`` a JAX trainer's parser declares (read from its
    source: importing it would import JAX)."""
    tree = ast.parse(open(os.path.join(REPO, "examples", script)).read())
    return [
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
        and node.args and isinstance(node.args[0], ast.Constant)
    ]


def test_every_jax_trainer_flag_parses_or_names_its_item():
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    jax_flags = _jax_trainer_flags()
    assert len(jax_flags) > 50
    ported = set(trainer.build_parser()._option_string_actions)
    # every flag is ported since the curvature service (item 9d), the last
    # one each trainer refused
    for flag in jax_flags:
        assert flag in ported, f"{flag} is not ported"
    assert trainer.parse_args(["--service-devices", "7"]).service_devices == 7
    args = trainer.parse_args(["--precond-method", "inverse", "--diag-blocks", "4",
                               "--diag-warmup", "1", "--batches-per-allreduce", "2",
                               "--stats-all-microbatches", "--kfac-diagnostics",
                               "--label-smoothing", "0.1", "--kfac-update-freq-schedule", "3"])
    assert (args.precond_method, args.diag_blocks, args.batches_per_allreduce) == ("inverse", 4, 2)
    # the loader (ROADMAP item 9a) and data-parallel (item 6a) flags, refused
    # until they were ported
    args = trainer.parse_args(["--num-workers", "7", "--distribute-precondition",
                               "--distribute-layer-factors", "true",
                               "--precond-comm-dtype", "bf16", "--grad-comm-dtype", "bf16"])
    assert (args.num_workers, args.distribute_precondition, args.distribute_layer_factors,
            args.precond_comm_dtype, args.grad_comm_dtype) == (7, True, True, "bf16", "bf16")
    # the factor comm plane's flags (item 6b)
    args = trainer.parse_args(["--factor-comm-dtype", "int8", "--factor-comm-freq", "4"])
    assert (args.factor_comm_dtype, args.factor_comm_freq) == ("int8", 4)


def test_every_jax_wikitext_flag_parses_or_names_its_item():
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    jax_flags = _jax_trainer_flags("train_wikitext_rnn.py")
    assert len(jax_flags) > 30
    ported = set(trainer.build_parser()._option_string_actions)
    # every flag is ported since the curvature service (item 9d), the last
    # one each trainer refused
    for flag in jax_flags:
        assert flag in ported, f"{flag} is not ported"
    assert trainer.parse_args(["--service-devices", "7"]).service_devices == 7
    args = trainer.parse_args(["--tied", "--kfac-embedding", "--model", "GRU",
                               "--apply-kernel", "dense", "--lr-decay", "3", "4"])
    assert (args.tied, args.kfac_embedding, args.model, args.lr_decay) == (True, True, "GRU", [3, 4])


def _open_items():
    """The items ROADMAP.md's queue 1 still lists to port (its "Still to
    port:" line, each item in bold)."""
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    line = next(ln for ln in queue.splitlines() if ln.startswith("Still to port:"))
    return set(re.findall(r"\*\*(\d+[a-z]?)\*\*", line))


def test_refusals_name_open_roadmap_items():
    """Every "ROADMAP queue 1 item N" the port names (a refusal of ``KFAC``,
    a trainer's later-flag table, a docstring) was an item ROADMAP.md still
    listed as open. The curvature service (item 9d) closed queue 1: the
    port names no item, keeps no ``_not_ported`` refusal and no trainer
    table of later flags, and ROADMAP.md's "Still to port:" names none."""
    import importlib

    port = os.path.join(REPO, "kfac_pytorch_tpu_torch")
    named = set()
    for root, _, files in os.walk(port):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = open(os.path.join(root, f)).read()
            named |= set(re.findall(r"queue 1 item (\d+[a-z]?)", src))
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_not_ported":
                    named.add(node.args[1].value)
    for name in ("train_cifar10_resnet", "train_transformer_lm", "train_wikitext_rnn"):
        trainer = importlib.import_module(f"kfac_pytorch_tpu_torch.examples.{name}")
        assert not hasattr(trainer, "_LATER_FLAGS"), name
    assert named == set() and _open_items() == set()
