"""The step's device scalars and the graphed step's keys, on the CPU.

The graphed step (``training/graphs.py``) hands the train step ``lr`` and
``damping`` as 0-d float32 tensors, so that a replay reads each step's
values: an eager ResNet-8 step given them must be bitwise the step given
the floats, through refreshes, on the fused-SGD and the per-leaf route and
under both preconditioning methods; the KL clip and the plain SGD must
give the same bits with a tensor ``lr``. ``GraphedTrainStep`` refuses a
CPU device, and the keys it captures under, over a trainer's cadence (the
CIFAR twin's and the transformer LM twin's), number exactly
``compile_cache.expected_step_variants``. Each of the three graphed twins
names why a configuration keeps the eager step, and the LM twin watches
its steps under the JAX trainer's names and budgets (skipped on the CPU,
where the step is eager). The capture and the replays themselves need the
card (``tests/test_torch_port_cuda.py``).
"""

import copy
import pathlib
import re

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence, capture
from kfac_pytorch_tpu_torch.compile_cache import expected_step_variants
from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar_twin
from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as imagenet_twin
from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_twin
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.ops import apply_kernels, precondition
from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.training import graphs
from kfac_pytorch_tpu_torch.training.graphs import (
    EAGER_VARIANTS,
    GraphedTrainStep,
    eager_variant_reason,
    variant_key,
)
from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

LR, MOMENTUM, WD, DAMPING = 0.1, 0.9, 5e-4, 0.003


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _run(model, kfac_kw, sgd_hyper, scalars, steps=5):
    """``steps`` ResNet-8 steps (refreshes at 0, 2 and 4): the losses and
    metrics per step, then the model, momentum and K-FAC state tensors."""
    tx = make_sgd(MOMENTUM, WD)
    kfac = KFAC(layers=capture.discover_layers(model), lr=LR, damping=DAMPING,
                fac_update_freq=1, kfac_update_freq=2, track_diagnostics=True, device="cpu",
                **kfac_kw)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step = make_train_step(model, tx, kfac, sgd_hyper=sgd_hyper)
    r = np.random.RandomState(3)
    out = []
    for i in range(steps):
        x = torch.from_numpy(r.randn(4, 3, 8, 8).astype(np.float32))
        y = torch.from_numpy(r.randint(0, 10, 4).astype(np.int64))
        lr = LR * (0.5 + 0.13 * i)  # a warmup's changing rate
        damping = DAMPING * (1.0 + 0.7 * (i >= 3))  # one damping step
        if scalars == "tensor":
            lr, damping = (torch.tensor(v, dtype=torch.float32) for v in (lr, damping))
        state, metrics = step(state, (x, y), lr, damping, **{
            "update_factors": True, "update_eigen": i % 2 == 0})
        out += [metrics[k] for k in sorted(metrics)]
    return out + list(model.state_dict().values()) + list(state.opt_state.values()) \
        + _leaves(state.kfac_state)


@pytest.mark.parametrize("method", ["eigen", "inverse"])
@pytest.mark.parametrize("route", ["fused_sgd", "per_leaf_sgd"])
def test_tensor_scalars_give_the_float_steps_bits(route, method):
    torch.manual_seed(0)
    model = cifar_resnet.CifarResNet(1, 10)
    hyper = (MOMENTUM, WD) if route == "fused_sgd" else None
    kw = {"precond_method": method}
    floats = _run(copy.deepcopy(model), kw, hyper, "float")
    tensors = _run(copy.deepcopy(model), kw, hyper, "tensor")
    assert len(floats) == len(tensors)
    for a, b in zip(floats, tensors):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_kl_clip_with_a_tensor_lr_gives_the_same_bits():
    g = torch.Generator().manual_seed(4)
    updates = {f"l{i}": torch.randn(5, 7, generator=g) for i in range(4)}
    grads = {n: torch.randn(5, 7, generator=g) for n in updates}
    terms = [(updates[n] * grads[n]).sum() for n in updates]
    for lr in (0.1, 0.0123456789, 3.3):
        t = torch.tensor(lr, dtype=torch.float32)
        assert torch.equal(precondition.kl_clip_from_vg(terms, lr, 0.001),
                           precondition.kl_clip_from_vg(terms, t, 0.001))
        assert torch.equal(precondition.kl_clip_coefficient(updates, grads, lr, 0.001),
                           precondition.kl_clip_coefficient(updates, grads, t, 0.001))


def test_plain_sgd_with_a_tensor_lr_gives_the_same_bits():
    g = torch.Generator().manual_seed(5)
    shapes = [(3, 4), (7,), (2, 3, 3, 3)]
    params, grads, trace = ([torch.randn(s, generator=g) for s in shapes] for _ in range(3))
    for lr in (0.1, 0.0123456789):
        got_p, got_m = [p.clone() for p in params], [m.clone() for m in trace]
        want_p, want_m = [p.clone() for p in params], [m.clone() for m in trace]
        apply_kernels.fused_sgd_apply(got_p, grads, got_m, torch.tensor(lr), MOMENTUM, WD)
        apply_kernels.fused_sgd_apply_plain(want_p, grads, want_m, lr, MOMENTUM, WD)
        for a, b in zip(got_p + got_m, want_p + want_m):
            assert torch.equal(a, b)


def test_graphed_step_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphedTrainStep(lambda *a, **k: None, torch.device("cpu"))


TWINS = {"cifar": cifar_twin, "lm": lm_twin, "imagenet": imagenet_twin}
# a data-parallel world of two ranks, as a process group hands the twins
TWO_RANKS = World(size=2, distributed=True)


@pytest.mark.parametrize("twin,flags,world,why", [
    pytest.param("cifar", [], World(), None, id="flags0-None"),
    pytest.param("cifar", ["--comm-overlap"], World(), "--comm-overlap",
                 id="flags1---comm-overlap"),
    pytest.param("cifar", ["--service-devices", "1"], World(), "--service-devices",
                 id="flags2---service-devices"),
    pytest.param("cifar", ["--precond-method", "inverse"], World(), "--precond-method inverse",
                 id="flags3---precond-method inverse"),
    pytest.param("lm", [], World(), None, id="lm-graphed"),
    pytest.param("lm", [], TWO_RANKS, "a process group of 2", id="lm-process-group"),
    pytest.param("lm", ["--seq-parallel", "2"], TWO_RANKS, "a process group of 2",
                 id="lm-seq-world"),
    pytest.param("lm", ["--service-devices", "1"], World(), "--service-devices",
                 id="lm-service-devices"),
    pytest.param("lm", ["--comm-overlap"], World(), "--comm-overlap", id="lm-comm-overlap"),
    pytest.param("imagenet", [], World(), None, id="imagenet-graphed"),
    pytest.param("imagenet", [], TWO_RANKS, "a process group of 2",
                 id="imagenet-process-group"),
    pytest.param("imagenet", ["--precond-method", "inverse"], World(),
                 "--precond-method inverse", id="imagenet-inverse"),
])
def test_the_twin_names_why_its_step_stays_eager(twin, flags, world, why):
    """The rule decided before training: the eager step on the CPU and for
    the configurations the graphed step does not cover, named; the graphed
    step on a CUDA device otherwise (the rule reads the device's type
    only). The twin's own name is the rule ``training.graphs`` keeps (a
    phase of the smoke patches it there for its eager reference), and a
    flag the twin lacks (the LM's ``--precond-method``) counts as off."""
    module = TWINS[twin]
    assert module.eager_step_reason is graphs.eager_step_reason
    args = module.parse_args(["--synthetic", *flags])
    assert "cpu device" in module.eager_step_reason(args, world, torch.device("cpu"))
    got = module.eager_step_reason(args, world, torch.device("cuda"))
    assert got == why if why is None else got.startswith(why)


def test_compiled_step_keeps_the_eager_step_where_a_reason_is_given(capsys):
    """``compiled_step`` hands back the step itself, and the budget, when
    the twin names a reason, and prints that reason once."""
    def step(*a, **k):
        return None

    kfac = KFAC(damping=0.01, device="cpu", kfac_update_freq=4, fac_update_freq=2)
    got, budget = graphs.compiled_step(step, kfac, torch.device("cpu"), "cpu device: why")
    assert got is step and budget == expected_step_variants(kfac)
    assert capsys.readouterr().out == "train step: eager (cpu device: why)\n"


# the LM twin at a small width with the recipe's K-FAC flags (the token
# embedding's diagonal A, every cadence flag at the trainer's default)
LM_TINY = ["--synthetic", "--d-model", "16", "--n-heads", "2", "--n-layers", "1",
           "--seq-len", "16", "--batch-size", "2", "--kfac-embedding", "--device", "cpu"]

# a trainer's epochs: (configuration, KFAC keywords or the LM twin's
# argv, epochs, steps per epoch)
CADENCES = [
    ("default", {}, 3, 25),
    ("chunks3_freq6", dict(eigh_chunks=3, kfac_update_freq=6), 2, 40),
    ("warmup_resume_chunks3", dict(diag_blocks=2, diag_warmup=2, eigh_chunks=3,
                                   kfac_update_freq=6), 5, 40),
    ("streaming", dict(solver="streaming", fac_update_freq=1, kfac_update_freq=3), 2, 12),
    ("no_kfac", None, 2, 5),
    ("lm_recipe", LM_TINY, 2, 25),
    ("lm_streaming", [*LM_TINY, "--solver", "streaming"], 2, 25),
    ("lm_chunks3", [*LM_TINY, "--eigh-chunks", "3"], 2, 25),
]


def _cadence_kfac(kw):
    """The ``KFAC`` of a ``CADENCES`` entry: built from its keywords, or
    by the LM twin from its argv."""
    if kw is None:
        return None
    if isinstance(kw, list):
        return lm_twin.build(lm_twin.parse_args(kw), torch.device("cpu"))[1]
    return KFAC(damping=0.01, device="cpu", **kw)


@pytest.mark.parametrize("name,kw,epochs,per_epoch", CADENCES, ids=[c[0] for c in CADENCES])
def test_keys_over_a_cadence_number_the_budget(name, kw, epochs, per_epoch):
    """The keys a trainer's run hands the graphed step (a run, and a resume
    of it past any diag warmup), captured or eager by rule, number exactly
    the budget; under streaming a boundary whose drift stays low skips its
    re-orthonormalization, the eager refresh's captured twin."""
    kfac = _cadence_kfac(kw)
    streaming = kfac is not None and kfac.solver == "streaming"
    keys = set()
    starts = [0] if kfac is None or not kfac.diag_warmup else [0, kfac.diag_warmup]
    for start in starts:
        cadence = EigenRefreshCadence(kfac)
        for epoch in range(start, start + epochs):
            for i in range(per_epoch):
                step = (epoch - start) * per_epoch + i
                flags = cadence.flags_for_step(step, epoch)
                keys.add(variant_key(flags))
                if streaming and flags["update_eigen"]:
                    keys.add(variant_key({**flags, "update_eigen": False}))
    assert len(keys) == expected_step_variants(kfac)
    captured = [k for k in keys if eager_variant_reason(dict(k)) is None]
    eager = [k for k in keys if eager_variant_reason(dict(k)) is not None]
    assert all(any(dict(k).get(f) not in (None, False) for f in EAGER_VARIANTS) for k in eager)
    assert captured and len(captured) + len(eager) == len(keys)


def _jax_lm_watches():
    """The JAX LM trainer's ``recompiles.watch`` calls, from its source:
    ``[(name, budget expression)]``."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "train_transformer_lm.py").read_text()
    return re.findall(r'recompiles\.watch\("(\w+)", \w+, ([^)]+\)?)\)', src)


def test_lm_twin_watches_its_steps_as_the_jax_trainer(monkeypatch, tmp_path):
    """The LM twin hands ``RecompileMonitor`` its ``train_step`` at
    ``expected_step_variants(kfac)`` and its ``eval_step`` at 1, the JAX
    trainer's names and budgets, and checks once an epoch; on the CPU both
    steps are eager, so the monitor skips them (as the JAX monitor skips a
    callable that is not jitted): no gauge, no retrace, no compiled-step
    record."""
    assert _jax_lm_watches() == [("train_step", "expected_step_variants(kfac)"),
                                 ("eval_step", "1")]
    calls = {"watch": [], "check": []}

    class Recording(lm_twin.RecompileMonitor):
        def watch(self, name, fn, expected_variants=1):
            calls["watch"].append((name, fn, expected_variants))
            super().watch(name, fn, expected_variants)

        def check(self):
            calls["check"].append(dict(self._watched))
            return super().check()

    monkeypatch.setattr(lm_twin, "RecompileMonitor", Recording)
    argv = [*LM_TINY, "--epochs", "2", "--steps-per-epoch", "3", "--kfac-update-freq", "2",
            "--telemetry-dir", str(tmp_path)]
    hist = lm_twin.main(argv)
    kfac = lm_twin.build(lm_twin.parse_args(argv), torch.device("cpu"))[1]
    assert [(n, b) for n, _, b in calls["watch"]] == [
        ("train_step", expected_step_variants(kfac)), ("eval_step", 1)]
    assert not any(isinstance(fn, GraphedTrainStep) for _, fn, _ in calls["watch"])
    assert calls["check"] == [{}, {}]
    assert "compiled_step" not in hist and len(hist["loss"]) == 6
    snap = hist["telemetry"]
    assert not snap["counters"].get("compile/retraces")
    assert not any(k.startswith("compile/cache_size/") for k in snap["gauges"])
