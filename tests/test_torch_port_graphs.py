"""The step's device scalars and the graphed step's keys, on the CPU.

The graphed step (``training/graphs.py``) hands the train step ``lr`` and
``damping`` as 0-d float32 tensors, so that a replay reads each step's
values: an eager ResNet-8 step given them must be bitwise the step given
the floats, through refreshes, on the fused-SGD and the per-leaf route and
under both preconditioning methods; the KL clip and the plain SGD must
give the same bits with a tensor ``lr``. ``GraphedTrainStep`` refuses a
CPU device, and the keys it captures under, over a trainer's cadence,
number exactly ``compile_cache.expected_step_variants``. The capture and
the replays themselves need the card (``tests/test_torch_port_cuda.py``).
"""

import copy

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence, capture
from kfac_pytorch_tpu_torch.compile_cache import expected_step_variants
from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar_twin
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.ops import apply_kernels, precondition
from kfac_pytorch_tpu_torch.parallel.mesh import World
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


@pytest.mark.parametrize("flags,why", [
    ([], None),
    (["--comm-overlap"], "--comm-overlap"),
    (["--service-devices", "1"], "--service-devices"),
    (["--precond-method", "inverse"], "--precond-method inverse"),
])
def test_the_twin_names_why_its_step_stays_eager(flags, why):
    """The rule decided before training: the eager step on the CPU and for
    the configurations the graphed step does not cover, named; the graphed
    step on a CUDA device otherwise (the rule reads the device's type only)."""
    args = cifar_twin.parse_args(["--synthetic", *flags])
    assert "cpu device" in cifar_twin.eager_step_reason(args, World(), torch.device("cpu"))
    got = cifar_twin.eager_step_reason(args, World(), torch.device("cuda"))
    assert got == why if why is None else got.startswith(why)


# a trainer's epochs: (configuration, epochs, steps per epoch)
CADENCES = [
    ("default", {}, 3, 25),
    ("chunks3_freq6", dict(eigh_chunks=3, kfac_update_freq=6), 2, 40),
    ("warmup_resume_chunks3", dict(diag_blocks=2, diag_warmup=2, eigh_chunks=3,
                                   kfac_update_freq=6), 5, 40),
    ("streaming", dict(solver="streaming", fac_update_freq=1, kfac_update_freq=3), 2, 12),
    ("no_kfac", None, 2, 5),
]


@pytest.mark.parametrize("name,kw,epochs,per_epoch", CADENCES, ids=[c[0] for c in CADENCES])
def test_keys_over_a_cadence_number_the_budget(name, kw, epochs, per_epoch):
    """The keys a trainer's run hands the graphed step (a run, and a resume
    of it past any diag warmup), captured or eager by rule, number exactly
    the budget; under streaming a boundary whose drift stays low skips its
    re-orthonormalization, the eager refresh's captured twin."""
    kfac = None if kw is None else KFAC(damping=0.01, device="cpu", **kw)
    keys = set()
    starts = [0] if kfac is None or not kfac.diag_warmup else [0, kfac.diag_warmup]
    for start in starts:
        cadence = EigenRefreshCadence(kfac)
        for epoch in range(start, start + epochs):
            for i in range(per_epoch):
                step = (epoch - start) * per_epoch + i
                flags = cadence.flags_for_step(step, epoch)
                keys.add(variant_key(flags))
                if kw is not None and kw.get("solver") == "streaming" and flags["update_eigen"]:
                    keys.add(variant_key({**flags, "update_eigen": False}))
    assert len(keys) == expected_step_variants(kfac)
    captured = [k for k in keys if eager_variant_reason(dict(k)) is None]
    eager = [k for k in keys if eager_variant_reason(dict(k)) is not None]
    assert all(any(dict(k).get(f) not in (None, False) for f in EAGER_VARIANTS) for k in eager)
    assert captured and len(captured) + len(eager) == len(keys)
