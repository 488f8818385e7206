"""The whole slice: ResNet train steps of the port against the JAX package.

A JAX CIFAR ResNet with one block per stage (``STEP_ARCH``, an 8-layer
``resnet8``: the stem, a plain and two strided blocks, so every conv,
BatchNorm, option-A shortcut and dense kind of ``resnet20``, at a fraction
of its XLA compile time) is initialized, its weights are carried into the
port's model with ``interop.state_dict_from_jax``, and both take the same
steps on the same numpy batches (4 images of 8×8): forward → CE loss → backward →
``KFAC.update`` → fused SGD, with K-FAC on (``kfac_update_freq=2``: steps 0
and 2 refresh the eigenbases, every step captures) and off (plain SGD).
After each step the loss, every parameter and the BatchNorm running
buffers must agree. The JAX side runs as its own tests run it: its default
(dense) kernel scopes on the CPU; the port's side runs its default
``"auto"`` routes, i.e. its kernels' plain versions on CPU tensors.

Also: ``state_dict_from_jax`` round-trips through the JAX package's
``convert_cifar_state_dict`` bit for bit; the eval-mode forward (running
BatchNorm statistics) matches; the lr schedule and synthetic batches match
exactly and the CE loss to 1e-6.

Tolerances: both sides are float32 with different summation orders, and
with K-FAC the damped eigenbasis solve amplifies rounding by up to 1/λ
(λ = 0.003). Each step's loss holds to 1e-5 relative and every tensor to
``|port − jax| ≤ 2e-5·max|jax| + 1e-6`` per tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.torch_interop import convert_cifar_state_dict
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import state_dict_from_jax
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
)

ARCH = "resnet20"
STEP_ARCH = "resnet8"  # the train-step tests: one block per stage
BATCH, SIZE, STEPS = 4, 8, 4
LR, MOMENTUM, WD = 0.1, 0.9, 5e-4
HP = dict(lr=LR, factor_decay=0.95, damping=0.003, kl_clip=0.001,
          fac_update_freq=1, kfac_update_freq=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init(seed=0, arch=ARCH, jit=None):
    """The JAX model, its init batch and variables; ``model.init`` jitted
    (one compile costs less than the eager ops' first dispatches) unless
    ``jit`` is False, the train-step tests' default (``STEP_ARCH``): under
    the suite's XLA flags the eager init rounds some weights differently,
    and on the jitted init's weights the diagonal-block run's trajectories
    part at step 3 on a ReLU input of 1e-7 whose sign the two packages'
    float32 forward passes decide apart
    (``test_torch_port_options.py::test_option_train_steps_match_jax
    [blocks-jitted-init]`` holds that case through its last refresh)."""
    if arch == STEP_ARCH:
        model = jresnet.CifarResNet(stage_sizes=(1, 1, 1))
    else:
        model = jresnet.get_model(arch)
    init = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    if jit is None:
        jit = arch != STEP_ARCH
    fn = lambda k, x: model.init(k, x, train=True)  # noqa: E731
    variables = (jax.jit(fn) if jit else fn)(jax.random.PRNGKey(seed), init)
    return model, init, variables["params"], variables["batch_stats"]


def step_models(seed=0, jit=False):
    """``(jax model, init batch, params, batch_stats, port model)`` of
    ``STEP_ARCH`` with the JAX weights (of a jitted ``model.init`` with
    ``jit``) carried into the port's model."""
    jmodel, init, params, stats = _jax_init(seed, STEP_ARCH, jit)
    model = cifar_resnet.CifarResNet(1, 10)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), _np_tree(stats), STEP_ARCH))
    return jmodel, init, params, stats, model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batches(steps=STEPS):
    r = np.random.RandomState(90)
    return [
        (r.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
         r.randint(0, 10, size=BATCH).astype(np.int32))
        for _ in range(steps)
    ]


def test_state_dict_from_jax_round_trips_bitwise():
    _, _, params, stats = _jax_init(1)
    p, s = _np_tree(params), _np_tree(stats)
    sd = state_dict_from_jax(p, s, ARCH)
    model = cifar_resnet.get_model(ARCH)
    model.load_state_dict(sd)  # strict: every key, every shape
    back_p, back_s = convert_cifar_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, ARCH
    )
    for want, got in ((p, back_p), (s, back_s)):
        wl, wt = jax.tree_util.tree_flatten(want)
        gl, gt = jax.tree_util.tree_flatten(got)
        assert wt == gt
        for a, b in zip(wl, gl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        state_dict_from_jax(p, s, "resnet21")


@pytest.mark.parametrize("use_kfac", [True, False])
def test_train_steps_match_jax(use_kfac):
    jmodel, init, params, stats, model = step_models(0)

    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    jk = tk = None
    if use_kfac:
        jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), **HP)
        tk = KFAC(layers=capture.discover_layers(model), device="cpu", **HP)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params) if jk else None,
    )
    tstate = TrainState(
        step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
        kfac_state=tk.init(model) if tk else None,
    )
    sgd_hyper = (MOMENTUM, WD) if use_kfac else None
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True}, sgd_hyper=sgd_hyper)
    tstep = make_train_step(model, tx, tk, sgd_hyper=sgd_hyper)

    for i, (x, y) in enumerate(_batches()):
        jf, tf = jflags(i, jk), kfac_flags_for_step(i, tk)
        assert jf == tf
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        batch = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                 torch.from_numpy(y))
        tstate, tm = tstep(tstate, batch, LR, HP["damping"], **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        want = state_dict_from_jax(
            _np_tree(jstate.params), _np_tree(jstate.batch_stats), STEP_ARCH
        )
        got = model.state_dict()
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            w, g = w.numpy(), got[key].numpy()
            bound = 2e-5 * float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"step {i}: {key}")
    if use_kfac:
        assert tstate.kfac_state["step"] == STEPS


def test_eval_forward_matches_jax():
    """Inference mode: BatchNorm normalizes with the carried running stats."""
    jmodel, _, params, stats = _jax_init(2)
    r = np.random.RandomState(91)
    # non-trivial running statistics, so eval mode really reads them
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.abs(r.randn(*v.shape)).astype(np.float32) + 0.5), stats
    )
    model = cifar_resnet.get_model(ARCH)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), _np_tree(stats), ARCH))
    model.eval()
    x = r.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_schedule_data_and_loss_helpers_match_jax():
    from kfac_pytorch_tpu.training.data import synthetic_batches as jbatches
    from kfac_pytorch_tpu.training.schedules import create_lr_schedule as jsched
    from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
    from kfac_pytorch_tpu_torch.training.data import synthetic_batches
    from kfac_pytorch_tpu_torch.training.schedules import create_lr_schedule
    from kfac_pytorch_tpu_torch.training.step import softmax_cross_entropy

    for args in ((1, 5, [35, 75, 90]), (4, 2.5, [3, 1]), (2, 0, [1])):
        j, t = jsched(*args), create_lr_schedule(*args)
        for e in (0.0, 0.7, 1.0, 2.4, 3.0, 40.0, 80.0, 95.5):
            assert t(e) == j(e)
    for (jx, jy), (tx, ty) in zip(
        jbatches(3, (4, 5, 3), 7, 10, seed=5), synthetic_batches(3, (3, 4, 5), 7, 10, seed=5)
    ):
        np.testing.assert_array_equal(tx, jx.transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(ty, jy)
    r = np.random.RandomState(92)
    logits = r.randn(6, 10).astype(np.float32) * 3
    labels = r.randint(0, 10, size=6).astype(np.int32)
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(
            float(softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), ls)),
            float(jce(jnp.asarray(logits), jnp.asarray(labels), ls)), rtol=1e-6,
        )
