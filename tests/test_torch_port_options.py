"""The port's numerical options against the JAX package, on the CPU.

* ``factored_inverse_all`` and ``precondition_all_inv`` (the inverse
  method) on a stacked pair, a singleton and a diagonal-A (embedding)
  layer, at the JAX package's own ``rtol=1e-4, atol=1e-5``;
* the refresh's blocked slots against JAX's ``blocked_eigh``: eigenvalues
  at 1e-5, the block-diagonal Q and its reconstruction;
* the inverse method's diagnostics (no spectra);
* 4 ResNet-8 train steps (``STEP_ARCH``: one block per stage) each for the inverse method and ``diag_blocks=2``
  with a ``diag_warmup`` change between the two refreshes (steps 0 and 2)
  (``run_option_train_steps``, which ``tests/test_torch_port_accum.py``
  also runs for gradient accumulation), the diagnostics on, at
  ``tests/test_torch_port_train.py``'s bounds (loss 1e-5 relative, every
  tensor ``2e-5·max|jax| + 1e-6``); the ``kfac_*`` diagnostics of each step
  to 1e-3 relative (condition numbers and ν carry the damped solve's
  rounding amplification, up to 1/λ);
* ``diag_blocks=2`` again on the weights of a jitted ``model.init``, at the
  same bounds through the step-2 refresh, where each block's sorted
  eigenvalues, each basis' reconstruction, every preconditioned gradient
  and ν hold to 1e-5 of their largest entry (``EIG_RTOL`` and its
  neighbours): that run's trajectories part at step 3 through one ReLU
  whose input (1e-7) the two float32 forward passes round to opposite
  signs, not through the blocks.

The JAX side runs as its own tests run it (dense kernel scopes on the CPU);
the port's side takes its ``"auto"`` routes (the plain versions on CPU
tensors; the inverse method takes the dense apply).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.ops import eigh as jeigh
from kfac_pytorch_tpu.ops import precondition as jpc
from kfac_pytorch_tpu.training import step as jstep
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.interop import state_dict_from_jax
from kfac_pytorch_tpu_torch.ops import eigh as teigh
from kfac_pytorch_tpu_torch.ops import precondition as tpc
from kfac_pytorch_tpu_torch.parallel.sharded_eigh import replicated_eigen_update
from kfac_pytorch_tpu_torch.training.step import (
    TrainState,
    kfac_flags_for_step,
    make_sgd,
    make_train_step,
)
from tests.test_torch_port_distributed import _JAX_LAYER
from tests.test_torch_port_kfac import LAYERS, ConvDenseNet, _problem
from tests.test_torch_port_train import (
    BATCH, HP, LR, MOMENTUM, STEP_ARCH, STEPS, WD, _batches, _np_tree, step_models,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd(r, n):
    m = r.randn(n, 2 * n).astype(np.float32)
    return (m @ m.T / (2 * n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ inverse ops


def test_inverse_ops_match_jax():
    r = np.random.RandomState(80)
    facs = {  # a stacked pair, a singleton, a diagonal-A embedding
        "a": {"A": _spd(r, 6), "G": _spd(r, 4)},
        "b": {"A": _spd(r, 6), "G": _spd(r, 4)},
        "c": {"A": _spd(r, 5), "G": _spd(r, 3)},
        "e": {"A_diag": np.abs(r.randn(7)).astype(np.float32), "G": _spd(r, 4)},
    }
    gmats = {"a": r.randn(4, 6), "b": r.randn(4, 6), "c": r.randn(3, 5), "e": r.randn(4, 7)}
    gmats = {n: g.astype(np.float32) for n, g in gmats.items()}
    damping = 0.003
    jinv = jpc.factored_inverse_all(
        {n: {k: jnp.asarray(v) for k, v in f.items()} for n, f in facs.items()},
        jnp.float32(damping),
    )
    tinv = tpc.factored_inverse_all(
        {n: {k: _t(v) for k, v in f.items()} for n, f in facs.items()}, damping
    )
    for n in facs:
        assert set(tinv[n]) == set(jinv[n])
        for k in jinv[n]:
            np.testing.assert_allclose(tinv[n][k].numpy(), np.asarray(jinv[n][k]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{n}.{k}")
    js, jst = jpc.split_inv_state(jinv)
    ts, tst = tpc.split_inv_state(tinv)
    assert list(tst) == list(jst) == ["4x6"] and set(ts) == set(js) == {"c", "e"}
    jout = jpc.precondition_all_inv({n: jnp.asarray(g) for n, g in gmats.items()}, js,
                                    stacked=jst)
    tout = tpc.precondition_all_inv({n: _t(g) for n, g in gmats.items()}, ts, stacked=tst)
    assert list(tout) == list(jout)  # the KL-clip summation order
    for n in gmats:
        np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ blocked eigh


@pytest.mark.parametrize("blocks", [1, 3, 4])
def test_blocked_eigh_matches_jax(blocks):
    """The refresh's blocked slots (one layer, one A side) against JAX's
    ``blocked_eigh``."""
    r = np.random.RandomState(81 + blocks)
    f = _spd(r, 10)
    jq, jd = (np.asarray(v) for v in jeigh.blocked_eigh(jnp.asarray(f), blocks))
    eig = replicated_eigen_update({"l": {"A": _t(f), "G": _t(f[:3, :3])}}, {"l": blocks})
    tq, td = eig["l"]["QA"].numpy(), eig["l"]["dA"].numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    bounds = [teigh.get_block_boundary(i, blocks, f.shape) for i in range(blocks)]
    mask = np.zeros_like(f, dtype=bool)
    for (r0, _), (r1, _) in bounds:
        mask[r0:r1, r0:r1] = True
        block = tq[r0:r1, r0:r1]
        # eigenvectors differ in sign between LAPACK builds; the block does not
        np.testing.assert_allclose(block @ np.diag(td[r0:r1]) @ block.T,
                                   f[r0:r1, r0:r1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.abs(block), np.abs(jq[r0:r1, r0:r1]), atol=1e-4)
    assert not tq[~mask].any()


# ------------------------------------------------------------ diagnostics


def test_inverse_method_keeps_no_spectra():
    """The inverse method's diagnostics: the spectrum entries stay at their
    initial zeros, staleness resets on refreshes, as in the JAX package."""
    a_c, g_s, _, tgrads = _problem(83)
    tk = KFAC(layers=list(LAYERS), precond_method="inverse", track_diagnostics=True,
              device="cpu")
    ts = tk.init(ConvDenseNet())
    assert set(ts["eigen"]["c0"]) == {"iA", "iG"} and list(ts["eigen_stacked"]) == ["4x36"]
    for upe, stale in [(True, 0), (False, 1), (True, 0)]:
        _, ts = tk.update(tgrads, ts, a_contribs={n: _t(v) for n, v in a_c.items()},
                          g_factor_stats={n: _t(v) for n, v in g_s.items()}, lr=0.1,
                          damping=0.003, update_factors=True, update_eigen=upe)
        d = ts["diagnostics"]
        assert int(d["eigen_stale_steps"]) == stale
        assert float(d["min_damped_eig"]) == 0.0 and float(d["layer_cond"]["c0"]["cond_A"]) == 0.0
        assert 0.0 < float(d["nu"]) <= 1.0


# ------------------------------------------------------------ train steps

OPTIONS = {
    "inverse": dict(kfac=dict(precond_method="inverse")),
    # one block in epoch 0 (step 0's refresh), two in epoch 1 (step 2's)
    "blocks": dict(kfac=dict(diag_blocks=2, diag_warmup=1)),
    # a refresh and a capture step
    "accum_last": dict(step=dict(accum_steps=2), steps=2),
    "accum_all": dict(step=dict(accum_steps=2, stats_all_microbatches=True), steps=2),
}


@pytest.mark.parametrize("option,init,scalars", [
    pytest.param("inverse", "eager", "float", id="inverse"),
    pytest.param("blocks", "eager", "float", id="blocks"),
    pytest.param("blocks", "jit", "float", id="blocks-jitted-init"),
    # the port's lr and damping as 0-d float32 tensors, as the graphed
    # step hands them over
    pytest.param("blocks", "eager", "tensor", id="blocks-tensor-scalars"),
])
def test_option_train_steps_match_jax(option, init, scalars):
    run_option_train_steps(option, init, scalars)


# The jitted-init case's refresh invariants at step 2, each relative to the
# largest entry of its JAX side (measured on the CPU: eigenvalues 7.3e-7,
# reconstructions 1.5e-6, preconditioned gradients 2.0e-6, ν 6.3e-8)
EIG_RTOL = RECON_RTOL = PRECOND_RTOL = NU_RTOL = 1e-5


def _block_spans(q):
    """The diagonal blocks ``[(start, stop)]`` of a basis that is zero off
    its two diagonal halves, else the whole basis."""
    n = q.shape[0]
    if n < 2:
        return [(0, n)]
    spans = [(lo[0], hi[0]) for lo, hi in (teigh.get_block_boundary(b, 2, (n, n))
                                           for b in range(2))]
    h = spans[0][1]
    return spans if not q[:h, h:].any() and not q[h:, :h].any() else [(0, n)]


def _check_basis(label, jq, jd, tq, td):
    """One side's decomposition in both packages: the same blocks (the
    port's basis zero outside them), each block's sorted eigenvalues and
    the reconstruction ``Q·diag(d)·Qᵀ`` (invariant to the basis' signs and
    rotations within equal eigenvalues), at ``EIG_RTOL``/``RECON_RTOL``."""
    jq, jd, tq, td = (np.asarray(a, np.float64) for a in (jq, jd, tq, td))
    spans = _block_spans(jq)
    mask = np.zeros(jq.shape, bool)
    for a, b in spans:
        mask[a:b, a:b] = True
        np.testing.assert_allclose(np.sort(td[a:b]), np.sort(jd[a:b]), rtol=0,
                                   atol=EIG_RTOL * np.abs(jd).max(), err_msg=f"{label} {a}:{b}")
    assert not tq[~mask].any(), label
    jr, tr = (jq * jd) @ jq.T, (tq * td) @ tq.T
    np.testing.assert_allclose(tr, jr, rtol=0, atol=RECON_RTOL * np.abs(jr).max(), err_msg=label)


def _check_refresh(jstate, tstate, before):
    """The step-2 refresh of the jitted-init case: every layer's blocked
    bases (:func:`_check_basis`), and the preconditioned gradient of every
    parameter, ``m₂ − μ·m₁ − wd·p₁`` from each package's own momentum and
    parameters, at ``PRECOND_RTOL`` of its largest entry."""
    je, te = jstate.kfac_state, tstate.kfac_state
    for jname, e in je["eigen"].items():
        for side in "AG":
            _check_basis(f"{jname} {side}", e["Q" + side], e["d" + side],
                         te["eigen"][_JAX_LAYER[jname]]["Q" + side],
                         te["eigen"][_JAX_LAYER[jname]]["d" + side])
    for group, e in je["eigen_stacked"].items():
        for row in range(e["QA"].shape[0]):
            for side in "AG":
                t = te["eigen_stacked"][group]
                _check_basis(f"{group}[{row}] {side}", e["Q" + side][row], e["d" + side][row],
                             t["Q" + side][row], t["d" + side][row])
    after = _sgd_view(jstate, tstate)
    for name in after[0]:
        (jm1, jp1), (tm1, tp1) = before[0][name], before[1][name]
        want = after[0][name][0] - MOMENTUM * jm1 - WD * jp1
        got = after[1][name][0] - MOMENTUM * tm1 - WD * tp1
        np.testing.assert_allclose(got, want, rtol=0, atol=PRECOND_RTOL * np.abs(want).max(),
                                   err_msg=name)


def _sgd_view(jstate, tstate):
    """``({param: (momentum, value)}, same)`` of the JAX and the port's state
    by port name, float64 copies."""
    ti = jstep._momentum_state_index(jstate.opt_state)
    jm = state_dict_from_jax(_np_tree(jstate.opt_state[ti].trace),
                             _np_tree(jstate.batch_stats), STEP_ARCH)
    jp = state_dict_from_jax(_np_tree(jstate.params), _np_tree(jstate.batch_stats), STEP_ARCH)
    params = dict(tstate.model.named_parameters())
    return ({n: (jm[n].double().numpy(), jp[n].double().numpy()) for n in params},
            {n: (tstate.opt_state[n].double().numpy(), p.detach().double().numpy())
             for n, p in params.items()})


def run_option_train_steps(option, init="eager", scalars="float"):
    """``STEP_ARCH`` steps of ``OPTIONS[option]`` (4, or the option's
    ``steps``) in both packages, compared after every step
    (``tests/test_torch_port_accum.py`` runs the accumulation options: the
    two files run on two test workers). On the weights of a jitted
    ``model.init`` (``init="jit"``) the steps end with the step-2 refresh,
    whose bases, preconditioned gradients and ν are held to the invariant
    bounds above: at step 3 one ReLU input of layer1.0's first BatchNorm
    lies at 1e-7, within the two float32 forward passes' spread (1.7e-6),
    and its sign differs, which moves the G factors below it by 4e-4.
    ``scalars="tensor"`` hands the port's step ``lr`` and ``damping`` as
    0-d float32 tensors."""
    kfac_kw = {**HP, **OPTIONS[option].get("kfac", {}), "track_diagnostics": True}
    step_kw = OPTIONS[option].get("step", {})
    accum = step_kw.get("accum_steps", 1)
    jitted = init == "jit"
    steps = 3 if jitted else OPTIONS[option].get("steps", STEPS)
    jmodel, init, params, stats, model = step_models(0, jit=jitted)
    jtx, tx = jmake_sgd(MOMENTUM, WD), make_sgd(MOMENTUM, WD)
    micro_init = init[: BATCH // accum]
    jk = JKFAC(layers=jcapture.discover_layers(jmodel, micro_init, train=True), **kfac_kw)
    tk = KFAC(layers=capture.discover_layers(model), device="cpu", **kfac_kw)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=jtx.init(params), kfac_state=jax.jit(jk.init)(params))
    tstate = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                        kfac_state=tk.init(model))
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True},
                             sgd_hyper=(MOMENTUM, WD), **step_kw)
    tstep = make_train_step(model, tx, tk, sgd_hyper=(MOMENTUM, WD), **step_kw)

    for i, (x, y) in enumerate(_batches(steps)):
        if jitted and i == 2:
            before = _sgd_view(jstate, tstate)
        epoch = min(i, 1)  # the warm-up ends after step 0
        jf, tf = jflags(i, jk, epoch), kfac_flags_for_step(i, tk, epoch)
        assert jf == tf
        xt = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        if accum > 1:
            x, y = x.reshape(accum, -1, *x.shape[1:]), y.reshape(accum, -1)
            xt = xt.reshape(accum, -1, *xt.shape[1:])
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(LR),
                           jnp.float32(HP["damping"]), **jf)
        lr, damping = LR, HP["damping"]
        if scalars == "tensor":
            lr, damping = (torch.tensor(v, dtype=torch.float32) for v in (lr, damping))
        tstate, tm = tstep(tstate, (torch.from_numpy(xt), torch.from_numpy(y)), lr, damping,
                           **tf)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), rtol=1e-6)
        kfac_keys = sorted(k for k in jm if k.startswith("kfac_"))
        assert sorted(k for k in tm if k.startswith("kfac_")) == kfac_keys
        for k in kfac_keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
        want = state_dict_from_jax(_np_tree(jstate.params), _np_tree(jstate.batch_stats),
                                   STEP_ARCH)
        got = model.state_dict()
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            w, g = w.numpy(), got[key].numpy()
            bound = 2e-5 * float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"step {i}: {key}")
    if jitted:
        np.testing.assert_allclose(float(tm["kfac_nu"]), float(jm["kfac_nu"]), rtol=NU_RTOL)
        _check_refresh(jstate, tstate, before)
    if option == "blocks":  # step 2's refresh split the conv factors in two
        eig = tstate.kfac_state["eigen"]["linear"]
        assert eig["QA"].shape == (65, 65)
        stacked = tstate.kfac_state["eigen_stacked"]["16x144"]["QA"]
        assert not stacked[:, :72, 72:].any() and stacked[:, :72, :72].any()
