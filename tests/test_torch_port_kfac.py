"""The port's K-FAC core against the JAX package, plus its device rules.

* ``KFAC.update`` on a conv+dense net (a stacked same-shape conv pair, a
  singleton conv with bias, a dense head) with identical factor statistics
  and gradients: preconditioned gradients and ν after a refresh and after a
  stale-basis capture step, through the port's kernel route (plain
  versions on the CPU) and its dense route;
* twins of the JAX package's ``test_kfac_update_matches_numpy_oracle``,
  ``test_infinite_damping_recovers_sgd_direction`` and
  ``test_scheduler_parity``;
* the capture hooks against the factor functions they call;
* device rules: no GPU and no ``device=`` raises; ``"kernel"`` on the CPU
  raises; levers of later slices raise ``NotImplementedError``.

Tolerances: eigenvectors differ between LAPACK builds (sign, near-degenerate
subspaces), but ``(G⊗A + λI)⁻¹g`` does not; with λ = 0.003 rounding is
amplified by up to 1/λ, so preconditioned gradients are held to
``|got − want| ≤ 1e-4·max|want|`` and ν to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu_torch import KFAC, KFACParamScheduler, capture
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
from kfac_pytorch_tpu_torch.ops import factor_kernels, factors

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_scaled(got, want, rtol):
    want = np.asarray(want)
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


class ConvDenseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c0 = KFACConv(3, 4, 3, padding=1, bias=False)  # [4, 27]
        self.c1 = KFACConv(4, 4, 3, padding=1, bias=False)  # [4, 36] } stacked
        self.c2 = KFACConv(4, 4, 3, padding=1, bias=False)  # [4, 36] }
        self.c3 = KFACConv(4, 5, 1, bias=True)  # [5, 5]
        self.fc = KFACDense(5, 3)  # [3, 6]


# port layer -> (JAX path, JAX kernel shape (HWIO / [in, out]), has bias)
LAYERS = {
    "c0": ("KFACConv_0", (3, 3, 3, 4), False),
    "c1": ("KFACConv_1", (3, 3, 4, 4), False),
    "c2": ("KFACConv_2", (3, 3, 4, 4), False),
    "c3": ("KFACConv_3", (1, 1, 4, 5), True),
    "fc": ("KFACDense_0", (5, 3), True),
}


def _spd(r, n):
    m = r.randn(n, 2 * n).astype(np.float32)
    return (m @ m.T / (2 * n)).astype(np.float32)


def _problem(seed):
    """Numpy stats and grads for both packages (factor sides from LAYERS)."""
    r = np.random.RandomState(seed)
    a_c, g_s, jgrads, tgrads = {}, {}, {}, {}
    for n, (jn, kshape, bias) in LAYERS.items():
        a_side = int(np.prod(kshape[:-1])) + int(bias)
        g_side = kshape[-1]
        a_c[n], g_s[n] = _spd(r, a_side), _spd(r, g_side)
        k = r.randn(*kshape).astype(np.float32)
        jgrads[jn] = {"kernel": jnp.asarray(k)}
        w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        tgrads[f"{n}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if bias:
            b = r.randn(g_side).astype(np.float32)
            jgrads[jn]["bias"] = jnp.asarray(b)
            tgrads[f"{n}.bias"] = torch.from_numpy(b)
    return a_c, g_s, jgrads, tgrads


def _jparams():
    return {jn: {"kernel": jnp.zeros(ks), **({"bias": jnp.zeros(ks[-1])} if b else {})}
            for jn, ks, b in LAYERS.values()}


def _port_grad(tgrads, n):
    """Port grads of layer n as the JAX layout (HWIO / [in, out]) + bias."""
    w = tgrads[f"{n}.weight"].numpy()
    return (w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T), tgrads.get(f"{n}.bias")


@pytest.mark.parametrize("apply_kernel", ["auto", "dense"])
def test_kfac_update_matches_jax(apply_kernel):
    lr, damping = 0.1, 0.003
    a_c, g_s, jgrads, tgrads = _problem(70)
    jk = JKFAC(lr=lr, damping=damping, layers=[v[0] for v in LAYERS.values()])
    tk = KFAC(lr=lr, damping=damping, layers=list(LAYERS), apply_kernel=apply_kernel, device="cpu")
    js, ts = jk.init(_jparams()), tk.init(ConvDenseNet())
    assert list(ts["eigen_stacked"]) == list(js["eigen_stacked"]) == ["4x36"]
    for step, (upf, upe) in enumerate([(True, True), (True, False)]):
        ja = {LAYERS[n][0]: jnp.asarray(v) for n, v in a_c.items()}
        jg = {LAYERS[n][0]: jnp.asarray(v) for n, v in g_s.items()}
        jnew, js = jk.update(
            jgrads, js, a_contribs=ja, g_factor_stats=jg, lr=jnp.float32(lr),
            damping=jnp.float32(damping), update_factors=upf, update_eigen=upe,
        )
        tnew, ts = tk.update(
            tgrads, ts, a_contribs={n: torch.from_numpy(v) for n, v in a_c.items()},
            g_factor_stats={n: torch.from_numpy(v) for n, v in g_s.items()},
            lr=lr, damping=damping, update_factors=upf, update_eigen=upe,
        )
        assert ts["step"] == step + 1
        for n, (jn, _, bias) in LAYERS.items():
            np.testing.assert_allclose(ts["factors"][n]["A"].numpy(), np.asarray(js["factors"][jn]["A"]), rtol=1e-6, atol=1e-7)
            w, b = _port_grad(tnew, n)
            _close_scaled(w, jnew[jn]["kernel"], rtol=1e-4)
            if bias:
                _close_scaled(b, jnew[jn]["bias"], rtol=1e-4)
        # ν itself, from the same eigen state
        _, _, _, jnu = jk._precondition_replicated(
            jgrads, list(js["factors"]), js["factors"], js["eigen"],
            js["eigen_stacked"], jnp.float32(lr), jnp.float32(damping),
        )
        _, _, _, tnu = tk._precondition_replicated(
            tgrads, list(ts["factors"]), ts["eigen"], ts["eigen_stacked"], lr, damping
        )
        assert float(jnu) < 1.0  # the KL clip is active in this problem
        np.testing.assert_allclose(float(tnu), float(jnu), rtol=1e-5)


# ------------------------------------------------- twins of the JAX tests


def _dense_net(sizes, bias=True):
    net = nn.Module()
    for i, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        net.add_module(f"l{i}", KFACDense(nin, nout, bias=bias))
    return net


def _dense_stats(net, r, batch=8):
    a_c, g_s, grads = {}, {}, {}
    for name, m in net.named_children():
        acts = torch.from_numpy(r.randn(batch, m.in_features).astype(np.float32))
        gout = torch.from_numpy(r.randn(batch, m.out_features).astype(np.float32) / batch)
        a_c[name] = factors.compute_a_dense(acts, m.bias is not None)
        g_s[name] = factors.compute_g_dense(gout, True)
        grads[f"{name}.weight"] = torch.from_numpy(r.randn(m.out_features, m.in_features).astype(np.float32))
        if m.bias is not None:
            grads[f"{name}.bias"] = torch.from_numpy(r.randn(m.out_features).astype(np.float32))
    return a_c, g_s, grads


def test_kfac_update_matches_numpy_oracle():
    r = np.random.RandomState(0)
    net = _dense_net([6, 5, 4])
    a_c, g_s, grads = _dense_stats(net, r)
    lr, damping, kl_clip, decay = 0.1, 0.01, 0.001, 0.95
    kfac = KFAC(lr=lr, damping=damping, device="cpu")
    new, state = kfac.update(
        grads, kfac.init(net), a_contribs=a_c, g_factor_stats=g_s, lr=lr,
        damping=damping, update_factors=True, update_eigen=True,
    )
    out, vg_sum = {}, 0.0
    for n in ("l0", "l1"):
        A = decay * np.eye(a_c[n].shape[0]) + (1 - decay) * a_c[n].double().numpy()
        G = decay * np.eye(g_s[n].shape[0]) + (1 - decay) * g_s[n].double().numpy()
        dA, QA = np.linalg.eigh(A)
        dG, QG = np.linalg.eigh(G)
        g = np.concatenate([grads[f"{n}.weight"].double().numpy(), grads[f"{n}.bias"].double().numpy()[:, None]], 1)
        v = QG @ ((QG.T @ g @ QA) / (dG[:, None] * dA[None, :] + damping)) @ QA.T
        out[n] = v
        vg_sum += (v * g).sum() * lr**2
    nu = min(1.0, np.sqrt(kl_clip / abs(vg_sum)))
    for n in out:
        got = np.concatenate([new[f"{n}.weight"].numpy(), new[f"{n}.bias"].numpy()[:, None]], 1)
        np.testing.assert_allclose(got, out[n] * nu, rtol=1e-3, atol=1e-4)
    assert state["step"] == 1


def test_infinite_damping_recovers_sgd_direction():
    r = np.random.RandomState(11)
    net = _dense_net([6, 5, 4])
    a_c, g_s, grads = _dense_stats(net, r)
    kfac = KFAC(device="cpu")
    new, _ = kfac.update(
        grads, kfac.init(net), a_contribs=a_c, g_factor_stats=g_s, lr=0.1,
        damping=1e8, update_factors=True, update_eigen=True,
    )
    raw = torch.cat([g.reshape(-1) for g in grads.values()]).double()
    got = torch.cat([new[k].reshape(-1) for k in grads]).double()
    cos = float(raw @ got / (raw.norm() * got.norm()))
    assert cos > 0.9999, f"direction diverges from SGD at infinite damping: cos={cos}"


def test_scheduler_parity():
    kfac = KFAC(damping=0.002, fac_update_freq=10, kfac_update_freq=100, device="cpu")
    sched = KFACParamScheduler(
        kfac, damping_alpha=0.5, damping_schedule=[40, 80],
        update_freq_alpha=2, update_freq_schedule=[30],
    )
    sched.step(epoch=39)
    assert kfac.hparams.damping == 0.002
    assert kfac.hparams.fac_update_freq == 20 and kfac.hparams.kfac_update_freq == 200
    sched.step(epoch=40)
    assert np.isclose(kfac.hparams.damping, 0.001)
    sched.step(epoch=85)
    assert np.isclose(kfac.hparams.damping, 0.0005)
    sched2 = KFACParamScheduler(KFAC(device="cpu"), start_epoch=0)
    sched2.step()
    assert sched2.epoch == 1


# ---------------------------------------------------------------- capture


@pytest.mark.parametrize("kind", ["auto", "dense"])
def test_capture_hooks_collect_a_and_g(kind):
    torch.manual_seed(0)
    net = ConvDenseNet()
    cap = capture.Capture(net, ["c1", "c3", "fc"])
    x = torch.from_numpy(np.random.RandomState(80).randn(2, 4, 5, 5).astype(np.float32))
    x.requires_grad_(True)
    outs = {}
    with cap.capturing(kind):
        y1 = net.c1(x)
        y1.retain_grad()
        y3 = net.c3(torch.relu(y1))
        y3.retain_grad()
        h = y3.mean(dim=(2, 3))
        out = net.fc(h)
        out.retain_grad()
        (out.square().sum() / 2).backward()
        outs = {"c1": (x, y1), "c3": (torch.relu(y1), y3), "fc": (h, out)}
    assert set(cap.a_contribs) == set(cap.g_factor_stats) == {"c1", "c3", "fc"}
    want_a = factors.compute_a_conv(x.detach(), (3, 3), (1, 1), ((1, 1), (1, 1)), False)
    _close_scaled(cap.a_contribs["c1"], want_a, rtol=1e-6)
    _close_scaled(cap.a_contribs["c3"], factors.compute_a_conv(outs["c3"][0].detach(), (1, 1), (1, 1), ((0, 0), (0, 0)), True), rtol=1e-6)
    _close_scaled(cap.a_contribs["fc"], factors.compute_a_dense(h.detach(), True), rtol=1e-6)
    _close_scaled(cap.g_factor_stats["c1"], factors.compute_g_conv(y1.grad, True), rtol=1e-6)
    _close_scaled(cap.g_factor_stats["fc"], factors.compute_g_dense(out.grad, True), rtol=1e-6)
    # outside a capture step the hooks are inert
    n_before = len(cap.a_contribs)
    net.fc(h.detach())
    assert len(cap.a_contribs) == n_before
    cap.remove()


# ----------------------------------------------------------- device rules


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        KFAC()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(["--synthetic", "--epochs", "1", "--steps-per-epoch", "1"])
    assert KFAC(device="cpu").device == CPU


def test_kernel_kind_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        KFAC(factor_kernel="kernel", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        KFAC(apply_kernel="kernel", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        factor_kernels.dispatch_compute_a_conv(
            torch.zeros(1, 1, 3, 3), (3, 3), (1, 1), "SAME", False, kind="kernel"
        )


@pytest.mark.parametrize(
    "kwargs,item",
    [
        ({"mesh": object()}, "6"),
        ({"distribute_precondition": True}, "6"),
        ({"factor_comm_dtype": "bf16"}, "6"),
        ({"eigh_chunks": 2}, "7"),
        ({"solver": "rsvd"}, "7"),
        ({"factor_sharding": "owner"}, "7"),
        ({"comm_overlap": True}, "7"),
        ({"precond_method": "inverse"}, "4"),
        ({"diag_blocks": 2}, "4"),
        ({"track_diagnostics": True}, "4"),
        ({"service_devices": 1}, "9"),
        ({"profile": "production"}, "9"),
    ],
)
def test_levers_of_later_slices_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
        KFAC(device="cpu", **kwargs)


@pytest.mark.parametrize(
    "kwargs", [{"damping": 0.0}, {"kl_clip": 0.0}, {"factor_decay": 1.5}, {"lr": -1.0},
               {"fac_update_freq": 0}, {"apply_kernel": "pallas"}]
)
def test_reference_validation(kwargs):
    with pytest.raises(ValueError):
        KFAC(device="cpu", **kwargs)
