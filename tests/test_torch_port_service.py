"""The curvature service (``kfac_pytorch_tpu_torch/service/``), case for case
the JAX package's ``tests/test_service.py``, on its small dense model
(``KFACDense`` 6 → 5 → 4, the same numpy statistics into both packages).

* The mailboxes: monotonic versions, ``wait_for``'s timeout, the round trip
  with its meta, pruning to ``keep``, a manifest-less (torn) version
  unseen, the ``::`` name rule; and a ``HostMailbox`` directory written by
  either package read by the other.
* The carve: trailing devices (ranks) become workers, with the JAX
  refusals.
* The constructor rows and ``update``'s refusal of every refresh flag.
* The worker's refresh against the JAX worker's on the same numpy factors
  (eigenvalues and reconstructions ``Q·diag(d)·Qᵀ``, the sign of an
  eigenvector being free), and bitwise against the port's inline refresh.
* Staleness 0 (fac 2, kfac 4, 8 steps): every preconditioned update
  matches the JAX ``CurvatureService`` (the port's parity tolerance,
  ``|port − jax| ≤ 1e-4·max|jax|``) and is bitwise the port's inline
  schedule whose refresh runs at boundary + 1, a step that captures
  nothing, so its refresh reads exactly the snapshot the worker saw: the
  same functions on the same inputs in the same order.
* Staleness 1 slips, then installs by the deadline; the cadence's service
  branch and its ``state_dict``; the worker's beats through the
  ``Supervisor``; a worker error re-raised once on the trainer's thread;
  a snapshot that the live state's in-place changes do not reach.
* Over gloo ranks (``tests/torch_dist_workers.py``, task ``service``):
  three ranks, the trailing one the worker serving a ``HostMailbox`` pair
  under ``tmp_path``; the two trainers' updates at staleness 0 are bitwise
  the one-process in-process layout's, the trainers call
  ``torch.linalg.eigh`` 0 times, the worker once per size group of each
  refresh, and the worker issues no collective; owner sharding is refused
  on the two-rank training world. The CIFAR twin's ``--service-devices 1``
  on two ranks at ResNet-20 (6 steps): finite losses, every install by
  its deadline, two runs bitwise equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu.parallel.mesh import split_service_mesh as jsplit_service_mesh
from kfac_pytorch_tpu.service import CurvatureService as JCurvatureService
from kfac_pytorch_tpu.service import CurvatureWorker as JCurvatureWorker
from kfac_pytorch_tpu.service import DeviceMailbox as JDeviceMailbox
from kfac_pytorch_tpu.service import HostMailbox as JHostMailbox
from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence, elastic
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import factors
from kfac_pytorch_tpu_torch.parallel.mesh import service_world, split_service_mesh
from kfac_pytorch_tpu_torch.service import (
    CurvatureService,
    CurvatureWorker,
    DeviceMailbox,
    HostMailbox,
    ServiceClient,
)
from tests import torch_dist_workers as workers

SIZES = [6, 5, 4]
FAC, KF, STEPS = 2, 4, 8
HP = dict(damping=0.003, fac_update_freq=FAC, kfac_update_freq=KF)
TWIN = ["--synthetic", "--model", "resnet20", "--batch-size", "8", "--epochs", "1",
        "--steps-per-epoch", "6", "--kfac-update-freq", "2", "--device", "cpu",
        "--num-workers", "0", "--service-devices", "1"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stats(seed, sizes=SIZES, batch=8):
    """One step's numpy statistics ``{layer: (A, G, kernel grad, bias grad)}``
    (``tests/test_preconditioner.py::_stats_for``'s draws)."""
    r = np.random.RandomState(seed)
    out = {}
    for i, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        acts = torch.from_numpy(r.randn(batch, nin).astype(np.float32))
        gout = torch.from_numpy(r.randn(batch, nout).astype(np.float32) / batch)
        out[f"l{i}"] = (factors.compute_a_dense(acts, True).numpy(),
                        factors.compute_g_dense(gout, True).numpy(),
                        r.randn(nin, nout).astype(np.float32), r.randn(nout).astype(np.float32))
    return out


def _jax_inputs(stats):
    a = {n: jnp.asarray(v[0]) for n, v in stats.items()}
    g = {n: jnp.asarray(v[1]) for n, v in stats.items()}
    grads = {n: {"kernel": jnp.asarray(v[2]), "bias": jnp.asarray(v[3])} for n, v in stats.items()}
    return a, g, grads


def _jax_params(sizes=SIZES):
    return {f"l{i}": {"kernel": jnp.zeros((a, b)), "bias": jnp.zeros(b)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


def _kfac(**kw):
    return KFAC(device="cpu", **{**HP, **kw})


def _update(kfac, state, stats, **flags):
    a, g, grads = workers._svc_inputs(stats)
    return kfac.update(grads, state, a_contribs=a, g_factor_stats=g, lr=0.1, damping=0.003,
                       **flags)


def _captured(kfac, seed=1):
    """One capture step, so the factor averages hold real statistics."""
    return _update(kfac, kfac.init(workers._svc_net(SIZES)), _stats(seed),
                   update_factors=True, update_eigen=False)[1]


def _payload(v=1.0):
    return {"l0": {"QA": np.full((3, 3), v, np.float32), "dA": np.arange(3, dtype=np.float32)}}


def _close_scaled(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# -- mailbox transports -------------------------------------------------


def _boxes(tmp_path):
    return [HostMailbox(str(tmp_path), "factors"), DeviceMailbox("factors")]


def test_mailbox_monotonic_version_refused(tmp_path):
    for box in _boxes(tmp_path):
        box.publish(3, _payload())
        with pytest.raises(ValueError, match="monotonic"):
            box.publish(3, _payload())
        with pytest.raises(ValueError, match="monotonic"):
            box.publish(2, _payload())
        assert box.latest_version() == 3


def test_mailbox_wait_for_timeout(tmp_path):
    for box in _boxes(tmp_path):
        box.publish(1, _payload())
        assert box.wait_for(1, timeout_s=1.0) == 1
        with pytest.raises(TimeoutError, match="worker alive"):
            box.wait_for(2, timeout_s=0.05)


def test_mailbox_roundtrip_and_meta(tmp_path):
    box = HostMailbox(str(tmp_path), "basis")
    sent = _payload(2.5)
    # a bfloat16 Q crosses widened (exactly) to float32
    sent["l1"] = {"QG": torch.tensor([[1.5, -0.25]], dtype=torch.bfloat16)}
    box.publish(1, sent, meta={"step": 40})
    got, meta = box.read(1)
    assert meta == {"step": 40}
    np.testing.assert_array_equal(got["l0"]["QA"], sent["l0"]["QA"])
    np.testing.assert_array_equal(got["l0"]["dA"], sent["l0"]["dA"])
    assert got["l1"]["QG"].dtype == np.float32
    np.testing.assert_array_equal(got["l1"]["QG"], [[1.5, -0.25]])


def test_host_mailbox_prunes_to_keep(tmp_path):
    box = HostMailbox(str(tmp_path), "factors", keep=2)
    for v in (1, 2, 3, 4):
        box.publish(v, _payload(float(v)))
    assert box.versions() == [3, 4]
    got, _ = box.read(4)
    assert got["l0"]["QA"][0, 0] == 4.0


def test_host_mailbox_ignores_manifestless_version(tmp_path):
    """Payload first, manifest last: a torn publish (no manifest yet) is
    invisible to latest()/versions()."""
    box = HostMailbox(str(tmp_path), "factors")
    box.publish(1, _payload())
    torn = os.path.join(box.root, "v-00000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "payload.npz"), "wb") as fh:
        fh.write(b"garbage")
    assert box.latest_version() == 1


def test_mailbox_refuses_separator_in_layer_name(tmp_path):
    for box in _boxes(tmp_path):
        with pytest.raises(ValueError, match="::"):
            box.publish(1, {"a::b": {"QA": np.zeros((2, 2), np.float32)}})


def test_host_mailbox_round_trips_across_packages(tmp_path):
    """One directory, both packages: the JAX box's version read by the
    port's box, then the port's next version read by the JAX box."""
    jbox, box = JHostMailbox(str(tmp_path), "basis"), HostMailbox(str(tmp_path), "basis")
    jbox.publish(1, _payload(1.5), meta={"step": 4})
    got, meta = box.read(box.latest_version())
    assert meta == {"step": 4}
    np.testing.assert_array_equal(got["l0"]["QA"], _payload(1.5)["l0"]["QA"])
    box.publish(2, {"l0": {k: torch.from_numpy(v) for k, v in _payload(3.0)["l0"].items()}},
                meta={"step": 8})
    v, jgot, jmeta = jbox.latest()
    assert v == 2 and jmeta == {"step": 8}
    np.testing.assert_array_equal(jgot["l0"]["QA"], _payload(3.0)["l0"]["QA"])
    np.testing.assert_array_equal(jgot["l0"]["dA"], _payload(3.0)["l0"]["dA"])


# -- the carve ----------------------------------------------------------


def test_split_service_mesh_carves_trailing_devices():
    devices = jax.devices()
    jmesh, jworkers = jsplit_service_mesh(2)
    train, work = split_service_mesh(2, range(len(devices)))
    assert list(train) == [d.id for d in jmesh.devices.ravel()] == list(range(len(devices) - 2))
    assert work == tuple(d.id for d in jworkers) == (len(devices) - 2, len(devices) - 1)
    # 0 keeps every one training, so call sites thread the lever through
    assert split_service_mesh(0, range(4)) == ((0, 1, 2, 3), ())
    with pytest.raises(ValueError, match="no training devices"):
        split_service_mesh(len(devices), range(len(devices)))
    with pytest.raises(ValueError, match=">= 0"):
        split_service_mesh(-1, range(len(devices)))
    # one process: the world as it is, and a carve that leaves no trainer
    world, none = service_world(0)
    assert world.size == 1 and none == ()
    with pytest.raises(ValueError, match="no training devices"):
        service_world(1)


# -- validity fence -----------------------------------------------------


@pytest.mark.parametrize(
    "kwargs, rule",
    [
        (dict(precond_method="inverse"), "service_vs_inverse"),
        (dict(solver="streaming"), "service_vs_streaming"),
        (dict(eigh_chunks=2), "service_vs_chunks"),
        (dict(diag_blocks=2), "service_vs_diag_blocks"),
    ],
)
def test_service_constructor_exclusions(kwargs, rule):
    with pytest.raises(ValueError, match=rule):
        KFAC(damping=0.01, service_devices=1, device="cpu", **kwargs)


def test_service_composes_with_staleness_budget():
    kfac = KFAC(damping=0.01, service_devices=1, staleness_budget=2, device="cpu")
    assert kfac.service_devices == 1 and kfac.staleness_budget == 2


@pytest.mark.parametrize("flags", [dict(update_eigen=True), dict(eigen_chunk=(0, 1)),
                                   dict(swap_eigen=True)])
def test_service_update_refuses_inline_refresh(flags):
    kfac = _kfac(service_devices=1)
    with pytest.raises(ValueError, match="ServiceClient.install"):
        _update(kfac, kfac.init(workers._svc_net(SIZES)), _stats(1),
                **{"update_factors": True, "update_eigen": False, **flags})


# -- worker refresh math ------------------------------------------------


def _reconstruct(e, side):
    q, d = np.asarray(e[f"Q{side}"], np.float64), np.asarray(e[f"d{side}"], np.float64)
    return (q * d) @ q.T


def test_worker_refresh_matches_jax_and_inline_eigen():
    """The worker's refresh of a factor snapshot is the JAX worker's on the
    same numpy factors, and bitwise the port's inline ``update_eigen``
    branch on the same factors."""
    kfac_s, kfac_i = _kfac(service_devices=1), _kfac()
    state_s, state_i = _captured(kfac_s), _captured(kfac_i)
    _, state_i = _update(kfac_i, state_i, _stats(1), update_factors=False, update_eigen=True)

    factors_box, basis_box = DeviceMailbox("f"), DeviceMailbox("b")
    worker = CurvatureWorker(kfac_s, factors_box, basis_box)
    factors_box.publish(1, state_s["factors"])
    assert worker.step() == 1
    version, payload, _meta = basis_box.latest()
    client = ServiceClient(kfac_s)
    state_s = client.install(state_s, payload, version, step=1)
    assert client.installed_version == 1
    for key in ("eigen", "eigen_stacked"):
        assert workers._np(state_s[key]).keys() == workers._np(state_i[key]).keys()
        for n, e in state_i[key].items():
            for k, v in e.items():
                assert torch.equal(state_s[key][n][k], v), (key, n, k)

    np_facs = {n: {k: v.numpy() for k, v in f.items()} for n, f in state_s["factors"].items()}
    jworker = JCurvatureWorker(JKFAC(damping=0.003, service_devices=1),
                               JDeviceMailbox("f"), JDeviceMailbox("b"))
    jpay = jworker.refresh(np_facs)
    for n, e in payload.items():
        for side in ("A", "G"):
            _close_scaled(e[f"d{side}"].numpy(), jpay[n][f"d{side}"], rtol=1e-5)
            _close_scaled(_reconstruct(e, side), _reconstruct(jpay[n], side), rtol=1e-5)


def test_worker_skips_stale_and_serves_to_stop_version():
    kfac = _kfac(service_devices=1)
    state = _captured(kfac)
    factors_box, basis_box = DeviceMailbox("f"), DeviceMailbox("b")
    worker = CurvatureWorker(kfac, factors_box, basis_box)
    assert worker.step() is None  # nothing published yet
    factors_box.publish(1, state["factors"])
    assert worker.serve(stop_version=1, idle_timeout_s=5.0) == 1
    assert worker.step() is None  # version 1 already served
    assert basis_box.latest_version() == 1
    # without a stop version the worker stops once the box is closed
    factors_box.publish(2, state["factors"])
    factors_box.close()
    assert worker.serve(idle_timeout_s=5.0) == 2


def test_publish_survives_in_place_changes_of_the_live_state():
    """The int8 flush merges into the live factors in place and an elastic
    restore copies into them: the published snapshot is a copy taken at
    publish time, so a worker that reads it later sees the boundary's
    factors; and a worker that died on its thread fails the trainer once,
    loudly."""
    kfac = _kfac(service_devices=1)
    state = _captured(kfac)
    want = {n: {k: v.clone() for k, v in f.items()} for n, f in state["factors"].items()}
    svc = CurvatureService(kfac, async_worker=True, staleness_budget=0)
    svc.after_step(0, state)  # publishes, then starts the worker thread
    svc._join_worker()
    got = svc.factors_box.latest()[1]
    for f in state["factors"].values():
        for v in f.values():
            v.mul_(3.0)
    for n, f in want.items():
        for k, v in f.items():
            assert torch.equal(got[n][k], v)
    assert svc.basis_box.latest_version() == 1

    svc._worker_error = RuntimeError("boom")
    with pytest.raises(RuntimeError, match="curvature worker failed"):
        svc._join_worker()
    assert svc._worker_error is None  # raised once, not sticky


# -- end-to-end staleness-0 parity (the acceptance criterion) -----------


def _jax_service_updates():
    """The JAX ``CurvatureService`` at staleness 0 over the same steps, its
    1-trainer + 1-worker carve: each step's preconditioned gradients."""
    train_mesh, workers_ = jsplit_service_mesh(1, devices=jax.devices()[:2])
    kfac = JKFAC(mesh=train_mesh, service_devices=1, **HP)
    state = kfac.init(_jax_params())
    cad = JCadence(kfac)
    svc = JCurvatureService(kfac, cad, worker_devices=workers_, async_worker=False,
                            staleness_budget=0)
    out = []
    for step in range(STEPS):
        a, g, grads = _jax_inputs(_stats(100 + step))
        state = svc.before_step(step, state)
        fl = cad.flags_for_step(step)
        new, state = kfac.update(grads, state, a_contribs=a, g_factor_stats=g,
                                 lr=jnp.float32(0.1), damping=jnp.float32(0.003),
                                 update_factors=fl["update_factors"], update_eigen=False)
        svc.after_step(step, state)
        out.append({n: (np.asarray(v["kernel"]).T, np.asarray(v["bias"])) for n, v in new.items()})
    return out


def test_service_staleness0_matches_jax_and_inline_refresh():
    """Publish after boundary step s, refresh out of band, install before
    s + 1: every update matches the JAX service and is bitwise the inline
    schedule whose refresh runs at s + 1 (a step that captures nothing)."""
    kfac_s, kfac_i = _kfac(service_devices=1), _kfac()
    cad = EigenRefreshCadence(kfac_s)
    svc = CurvatureService(kfac_s, cad, async_worker=True, staleness_budget=0)
    steps = [_stats(100 + s) for s in range(STEPS)]
    got = workers.service_run(kfac_s, SIZES, steps, svc)
    state_i = kfac_i.init(workers._svc_net(SIZES))
    jax_out = _jax_service_updates()
    for step, stats in enumerate(steps):
        new, state_i = _update(kfac_i, state_i, stats, update_factors=step % FAC == 0,
                               update_eigen=step % KF == 1)
        for key, v in new.items():
            np.testing.assert_array_equal(got[step][key], v.numpy(), err_msg=f"step {step} {key}")
        for n, (w, b) in jax_out[step].items():
            _close_scaled(got[step][f"{n}.weight"], w)
            _close_scaled(got[step][f"{n}.bias"], b)
    # installs advance once per refresh interval, each at boundary + 1
    assert svc.record["installs"] == [(1, 1, 0), (2, 5, 0)]
    assert svc.client.installed_version == 2


def test_service_staleness_budget_slips_then_installs():
    """With budget 1 the client need not block at step s + 1; the basis
    lands by the deadline s + 2 and the recorded slip stays within the
    budget."""
    kfac = _kfac(service_devices=1, fac_update_freq=1, kfac_update_freq=2)
    svc = CurvatureService(kfac, async_worker=False, staleness_budget=1)
    state = _captured(kfac, seed=5)
    tel = get_telemetry()
    was, tel.enabled = tel.enabled, True
    try:
        svc.after_step(0, state)
        state = svc.before_step(1, state)
        v_after_1 = svc.client.installed_version
        state = svc.before_step(2, state)
        slip = tel.gauges.get("kfac/basis_staleness_steps")
    finally:
        tel.enabled = was
    assert svc.client.installed_version == 1
    assert v_after_1 in (-1, 1)  # install at s + 1 allowed, never required
    assert slip is not None and slip <= 1.0


# -- cadence integration ------------------------------------------------


def test_cadence_service_branch_never_fires_refresh_flags():
    kfac = KFAC(damping=0.01, fac_update_freq=2, kfac_update_freq=4, service_devices=1,
                device="cpu")
    cad = EigenRefreshCadence(kfac)
    for step in range(10):
        fl = cad.flags_for_step(step)
        assert fl["update_eigen"] is False
        assert fl.get("eigen_chunk") is None
        assert not fl.get("swap_eigen", False)
        assert fl["update_factors"] == (step % 2 == 0)


def test_cadence_state_dict_carries_service_bookkeeping():
    kfac = KFAC(damping=0.01, service_devices=1, device="cpu")
    cad = EigenRefreshCadence(kfac)
    cad.note_basis_installed(version=3, step=5, slip=1)
    d = cad.state_dict()
    assert json.loads(json.dumps(d)) == d  # snapshot-manifest serializable
    assert d == JCadence(JKFAC(damping=0.01, service_devices=1)).state_dict() | {
        "basis_version": 3, "basis_installed_step": 5, "basis_slip": 1,
        "last_refresh_step": 5, "bootstrapped": True}
    cad2 = EigenRefreshCadence(kfac)
    cad2.load_state_dict(d)
    assert cad2._basis_version == 3
    assert cad2._basis_installed_step == 5
    assert cad2._basis_slip == 1
    assert cad2._bootstrapped is True
    assert cad2._last_refresh_step == 5


# -- worker liveness ----------------------------------------------------


def test_supervisor_worker_beat(tmp_path):
    sup = elastic.Supervisor(str(tmp_path), liveness_window_s=60.0)
    sup.worker_beat(version=2, min_interval_s=0.0)
    path = os.path.join(str(tmp_path), "heartbeats", "worker-0.json")
    with open(path) as fh:
        beat = json.load(fh)
    assert beat["role"] == "curvature-worker"
    assert beat["version"] == 2
    assert sup.liveness() == 1
    # rate limiting: a second beat inside the interval is dropped
    sup.worker_beat(version=3, min_interval_s=60.0)
    with open(path) as fh:
        again = json.load(fh)
    assert again["version"] == 2 and again["t"] == beat["t"]


def test_worker_beats_through_supervisor_on_refresh(tmp_path):
    kfac = _kfac(service_devices=1)
    state = _captured(kfac)
    sup = elastic.Supervisor(str(tmp_path), liveness_window_s=60.0)
    factors_box, basis_box = DeviceMailbox("f"), DeviceMailbox("b")
    worker = CurvatureWorker(kfac, factors_box, basis_box, supervisor=sup)
    factors_box.publish(1, state["factors"])
    assert worker.step() == 1
    with open(os.path.join(str(tmp_path), "heartbeats", "worker-0.json")) as fh:
        beat = json.load(fh)
    assert beat["version"] == 1 and beat["role"] == "curvature-worker"


# -- gloo ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Three ranks (two trainers, one worker) on the dense model, and the
    CIFAR twin on two ranks; the test process meanwhile runs the
    one-process in-process layout."""
    root = tmp_path_factory.mktemp("service")
    steps = [_stats(100 + s) for s in range(STEPS)]
    started = {
        "lib": workers.start("service", 3, str(root / "lib"), sizes=SIZES, steps=steps, hp=HP,
                             box=str(root / "lib" / "box")),
        "twin": workers.start("service", 2, str(root / "twin"), sizes=SIZES, steps=steps,
                              hp=HP, box="", twin=TWIN),
    }
    kfac = _kfac(service_devices=1)
    one = workers.service_run(kfac, SIZES, steps, CurvatureService(
        kfac, EigenRefreshCadence(kfac), async_worker=True, staleness_budget=0))
    return {"one": one, **{k: workers.join(h) for k, h in started.items()}}


def test_ranks_staleness0_are_the_in_process_layout(ranks):
    trainers, worker = ranks["lib"][:2], ranks["lib"][2]
    assert worker["workers"] == (2,) and worker["world"] == (1, 0)
    for r, res in enumerate(trainers):
        assert res["world"] == (2, r)
        assert res["installs"] == [(1, 1, 0), (2, 5, 0)]
        for step, want in enumerate(ranks["one"]):
            for key, v in want.items():
                np.testing.assert_array_equal(res["updates"][step][key], v,
                                              err_msg=f"rank {r} step {step} {key}")


def test_ranks_trainers_make_no_eigh_and_the_worker_no_collective(ranks):
    trainers, worker = ranks["lib"][:2], ranks["lib"][2]
    # the training step holds no refresh: zero eighs on the trainers
    assert [t["eigh"] for t in trainers] == [0, 0]
    # the worker: one refresh per published version, one eigh per factor
    # size of the model (A: 7, 6; G: 5, 4)
    assert worker["served"] == 2 and worker["eigh"] == 2 * 4
    assert sum(worker["collectives"].values()) == 0
    assert all(sum(t["collectives"].values()) > 0 for t in trainers)
    for t in trainers:
        assert "service_vs_owner_sharding" in t["owner"]


def test_cifar_twin_service_on_two_ranks(ranks):
    trainer, worker = ranks["twin"]
    assert worker["twin"][0]["loss"] == [] and len(worker["twin"][0]["refresh_ms"]) == 3
    runs = trainer["twin"]
    for run in runs:
        assert len(run["loss"]) == 6 and np.all(np.isfinite(run["loss"]))
        assert run["eigh"] == 0
        installs = run["service"]["installs"]
        # boundaries 0, 2, 4: each basis installed no later than s + 1 + 0
        assert [(v, s) for v, s, _ in installs] == [(1, 1), (2, 3), (3, 5)]
    assert runs[0]["loss"] == runs[1]["loss"]
