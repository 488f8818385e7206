"""The port's elastic runtime on one process (``kfac_pytorch_tpu_torch/
elastic``), held to the JAX package's ``kfac_pytorch_tpu/elastic`` on the
CPU. Inputs come from numpy seeds; the gloo-rank cases are
``tests/test_torch_port_elastic_ranks.py``.

* **The manifest contract**: the port's ``KFAC_STATE_KEYS`` (and its
  replica-local keys) equal the JAX table; every key the port's ``KFAC``
  state carries under each lever (chunks, rsvd, streaming, slip,
  diagnostics; the owner, deferred and int8 levers, which a world of one
  leaves inert, in the ranks file) and every literal state key
  the package touches is in it, and the table has no dead row (the
  counterpart of ``scripts/check_state_manifest.py``); an unknown key is
  refused.
* **Manifest parity**: the same layers, statistics and gradients through
  both packages' ``KFAC.update`` (``eigh_chunks=3``, ``profile="safe"``,
  JAX on one device) for six steps give manifests with equal
  ``kfac_state_keys``, ``sharding``, ``plan``, ``cadence`` and ``step``.
* **Snapshot I/O**: a ``TrainState`` round-trips bitwise; scan-resume skips
  truncated, corrupt and incomplete snapshots; GC keeps the newest
  ``keep``; a SIGTERM through the supervisor takes the emergency snapshot;
  a service worker's wall-clock beat counts toward liveness;
  the injector's raise, signal and exit (a subprocess) modes; ``drop_hosts``;
  a step run while a background write is in flight does not reach the
  payload; a background write's error is raised by the next ``wait``; a
  packed replica-local row count other than the ranks' is refused.
* **Mid-interval resume** (the JAX ``test_mid_interval_resume_bitwise``
  schedule, one process): bitwise at step 12, and the resumed updates'
  preconditioned gradients within 1e-4 of the largest entry of the JAX
  package's uninterrupted run's (the damping of 0.003 amplifies float32
  rounding, ``tests/test_torch_port_owner.py``'s bound).
* **Mid-stream resume** (the JAX ``test_mid_stream_resume_bitwise``): bitwise,
  and no re-orthonormalization at the first resumed boundary.
* **Resize replan**: the host remap of the same global-form stacks for
  worlds 8 → 4 equals the JAX ``resize_owner_state`` on the 8-device mesh
  bit for bit, the fingerprints equal JAX's, two remaps are bitwise equal,
  and a wrong fingerprint is refused.
* **The twins**: the WikiText twin at dropout 0.3 and the CIFAR twin at
  ResNet-20 (the smallest CIFAR model either package defines), killed in
  exit mode at step 3, resume from ``snap-2`` and train the uninterrupted
  run's losses bit for bit; the later-flag tables are gone (item 9d,
  the last, is ported).
"""

import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu.elastic import replan as jreplan
from kfac_pytorch_tpu.elastic import state_io as jstate_io
from kfac_pytorch_tpu.parallel import assignment as jassign
from kfac_pytorch_tpu.scheduler import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
from kfac_pytorch_tpu_torch.elastic import (
    FaultInjector,
    FaultSpec,
    SimulatedPreemption,
    SnapshotError,
    Supervisor,
    faults,
    replan,
    state_io,
)
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.parallel import assignment
from kfac_pytorch_tpu_torch.training.step import TrainState
from tests.test_torch_port_owner import _gapped_spd, _jgrads, _jparams
from tests.torch_dist_workers import (
    _elastic_build,
    _elastic_flat,
    _elastic_steps,
    _np,
    _owner_net,
    _t,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """Supervisor tests install a SIGTERM handler; never leak it."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


@pytest.fixture(autouse=True)
def _telemetry_on():
    """Gauge assertions need the registry enabled; leave it as found."""
    tel = get_telemetry()
    was = tel.enabled
    tel.enabled = True
    yield
    tel.enabled = was
    tel.reset()


# {name: (kind, port args)} and the [g, a] sides: a stacked same-shape
# pair, two singletons (tests/test_torch_port_owner.py's dense net)
NET = {"l0": ("dense", (23, 12)), "l1": ("dense", (23, 12)),
       "l2": ("dense", (12, 16)), "l3": ("dense", (8, 4))}
SHAPES = {"l0": (12, 24), "l1": (12, 24), "l2": (16, 13), "l3": (4, 9)}
DAMPING = 0.003
FLAG_KEYS = ("update_factors", "update_eigen", "eigen_chunk", "swap_eigen", "flush_factors")


def _update_inputs(steps, seed):
    """Per step: the statistics and the gradients, in the port's layout."""
    r = np.random.RandomState(seed)
    stats, grads = [], []
    for _ in range(steps):
        stats.append(({n: _gapped_spd(r, a) for n, (_, a) in SHAPES.items()},
                      {n: _gapped_spd(r, g) for n, (g, _) in SHAPES.items()}))
        step = {}
        for name, (_, (fan_in, fan_out)) in NET.items():
            step[f"{name}.weight"] = r.randn(fan_out, fan_in).astype(np.float32)
            step[f"{name}.bias"] = r.randn(fan_out).astype(np.float32)
        grads.append(step)
    return stats, grads


def _port_updates(kfac, cad, state, inputs, lo, hi):
    """``KFAC.update`` over steps ``lo..hi`` of ``inputs``: the state and
    each step's new gradients."""
    stats, grads = inputs
    news = []
    for step in range(lo, hi):
        fl = {k: v for k, v in cad.flags_for_step(step).items() if k in FLAG_KEYS}
        new, state = kfac.update(_t(grads[step]), state, a_contribs=_t(stats[step][0]),
                                 g_factor_stats=_t(stats[step][1]), lr=0.1, damping=DAMPING, **fl)
        news.append(_np(new))
    return state, news


def _jax_updates(kfac, inputs, steps):
    """The JAX package's uninterrupted run: each step's new gradients."""
    stats, grads = inputs
    cad = JCadence(kfac)
    state = kfac.init(jax.tree_util.tree_map(jnp.asarray, _jparams("dense")))
    fns, news = {}, []
    for step in range(steps):
        fl = {k: v for k, v in cad.flags_for_step(step).items() if k in FLAG_KEYS}
        key = tuple(sorted(fl.items()))
        if key not in fns:
            fns[key] = jax.jit(lambda g, s, a, gs, _fl=fl: kfac.update(
                g, s, a_contribs=a, g_factor_stats=gs, lr=jnp.float32(0.1),
                damping=jnp.float32(DAMPING), **_fl))
        a_c = {n: jnp.asarray(v) for n, v in stats[step][0].items()}
        g_s = {n: jnp.asarray(v) for n, v in stats[step][1].items()}
        new, state = fns[key](_jgrads("dense", grads[step]), state, a_c, g_s)
        news.append(jax.tree_util.tree_map(np.asarray, jax.device_get(new)))
    return state, cad, news


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()) + 1e-30)


def _mlp_weights():
    r = np.random.RandomState(11)
    return {"fc1.weight": (r.randn(32, 24) / 5).astype(np.float32),
            "fc1.bias": np.zeros(32, np.float32),
            "fc2.weight": (r.randn(10, 32) / 6).astype(np.float32),
            "fc2.bias": np.zeros(10, np.float32)}


def _mlp_batch():
    r = np.random.RandomState(12)
    return (torch.from_numpy(r.randn(8, 4, 6).astype(np.float32)),
            torch.from_numpy(r.randint(0, 10, size=8).astype(np.int64)))


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def _tiny_state(step=0):
    """A minimal manifest-conformant state for pure-I/O tests."""
    model = torch.nn.Linear(3, 2)
    return TrainState(step=step, model=model, opt_state={},
                      kfac_state={"step": step, "factors": {"fc": {"A": torch.eye(3),
                                                                   "G": torch.eye(2)}},
                                  "eigen": {}})


# ---------------------------------------------------------- the manifest


def test_state_key_table_equals_jax():
    assert state_io.KFAC_STATE_KEYS == jstate_io.KFAC_STATE_KEYS
    assert state_io._REPLICA_LOCAL_KEYS == jstate_io._REPLICA_LOCAL_KEYS
    assert state_io.MANIFEST_NAME == jstate_io.MANIFEST_NAME
    assert state_io.MANIFEST_VERSION == jstate_io.MANIFEST_VERSION


def test_every_state_key_the_port_touches_is_in_the_manifest():
    """The counterpart of ``scripts/check_state_manifest.py`` over the
    port: every literal ``state[...]``/``new_state[...]``/``kfac_state[...]``
    key is in the table, and every row is touched."""
    import ast
    import pathlib

    touched = set()
    for f in pathlib.Path(REPO, "kfac_pytorch_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                    and node.value.id in {"state", "new_state", "kfac_state"}
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                touched.add(node.slice.value)
    assert touched == set(state_io.KFAC_STATE_KEYS)


LEVERS = {
    "chunks": ({"eigh_chunks": 3}, "eigen_pending"),
    "rsvd": ({"solver": "rsvd", "solver_rank": 4, "solver_auto_threshold": 20},
             "spectrum_mass"),
    "streaming": ({"solver": "streaming", "solver_rank": 4, "solver_auto_threshold": 20},
                  "stream_fold_steps"),
    "slip": ({"eigh_chunks": 2, "staleness_budget": 2}, "eigen_swap_slip"),
    "diagnostics": ({"track_diagnostics": True}, "diagnostics"),
}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_every_lever_state_is_in_the_manifest(lever, tmp_path):
    kw, key = LEVERS[lever]
    kfac = KFAC(layers=list(NET), device="cpu", fac_update_freq=1, kfac_update_freq=2, **kw)
    state, _ = _port_updates(kfac, EigenRefreshCadence(kfac), kfac.init(_owner_net(NET)),
                             _update_inputs(3, 5), 0, 3)
    assert key in state
    manifest = state_io.build_manifest(state, kfac=kfac)
    assert manifest["kfac_state_keys"] == sorted(state)
    assert set(manifest["kfac_state_keys"]) <= set(state_io.KFAC_STATE_KEYS)


def test_manifest_refuses_unknown_state_key():
    bad = _tiny_state()
    bad.kfac_state["mystery_lever"] = torch.zeros(())
    with pytest.raises(SnapshotError, match="mystery_lever"):
        state_io.build_manifest(bad)


def test_manifest_fields_equal_jax():
    """Six steps of the same layers, statistics and gradients through both
    packages (``eigh_chunks=3``, ``profile="safe"``; JAX on one device):
    the manifest fields a restore and a replan read are equal."""
    kw = dict(fac_update_freq=1, kfac_update_freq=4, eigh_chunks=3, damping=DAMPING,
              profile="safe", profile_shapes=SHAPES)
    inputs = _update_inputs(6, 21)
    jk = JKFAC(layers=list(NET), **kw)
    jstate, jcad, _ = _jax_updates(jk, inputs, 6)
    want = jstate_io.build_manifest(jstate, kfac=jk, cadence=jcad)
    kfac = KFAC(layers=list(NET), device="cpu", **kw)
    cad = EigenRefreshCadence(kfac)
    state, _ = _port_updates(kfac, cad, kfac.init(_owner_net(NET)), inputs, 0, 6)
    got = state_io.build_manifest(state, kfac=kfac, cadence=cad)
    for field in ("format", "version", "kfac_state_keys", "sharding", "plan", "cadence", "step",
                  "shard_plan_fingerprint", "extra"):
        assert got[field] == want[field], field
    assert got["plan"] is not None and got["cadence"]["landed"] == [0, 1]


# ------------------------------------------------------------ snapshot I/O


def test_snapshot_round_trip_and_manifest(tmp_path):
    kfac, state, fn, cad = _elastic_build(1, _mlp_weights(), dict(kfac_update_freq=2))
    state = _elastic_steps(fn, cad, state, _mlp_batch(), 0, 3)
    snap = Supervisor(str(tmp_path), kfac=kfac, cadence=cad).snapshot(3, state, sync=True)
    manifest = state_io.load_manifest(snap)
    assert sorted(os.listdir(snap)) == [state_io.MANIFEST_NAME, state_io.PAYLOAD_NAME]
    assert {k: manifest[k] for k in ("format", "version", "step", "sharding", "world",
                                     "packed_replica_local", "complete")} == {
        "format": "kfac-elastic-snapshot", "version": 1, "step": 3, "sharding": "replicated",
        "world": 1, "packed_replica_local": False, "complete": True}
    assert manifest["cadence"] == cad.state_dict()
    assert get_telemetry().gauges.get("kfac/snapshot_duration_ms") is not None
    kfac2, fresh, _, cad2 = _elastic_build(1, _mlp_weights(), dict(kfac_update_freq=2))
    restored, _ = state_io.restore_snapshot(snap, fresh, kfac=kfac2, cadence=cad2)
    assert restored.step == 3 and cad2.state_dict() == cad.state_dict()
    _assert_same(_elastic_flat(state), _elastic_flat(restored))
    # the restore copied into the target's own tensors
    assert restored.model is fresh.model
    assert restored.opt_state["fc1.weight"].data_ptr() == fresh.opt_state["fc1.weight"].data_ptr()


def test_scan_skips_damaged_snapshots(tmp_path):
    d = str(tmp_path)
    for s in (2, 4, 6, 8):
        state_io.save_snapshot(d, s, _tiny_state(s))
    assert [s for s, _ in state_io.list_snapshots(d)] == [2, 4, 6, 8]
    faults.truncate_snapshot(state_io.snapshot_dir(d, 8))   # mid-write kill
    faults.corrupt_snapshot(state_io.snapshot_dir(d, 6))    # bitrot
    faults.mark_incomplete(state_io.snapshot_dir(d, 4))     # torn commit
    step, snap = state_io.latest_snapshot(d)
    assert step == 2
    with pytest.raises(SnapshotError):
        state_io.load_manifest(state_io.snapshot_dir(d, 6))
    hit = Supervisor(d).scan_resume(_tiny_state())
    assert hit[2] == 2 and hit[0].kfac_state["step"] == 2
    faults.truncate_snapshot(snap)
    assert state_io.latest_snapshot(d) is None
    assert Supervisor(d).scan_resume(_tiny_state()) is None


def test_supervisor_gc_keeps_newest(tmp_path):
    sup = Supervisor(str(tmp_path), snapshot_every=1, keep=2)
    for s in (1, 2, 3, 4):
        sup.on_step(s, lambda s=s: _tiny_state(s))
    sup.wait()
    assert [s for s, _ in state_io.list_snapshots(str(tmp_path))] == [3, 4]
    assert len(sup.snapshot_durations_ms) == len(sup.write_durations_ms) == 4


def test_supervisor_sigterm_takes_emergency_snapshot(tmp_path):
    sup = Supervisor(str(tmp_path), heartbeat_every=1)
    sup.install_signal_handlers()
    assert sup.on_step(1, lambda: _tiny_state(1)) is False
    os.kill(os.getpid(), signal.SIGTERM)  # delivered synchronously
    assert sup.preempt_requested
    assert sup.on_step(2, lambda: _tiny_state(2)) is True
    step, _ = state_io.latest_snapshot(str(tmp_path))
    assert step == 2
    assert sup.liveness() == 1  # this rank beat within the window
    assert get_telemetry().gauges["kfac/host_liveness"] == 1


def test_worker_beat_is_rate_limited_and_counts_as_live(tmp_path):
    """A curvature-service worker beats on wall clock (no step), at most
    once per interval, and ``liveness`` counts its beat beside the ranks'."""
    sup = Supervisor(str(tmp_path), liveness_window_s=60.0)
    sup.worker_beat(version=3)
    path = tmp_path / "heartbeats" / "worker-0.json"
    first = path.read_text()
    sup.worker_beat(version=4)  # within a quarter of the window: skipped
    assert path.read_text() == first and '"version": 3' in first
    sup.worker_beat(version=5, min_interval_s=0.0)
    assert '"version": 5' in path.read_text()
    sup.heartbeat(7)
    assert sup.liveness() == 2


def test_fault_injector_raise_and_exit_spec():
    inj = FaultInjector(FaultSpec(kill_at_step=3, kill_mode="raise"))
    inj.on_step(2)
    with pytest.raises(SimulatedPreemption):
        inj.on_step(3)
    inj.on_step(4)  # idempotent once fired
    spec = FaultSpec.from_env({"KFAC_FAULT_KILL_AT_STEP": "5", "KFAC_FAULT_KILL_MODE": "exit"})
    assert spec.kill_at_step == 5 and spec.kill_mode == "exit"
    assert spec.exit_code == faults.DEFAULT_EXIT_CODE == 75
    assert FaultSpec.from_env({}) is None
    with pytest.raises(ValueError):
        FaultSpec(kill_at_step=1, kill_mode="meteor")


def test_fault_injector_exit_mode_in_a_subprocess():
    code = ("from kfac_pytorch_tpu_torch.elastic import faults\n"
            "inj = faults.maybe_injector()\n"
            "inj.on_step(1)\n"
            "inj.on_step(2)\n"
            "print('survived')\n")
    env = dict(os.environ, KFAC_FAULT_KILL_AT_STEP="2", KFAC_FAULT_KILL_MODE="exit",
               KFAC_FAULT_EXIT_CODE="9")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 9 and "survived" not in res.stdout
    assert "hard-killing at step 2 (exit 9)" in res.stderr


def test_fault_injector_signal_mode_through_supervisor(tmp_path):
    """Signal-mode kill at step k: the SAME on_step call observes the
    preemption and lands the emergency snapshot at step k."""
    sup = Supervisor(str(tmp_path), fault_injector=FaultInjector(
        FaultSpec(kill_at_step=3, kill_mode="signal")))
    sup.install_signal_handlers()
    assert sup.on_step(2, lambda: _tiny_state(2)) is False
    assert sup.on_step(3, lambda: _tiny_state(3)) is True
    step, _ = state_io.latest_snapshot(str(tmp_path))
    assert step == 3


def test_drop_hosts():
    ranks = list(range(8))
    assert faults.drop_hosts(ranks, 0, 4) == [4, 5, 6, 7]
    assert faults.drop_hosts(ranks, 1, 2) == [0, 1, 4, 5, 6, 7]
    with pytest.raises(ValueError):
        faults.drop_hosts(ranks, 2, 4)


def test_background_write_does_not_tear(tmp_path, monkeypatch):
    """A step runs while the snapshot's write waits; the payload holds the
    state at the snapshot, not the step's in-place updates."""
    kfac, state, fn, cad = _elastic_build(1, _mlp_weights(), dict(kfac_update_freq=2))
    batch = _mlp_batch()
    state = _elastic_steps(fn, cad, state, batch, 0, 3)
    gate, entered, real_save = threading.Event(), threading.Event(), torch.save

    def held_save(obj, f, *args, **kwargs):
        entered.set()
        assert gate.wait(60)
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held_save)
    sup = Supervisor(str(tmp_path), kfac=kfac, cadence=cad)
    assert sup.async_snapshots
    at_snapshot = _elastic_flat(state)
    cadence_at = cad.state_dict()
    sup.snapshot(3, state)
    assert entered.wait(60) and not os.path.exists(
        os.path.join(state_io.snapshot_dir(str(tmp_path), 3), state_io.MANIFEST_NAME))
    state = _elastic_steps(fn, cad, state, batch, 3, 5)  # kernel 4 and the EMAs in place
    assert not torch.equal(state.model.fc1.weight, at_snapshot["model/fc1.weight"])
    gate.set()
    sup.wait()
    monkeypatch.setattr(torch, "save", real_save)
    kfac2, fresh, _, cad2 = _elastic_build(1, _mlp_weights(), dict(kfac_update_freq=2))
    restored, manifest = state_io.restore_snapshot(
        state_io.snapshot_dir(str(tmp_path), 3), fresh, kfac=kfac2, cadence=cad2)
    _assert_same(at_snapshot, _elastic_flat(restored))
    assert manifest["cadence"] == cadence_at


def test_background_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    def failing_save(obj, f, *args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    sup = Supervisor(str(tmp_path))
    sup.snapshot(1, _tiny_state(1))
    with pytest.raises(SnapshotError, match="background snapshot write failed: OSError: disk full"):
        sup.wait()
    sup.wait()  # raised once
    assert state_io.latest_snapshot(str(tmp_path)) is None


def test_packed_rows_of_another_world_are_refused():
    packed = {"factor_local": {"l0": {"A": torch.zeros(2, 3, 3)}}, "step": 0, "factors": {}}
    with pytest.raises(SnapshotError,
                       match="packed replica-local world 2 != mesh size 1"):
        state_io.unpack_replica_local(packed)
    state, packed_flag = state_io.pack_replica_local(
        {"factors": {}, "wire_error": [torch.arange(3.0)]})
    assert packed_flag and state["wire_error"][0].shape == (1, 3)
    assert torch.equal(state_io.unpack_replica_local(state)["wire_error"][0], torch.arange(3.0))


# ------------------------------------------------------- mid-interval resume


def test_mid_interval_resume_bitwise_and_against_jax(tmp_path):
    """Snapshot at step 6 of a kfac_update_freq=4 / eigh_chunks=3 run, with
    chunks 0 and 1 of the pending refresh landed; the resumed run is the
    uninterrupted one's bits at step 12, at the model level (the overlap
    tests' MLP, kernel 4's plain version) and at the update level, whose
    preconditioned gradients also follow the JAX package's run."""
    kw = dict(kfac_update_freq=4, eigh_chunks=3)
    kfac, state, fn, cad = _elastic_build(1, _mlp_weights(), kw)
    batch = _mlp_batch()
    state = _elastic_steps(fn, cad, state, batch, 0, 6)
    assert cad.state_dict()["landed"] == [0, 1]
    Supervisor(str(tmp_path / "mlp"), kfac=kfac, cadence=cad).snapshot(6, state)
    final = _elastic_flat(_elastic_steps(fn, cad, state, batch, 6, 12))
    kfac2, state2, fn2, cad2 = _elastic_build(1, _mlp_weights(), kw)
    rstate, manifest, rstep = Supervisor(str(tmp_path / "mlp"), kfac=kfac2,
                                         cadence=cad2).scan_resume(state2)
    assert rstep == 6 and cad2.state_dict()["landed"] == [0, 1]
    _assert_same(final, _elastic_flat(_elastic_steps(fn2, cad2, rstate, batch, 6, 12)))

    inputs = _update_inputs(12, 31)
    common = dict(fac_update_freq=1, damping=DAMPING, **kw)
    model = _owner_net(NET)
    kfac = KFAC(layers=list(NET), device="cpu", **common)
    cad = EigenRefreshCadence(kfac)
    st, _ = _port_updates(kfac, cad, kfac.init(model), inputs, 0, 6)
    state_io.save_snapshot(str(tmp_path / "upd"), 6,
                           TrainState(step=6, model=model, opt_state={}, kfac_state=st),
                           kfac=kfac, cadence=cad)
    _, uninterrupted = _port_updates(kfac, cad, st, inputs, 6, 12)
    kfac2 = KFAC(layers=list(NET), device="cpu", **common)
    cad2 = EigenRefreshCadence(kfac2)
    target = TrainState(step=0, model=model, opt_state={}, kfac_state=kfac2.init(model))
    rstate, _, _ = Supervisor(str(tmp_path / "upd"), kfac=kfac2, cadence=cad2).scan_resume(target)
    _, resumed = _port_updates(kfac2, cad2, rstate.kfac_state, inputs, 6, 12)
    _, _, jnew = _jax_updates(JKFAC(layers=list(NET), **common), inputs, 12)
    for step in range(6):
        for n, v in uninterrupted[step].items():
            np.testing.assert_array_equal(resumed[step][n], v)
        want = jnew[6 + step]
        for name in NET:
            _close(resumed[step][f"{name}.weight"].T, want[name]["kernel"], 1e-4)
            _close(resumed[step][f"{name}.bias"], want[name]["bias"], 1e-4)


def test_mid_stream_resume_bitwise(tmp_path):
    """Streaming solver, snapshot between re-orthonormalizations: with a
    quiet drift signal the resumed run equals the uninterrupted one and
    does NOT re-orthonormalize at the first resumed boundary."""
    kw = dict(kfac_update_freq=4, solver="streaming", solver_rank=8,
              solver_auto_threshold=16, stream_drift_threshold=0.5)
    kfac, state, fn, cad = _elastic_build(1, _mlp_weights(), kw)
    batch = _mlp_batch()
    state = _elastic_steps(fn, cad, state, batch, 0, 7)
    assert int(state.kfac_state["stream_fold_steps"]) > 0
    assert cad.state_dict()["reorth_count"] == 1
    Supervisor(str(tmp_path), kfac=kfac, cadence=cad).snapshot(7, state, sync=True)
    final = _elastic_flat(_elastic_steps(fn, cad, state, batch, 7, 12))
    kfac2, state2, fn2, cad2 = _elastic_build(1, _mlp_weights(), kw)
    rstate, manifest, rstep = Supervisor(str(tmp_path), kfac=kfac2,
                                         cadence=cad2).scan_resume(state2)
    assert rstep == 7
    assert {"stream_residual", "stream_fold_steps"} <= set(manifest["kfac_state_keys"])
    assert cad2.state_dict()["reorth_count"] == 1 and cad2.state_dict()["bootstrapped"]
    _assert_same(final, _elastic_flat(_elastic_steps(fn2, cad2, rstate, batch, 7, 12)))
    assert cad2.state_dict()["reorth_count"] == 1  # boundary 8 stayed quiet


# ------------------------------------------------------------ resize replan


@pytest.mark.parametrize("net", ["dense", "embed"])
def test_host_remap_eight_to_four_equals_jax(net):
    """The same global-form stacks of an 8-rank owner layout, re-laid for 4:
    the port's host remap equals the JAX ``resize_owner_state`` on the
    8-device CPU mesh bit for bit; fingerprints equal; two remaps are
    bitwise equal; a wrong fingerprint is refused."""
    devs = jax.devices()
    mesh8, mesh4 = Mesh(np.asarray(devs[:8]), ("data",)), Mesh(np.asarray(devs[:4]), ("data",))
    layers = ["l0", "l1", "l2", "l3"] if net == "dense" else ["emb", "l2", "l3"]
    params = jax.tree_util.tree_map(jnp.asarray, _jparams(net))
    kw = dict(factor_sharding="owner", kfac_update_freq=2, layers=layers)
    k8, k4 = JKFAC(mesh=mesh8, **kw), JKFAC(mesh=mesh4, **kw)
    s8 = jax.device_get(k8.init(params))
    r = np.random.RandomState(41)
    rand = lambda x: r.randn(*np.shape(x)).astype(np.asarray(x).dtype)  # noqa: E731
    s8["factor_shard"] = jax.tree_util.tree_map(rand, s8["factor_shard"])
    s8["eigen_shard"] = jax.tree_util.tree_map(rand, s8["eigen_shard"])
    shapes, diag_a = k4.factor_shapes(params)
    fingerprint = jassign.plan_fingerprint(
        jassign.plan_factor_shards(shapes, 8, k4.factor_comm.max_bucket_elems, diag_a=set(diag_a)))
    want = jax.device_get(jreplan.resize_owner_state(k4, s8, params, 8,
                                                     expect_fingerprint=fingerprint))
    port_plan = assignment.plan_factor_shards(shapes, 8, k4.factor_comm.max_bucket_elems,
                                              diag_a=set(diag_a))
    assert assignment.plan_fingerprint(port_plan) == fingerprint

    def remap(fp=fingerprint):
        return replan.remap_owner_stacks(
            _t(s8["factor_shard"]), _t(s8["eigen_shard"]), shapes, diag_a, 8, 4,
            k4.factor_comm.max_bucket_elems, expect_fingerprint=fp)

    got = remap()
    for key, v in want["factor_shard"].items():
        np.testing.assert_array_equal(got[0][key].numpy(), v)
    assert got[1].keys() == want["eigen_shard"].keys()
    for key, grp in want["eigen_shard"].items():
        assert got[1][key].keys() == grp.keys()
        for leaf, v in grp.items():
            np.testing.assert_array_equal(got[1][key][leaf].numpy(), v)
    again = remap()
    for a, b in zip(jax.tree_util.tree_leaves(_np(got)), jax.tree_util.tree_leaves(_np(again))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fingerprint"):
        remap("0badc0ffee0badc0")


# ---------------------------------------------------------------- the twins


_CHILD = ("import sys, torch\n"
          "torch.set_num_threads(1)\n"
          "from kfac_pytorch_tpu_torch.examples import {name} as trainer\n"
          "trainer.main(sys.argv[1:])\n")

TWINS = {
    "train_wikitext_rnn": [
        "--synthetic", "--epochs", "2", "--steps-per-epoch", "4", "--emsize", "16",
        "--nhid", "16", "--nlayers", "1", "--batch-size", "4", "--bptt", "8",
        "--kfac-update-freq", "2", "--dropout", "0.3", "--device", "cpu"],
    "train_cifar10_resnet": [
        "--synthetic", "--model", "resnet20", "--batch-size", "4", "--epochs", "2",
        "--steps-per-epoch", "3", "--device", "cpu", "--kfac-update-freq", "2",
        "--eigh-chunks", "2", "--num-workers", "0"],
}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_fault_kill_and_resume_bitwise(name, tmp_path):
    """Killed hard at step 3 by the environment's injector (exit 75), the
    twin resumes from its step-2 periodic snapshot on rerun and trains the
    uninterrupted run's losses from step 2, bit for bit (the WikiText
    twin's dropout generator and recurrent carry ride the snapshot)."""
    import importlib

    trainer = importlib.import_module(f"kfac_pytorch_tpu_torch.examples.{name}")
    base = TWINS[name]
    full = trainer.main(base)["loss"]
    args = base + ["--preempt-save-dir", str(tmp_path / "snaps"), "--snapshot-every", "2"]
    env = dict(os.environ, KFAC_FAULT_KILL_AT_STEP="3", KFAC_FAULT_KILL_MODE="exit")
    res = subprocess.run([sys.executable, "-c", _CHILD.format(name=name), *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == faults.DEFAULT_EXIT_CODE, res.stderr[-2000:]
    assert "hard-killing at step 3" in res.stderr
    step, _ = state_io.latest_snapshot(str(tmp_path / "snaps"))
    assert step == 2
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist = trainer.main(args)
    assert "elastic: resumed from snapshot at step 2" in printed.getvalue()
    assert hist["loss"] == full[2:]
    assert len(hist["restore_ms"]) == 1 and len(hist["elastic"]["snapshot_ms"]) >= 1


def test_later_flags_name_only_the_service():
    import importlib

    # the service (item 9d) was the last later flag: the tables are gone
    # and --service-devices is each twin's own flag
    for name in ("train_cifar10_resnet", "train_transformer_lm", "train_wikitext_rnn"):
        trainer = importlib.import_module(f"kfac_pytorch_tpu_torch.examples.{name}")
        assert not hasattr(trainer, "_LATER_FLAGS")
        assert trainer.parse_args(["--service-devices", "1"]).service_devices == 1
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm

    args = lm.parse_args(["--preempt-save-dir", "x", "--snapshot-every", "7"])
    assert (args.preempt_save_dir, args.snapshot_every) == ("x", 7)
    assert lm.parse_args([]).preempt_save_dir is None and lm.parse_args([]).snapshot_every == 0
