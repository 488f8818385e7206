"""The port's refresh cadence (``scheduler.EigenRefreshCadence``) and chunk
planners (``parallel.assignment.plan_eigh_chunks``/``eigh_chunk_owners``)
against the JAX package's.

Both cadences run over 60 steps on the same stub preconditioner (the
attributes a cadence reads: ``hparams``, ``diag_warmup``, ``eigh_chunks``,
``staleness_budget`` and its pressure signal, ``solver`` and its drift
signal), mutated between steps the same way for both, and must give equal
flags at every step (exact: these are host-side integers and booleans).
The planners must return equal plans for the same slots. With one chunk
the cadence's flags are ``training.step.kfac_flags_for_step``'s.

The three twins whose JAX trainers carry the refresh and solver flags
(CIFAR, transformer LM, WikiText) take them on the CPU for a few steps,
with the JAX cadence's step kinds; a CIFAR twin state with the truncated
solver's and the pipelined refresh's entries round-trips through a
checkpoint bitwise.
"""

import math
import types

import pytest
import torch

from kfac_pytorch_tpu.parallel import assignment as jassign
from kfac_pytorch_tpu.parallel.sharded_eigh import EighSlot as JSlot
from kfac_pytorch_tpu.scheduler import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
from kfac_pytorch_tpu_torch.parallel import assignment
from kfac_pytorch_tpu_torch.parallel.sharded_eigh import EighSlot
from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

STEPS = 60


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stub(chunks=1, kfac_update_freq=10, fac_update_freq=1, diag_warmup=0,
          staleness_budget=0, solver="eigh", stream_drift_threshold=0.05):
    return types.SimpleNamespace(
        hparams=types.SimpleNamespace(fac_update_freq=fac_update_freq,
                                      kfac_update_freq=kfac_update_freq),
        diag_warmup=diag_warmup, eigh_chunks=chunks, staleness_budget=staleness_budget,
        staleness_signal=None, solver=solver, solver_rank=128,
        stream_drift_signal=None, stream_drift_threshold=stream_drift_threshold,
        service_devices=0,
    )


def _run(stub, events=None, epoch_of=lambda step: None):
    """Both cadences over STEPS steps on ``stub``; ``events[step](stub)``
    mutates it before that step. Returns the flags, JAX's and the port's."""
    jc, tc = JCadence(stub), EigenRefreshCadence(stub)
    jflags, tflags = [], []
    for step in range(STEPS):
        if events and step in events:
            events[step](stub)
        epoch = epoch_of(step)
        jflags.append(jc.flags_for_step(step, epoch))
        tflags.append(tc.flags_for_step(step, epoch))
        assert tc.state_dict() == jc.state_dict(), step
    return jflags, tflags, jc, tc


@pytest.mark.parametrize("chunks", [1, 3, 10])
def test_cadence_matches_jax(chunks):
    jf, tf, _, tc = _run(_stub(chunks))
    assert tf == jf
    kinds = [("chunk" if "eigen_chunk" in f else "refresh" if f["update_eigen"] else "-")
             for f in tf]
    if chunks == 1:
        assert kinds.count("refresh") == STEPS // 10
    else:
        # a monolithic bootstrap, then chunked intervals only
        assert kinds[0] == "refresh" and kinds.count("refresh") == 1
        assert sum(bool(f.get("swap_eigen")) for f in tf) == STEPS // 10 - 1
    assert tc.basis_age == (STEPS - 1) - tc._last_refresh_step


def test_one_chunk_equals_kfac_flags_for_step():
    kfac = KFAC(device="cpu", kfac_update_freq=7, fac_update_freq=2, diag_warmup=1)
    cadence = EigenRefreshCadence(kfac)
    for step in range(STEPS):
        epoch = step // 25
        assert cadence.flags_for_step(step, epoch) == kfac_flags_for_step(step, kfac, epoch)
    assert EigenRefreshCadence(None).flags_for_step(0) == kfac_flags_for_step(0, None)


@pytest.mark.parametrize("events", [
    # the update frequency shrinks below the chunks in flight, then grows
    {13: lambda s: setattr(s.hparams, "kfac_update_freq", 2),
     31: lambda s: setattr(s.hparams, "kfac_update_freq", 12)},
    # it shrinks at a boundary and grows mid-interval
    {20: lambda s: setattr(s.hparams, "kfac_update_freq", 4),
     37: lambda s: setattr(s.hparams, "kfac_update_freq", 9)},
], ids=["shrink-grow", "boundary-shrink"])
def test_cadence_replans_on_frequency_changes(events):
    jf, tf, _, _ = _run(_stub(chunks=3), events)
    assert tf == jf


def test_cadence_diag_warmup_flip_abandons_the_partial_pass():
    # the warmup ends at step 22, two chunks into an interval
    stub = _stub(chunks=4, diag_warmup=1)
    jf, tf, _, _ = _run(stub, epoch_of=lambda step: 0 if step < 22 else 1)
    assert tf == jf
    assert not any(f.get("eigen_chunk") for f in tf[22:30])  # the pass is dropped


def test_cadence_staleness_slip_and_catch_up():
    """A pressure signal above the threshold on some steps: the last
    chunk withholds its swap, which lands as a bare swap within the
    budget."""
    stub = _stub(chunks=3, staleness_budget=3)
    pressure = {s: 2.0 for s in (12, 13, 14, 32, 33, 34, 35, 36, 37)}
    clock = {"step": 0}
    stub.staleness_signal = lambda: pressure.get(clock["step"], 0.0)
    jc, tc = JCadence(stub), EigenRefreshCadence(stub)
    jf, tf = [], []
    for step in range(STEPS):
        clock["step"] = step
        jf.append(jc.flags_for_step(step))
        tf.append(tc.flags_for_step(step))
        assert tc.state_dict() == jc.state_dict()
    assert tf == jf
    bare = [s for s, f in enumerate(tf) if f.get("swap_eigen") and "eigen_chunk" not in f]
    assert bare, "no swap slipped"
    assert tc._swap_slip == jc._swap_slip


def test_cadence_streaming_drift_signal():
    stub = _stub(solver="streaming", kfac_update_freq=5, stream_drift_threshold=0.1)
    drift = iter([0.2, 0.05, 0.3, 0.0, 0.11, 0.1, 0.5, 0.01, 0.2, 0.2, 0.2, 0.2] * 2)
    reads = {}

    def signal():
        # the same value for both cadences' read at one boundary
        key = clock["step"]
        if key not in reads:
            reads[key] = next(drift)
        return reads[key]

    clock = {"step": 0}
    stub.stream_drift_signal = signal
    jc, tc = JCadence(stub), EigenRefreshCadence(stub)
    jf, tf = [], []
    for step in range(STEPS):
        clock["step"] = step
        jf.append(jc.flags_for_step(step))
        tf.append(tc.flags_for_step(step))
    assert tf == jf
    assert tc._reorth_count == jc._reorth_count
    assert 1 < tc._reorth_count < STEPS // 5  # some boundaries skip


def test_cadence_state_dict_round_trip():
    """A cadence restored mid-interval from the JAX cadence's state dict
    continues exactly as the uninterrupted one."""
    stub = _stub(chunks=4, staleness_budget=2)
    ref = EigenRefreshCadence(stub)
    flags = [ref.flags_for_step(s) for s in range(STEPS)]
    jc = JCadence(stub)
    for s in range(23):
        jc.flags_for_step(s)
    resumed = EigenRefreshCadence(stub)
    resumed.load_state_dict(jc.state_dict())
    assert [resumed.flags_for_step(s) for s in range(23, STEPS)] == flags[23:]
    assert resumed.state_dict() == ref.state_dict()


def _slots(seed):
    import numpy as np

    r = np.random.RandomState(seed)
    out = []
    for i in range(r.randint(3, 14)):
        n = int(r.choice([27, 64, 128, 130, 300, 513, 576, 700, 2048]))
        for fac in ("A", "G"):
            out.append((f"l{i:02d}", fac, 0, n, int(r.randint(0, 4))))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ranked", [False, True], ids=["dense", "rank_fn"])
def test_chunk_planners_match_jax(seed, ranked):
    raw = _slots(seed)
    jslots = [JSlot(*s) for s in raw]
    tslots = [EighSlot(*s) for s in raw]
    rank_fn = (lambda n: None if n < 512 or n <= 128 else 128) if ranked else None
    for chunks in (1, 2, 3, 5, 40):
        assert assignment.plan_eigh_chunks(tslots, chunks, rank_fn=rank_fn) == \
            jassign.plan_eigh_chunks(jslots, chunks, rank_fn=rank_fn)
    for world in (1, 2, 3, 4, 8):
        assert assignment.eigh_chunk_owners(tslots, world, rank_fn=rank_fn) == \
            jassign.eigh_chunk_owners(jslots, world, rank_fn=rank_fn)
    for n in (1, 128, 129, 512, 513, 33278):
        assert assignment._slot_cost(n, 512, 128, rank_fn) == \
            jassign._slot_cost(n, 512, 128, rank_fn)


# ------------------------------------------------------------- the twins
#
# Each twin takes the refresh and solver flags on the CPU for a few steps
# and records the step kinds (``training.step.step_kind``) of the flags
# its cadence gave; those must be the kinds the JAX trainer's cadence
# (``EigenRefreshCadence`` over the JAX ``KFAC`` with the same levers)
# gives, with the streaming drift signal fed the port's recorded residuals.


def _jax_kinds(steps, drift=None, **kw):
    from kfac_pytorch_tpu import KFAC as JKFAC
    from kfac_pytorch_tpu_torch.training.step import step_kind

    jk = JKFAC(**kw)
    if drift is not None:
        clock = {"step": 0}
        jk.stream_drift_signal = lambda: drift[clock["step"] - 1]
    cadence = JCadence(jk)
    kinds = []
    for step in range(steps):
        if drift is not None:
            clock["step"] = step
        kinds.append(step_kind(cadence.flags_for_step(step, 0)))
    return kinds


def test_cifar_twin_takes_chunks_rsvd_and_slip():
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    hist = trainer.main([
        "--synthetic", "--model", "resnet20", "--batch-size", "4", "--epochs", "1",
        "--steps-per-epoch", "8", "--num-workers", "0", "--device", "cpu",
        "--kfac-update-freq", "3", "--eigh-chunks", "2", "--solver", "rsvd",
        "--solver-rank", "8", "--solver-auto-threshold", "64", "--staleness-budget", "1",
    ])
    want = _jax_kinds(8, kfac_update_freq=3, fac_update_freq=1, eigh_chunks=2,
                      solver="rsvd", solver_rank=8, solver_auto_threshold=64,
                      staleness_budget=1)
    assert hist["kind"] == want
    assert want[:5] == ["refresh", "capture", "capture", "chunk", "chunk-swap"]
    assert all(math.isfinite(v) for v in hist["loss"])
    assert 0.0 < hist["kfac_spectrum_mass"][-1] < 1.0


def test_lm_twin_takes_chunks_and_rsvd():
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    hist = trainer.main([
        "--synthetic", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "6",
        "--device", "cpu", "--kfac-embedding", "--kfac-update-freq", "2",
        "--eigh-chunks", "2", "--solver", "rsvd", "--solver-rank", "8",
        "--solver-auto-threshold", "32",
    ])
    assert hist["kind"] == _jax_kinds(6, kfac_update_freq=2, fac_update_freq=1,
                                      eigh_chunks=2, solver="rsvd")
    assert hist["kind"][:4] == ["refresh", "capture", "chunk", "chunk-swap"]
    assert all(math.isfinite(v) for v in hist["loss"])


def test_wikitext_twin_takes_streaming():
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    hist = trainer.main([
        "--synthetic", "--emsize", "8", "--nhid", "8", "--batch-size", "4", "--bptt", "6",
        "--epochs", "1", "--steps-per-epoch", "7", "--device", "cpu", "--kfac-embedding",
        "--kfac-update-freq", "2", "--solver", "streaming", "--solver-rank", "4",
        "--solver-auto-threshold", "8", "--stream-drift-threshold", "0.02",
    ])
    drift = hist["kfac_stream_residual"]
    assert hist["kind"] == _jax_kinds(7, drift=drift, kfac_update_freq=2, fac_update_freq=1,
                                      solver="streaming", stream_drift_threshold=0.02)
    assert hist["kind"][0] == "refresh" and all(math.isfinite(v) for v in hist["loss"])


def test_checkpoint_round_trips_rsvd_and_chunk_state(tmp_path):
    """A CIFAR twin state under ``--solver rsvd --eigh-chunks 2`` mid-interval
    (after a chunk, before its swap), saved and restored into a fresh
    build: every tensor bitwise, rectangular bases, residual masses, the
    pending buffer and the solver scalars included."""
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    args = trainer.parse_args([
        "--synthetic", "--model", "resnet20", "--batch-size", "2", "--device", "cpu",
        "--kfac-update-freq", "2", "--eigh-chunks", "2", "--solver", "rsvd",
        "--solver-rank", "8", "--solver-auto-threshold", "64", "--staleness-budget", "1",
    ])
    device = torch.device("cpu")
    _, kfac, state, step_fn = trainer.build(args, device)
    cadence = EigenRefreshCadence(kfac)
    g = torch.Generator().manual_seed(0)
    for step in range(3):  # refresh, capture, chunk 0
        x, y = torch.randn(2, 3, 32, 32, generator=g), torch.randint(0, 10, (2,), generator=g)
        state, _ = step_fn(state, (x, y), 0.1, 0.003, **cadence.flags_for_step(step))
    saved = state.kfac_state
    assert saved["eigen_pending"] and "spectrum_mass" in saved and "eigen_swap_slip" in saved
    assert any("rhoA" in e for e in saved["eigen"].values())
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    _, _, fresh, _ = trainer.build(args, device)
    restored = ckpt.restore_checkpoint(str(tmp_path), 0, fresh)

    def equal(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                equal(a[k], b[k])
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b

    equal(restored.kfac_state, saved)
    equal(restored.opt_state, state.opt_state)
