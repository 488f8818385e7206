"""The port's factor comm plane (``parallel/comm.py``, ``KFAC``'s
``factor_comm_dtype``/``factor_comm_freq``, the deferred flush in the
cadences and the steps) and the data-parallel LM twins, on 2 and 4 gloo
ranks on the CPU, against the JAX package on a mesh of the same size
(``tests/conftest.py``'s 8 virtual devices).

The ranks are spawned by ``tests/torch_dist_workers.py`` (task ``comm``, a
file store under ``tmp_path``, one torch thread each): one spawn per world
size, module-scoped; the tests read its results.

* ``plan_factor_buckets`` equals the JAX planner on shape lists (packing,
  an oversized leaf, the cap refusal); flatten/unflatten round-trip bitwise.
* ``quantize_bucket`` on the JAX package's uniform draw: codes and scales
  bitwise, ``quant_wire_bytes`` equal.
* The bucketed float32 mean is bitwise the per-leaf reference at 2 ranks
  (``a + b`` is order-free); at 4 ranks the backend may sum a bucket in
  another order than a lone leaf, so it holds 1 float32 ulp of the largest
  entry there. It matches the JAX ``FactorComm.allreduce`` on a 2- and a
  4-device mesh of the same inputs to the same bound. The bf16 wire holds
  the JAX package's 3e-2/3e-3 against float32 and 2⁻⁷ relative (one
  bfloat16 ulp) of JAX's bf16 wire at 2 ranks, plus 2⁻⁷ of the leaf's
  largest entry at 4 (partial sums rounded in other orders), with half the
  wire bytes.
* The int8 merge on injected draws against JAX's ``_merge_quantized``:
  merged factors within 1e-6 of the largest entry, new residuals within
  1e-6 of the largest entry of their bucket's payload (they are payload
  minus codes times scale, a difference XLA fuses into a multiply-add).
* Deferred flush after local EMAs against per-step reduction: factors at
  flush steps within 1e-5/1e-6, the updates (which read only the eigen
  basis refreshed at step 0) within 1e-6/1e-7, ages ``[0, 1, 2, 0, 1, 2]``;
  the ranks' factors differ between flushes and agree at them.
* The cadences' flush flags equal the JAX ones over a grid; ``KFAC``'s
  refusals carry JAX's messages; a capture step issues as many factor
  ``all_reduce``s as it has buckets, a deferred one none until it flushes.
* The slice: the tiny transformer LM (one block, K-FAC with the token
  embedding) for 4 steps on 2 ranks with the bf16 factor wire deferred to
  every second capture step and bf16 gradients, against the JAX
  ``make_train_step`` (the JAX transformer trainer's step) on a 2-device
  mesh with the same levers, weights and batches: losses within 1e-5
  relative, parameters within 1e-4 of each tensor's largest entry (+1e-6):
  the two packages round the same float32 gradients to bfloat16, and a
  rounding that lands on the neighbouring value (2⁻⁸ relative) spreads
  through the preconditioned step (1.9e-5 measured); the factors within
  2e-4 of the largest entry (5.5e-5 measured): the step-2 flush rounded
  each rank's running averages to bfloat16 in both packages, and the
  small entries are sums that cancel. The tiny LSTM twin on 2 ranks at dropout 0
  against one process on the concatenated batch (no JAX): losses within
  1e-5 relative, with the float32 wire deferred; the int8 wire within
  1e-2 relative of it.
"""

import math
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import compat
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.parallel import comm as jcomm
from kfac_pytorch_tpu.parallel.assignment import plan_factor_buckets as jplan
from kfac_pytorch_tpu.parallel.mesh import put_global_batch
from kfac_pytorch_tpu.scheduler import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import kfac_flags_for_step as jflags
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as wikitext_trainer
from kfac_pytorch_tpu_torch.interop import lm_state_dict_from_jax
from kfac_pytorch_tpu_torch.parallel import comm
from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_buckets
from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step, step_kind
from tests import torch_dist_workers as workers
from tests.test_torch_port_wikitext import _write_wikitext


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, rel, floor=0.0):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * float(np.abs(w).max()) + floor)


# ---------------------------------------------------------------- planning


PLAN_CASES = [([(4, 4), (4, 4), (3,)], 20), ([(2, 2), (50,), (2, 2)], 8),
              ([(75, 75), (16, 16), (33, 33), (10, 10), (512,), (4, 9, 9), (1, 1)], 1),
              ([(75, 75), (16, 16), (33, 33), (10, 10), (512,), (4, 9, 9), (1, 1)], 64),
              ([(75, 75), (16, 16), (33, 33), (10, 10), (512,), (4, 9, 9), (1, 1)], 1 << 20)]


@pytest.mark.parametrize("shapes,cap", PLAN_CASES)
def test_bucket_plan_matches_jax_and_round_trips(shapes, cap):
    got, want = plan_factor_buckets(shapes, cap), jplan(shapes, cap)
    assert [(b.size, [(e.index, e.offset, e.size, e.shape) for e in b.entries]) for b in got] \
        == [(b.size, [(e.index, e.offset, e.size, e.shape) for e in b.entries]) for b in want]
    r = np.random.RandomState(len(shapes) + cap % 97)
    leaves = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
    back = comm.unflatten_buckets(comm.flatten_buckets(leaves, got), got, leaves)
    for a, b in zip(leaves, back, strict=True):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="max_bucket_elems"):
        plan_factor_buckets(shapes, 0)


def test_quantizer_matches_jax_on_its_draw():
    r = np.random.RandomState(0)
    # a ragged length (the pad), a loud and a quiet block, an all-zero block
    buf = np.concatenate([r.randn(256) * 1e3, r.randn(256) * 1e-3, np.zeros(256),
                          r.randn(300)]).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jcodes, jscale = jcomm.quantize_bucket(jnp.asarray(buf), key)
    u = np.array(jax.random.uniform(key, jcodes.shape, jnp.float32))
    codes, scale = comm.quantize_bucket(torch.from_numpy(buf), torch.from_numpy(u))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (5, 256)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(codes[2].numpy(), 0)
    np.testing.assert_array_equal(
        comm.dequantize_bucket(codes, scale, buf.size).numpy(),
        np.asarray(jcomm.dequantize_bucket(jcodes, jscale, buf.size)))
    for sizes in ([100_000, 777], [256], [1, 255, 257]):
        assert comm.quant_wire_bytes(sizes) == jcomm.quant_wire_bytes(sizes)
    # a chunked pass equals one pass on the same draw, and leaves the residual
    fc = comm.FactorComm(World(), "int8", 2)
    fc.draw = lambda step, b, first, n, device: torch.from_numpy(u[first:first + n])
    payload = torch.from_numpy(buf.copy())
    old, comm.QUANT_CHUNK_BLOCKS = comm.QUANT_CHUNK_BLOCKS, 2
    try:
        c2, s2 = fc.quantize_payload_(payload, 0, 0)
    finally:
        comm.QUANT_CHUNK_BLOCKS = old
    np.testing.assert_array_equal(c2.numpy(), codes.numpy())
    np.testing.assert_array_equal(s2.numpy(), scale.numpy())
    np.testing.assert_array_equal(
        payload.numpy(), buf - comm.dequantize_bucket(codes, scale, buf.size).numpy())


# ------------------------------------------------------------ the ranks

CAP = 100
STAT_SHAPES = {"l0": {"A": (9, 9), "G": (4, 4)}, "l1": {"A_diag": (300,), "G": (6, 6)},
               "l2": {"A": (17, 17), "G": (3, 3)}, "l3": {"A": (1, 1), "G": (5, 5)}}
QUANT_STEP = 5
LM_VOCAB, LM_SEQ, LM_BATCH, LM_STEPS = 64, 16, 2, 4  # LM_BATCH per rank
LM_MODEL_KW = dict(max_len=LM_SEQ, d_model=32, n_heads=2, n_layers=1, kfac_embedding=True)
LM_HP = dict(factor_decay=0.95, damping=0.003, kl_clip=0.001, fac_update_freq=1,
             kfac_update_freq=2)
LM_LR, LM_MOMENTUM, LM_WD, LM_CLIP = 0.1, 0.9, 1e-5, 0.25


def _stats(world, seed):
    r = np.random.RandomState(seed)
    return {n: {k: (r.randn(world, *s) * (10.0 ** r.randint(-2, 3))).astype(np.float32)
                for k, s in f.items()} for n, f in STAT_SHAPES.items()}


def _quant_inputs(world, stats):
    plan = jplan([leaf.shape[1:] for leaf in _leaves(stats)], CAP)
    base = jax.random.fold_in(jax.random.PRNGKey(jcomm._QUANT_SEED), jnp.int32(QUANT_STEP))
    draws = [np.asarray(jax.random.uniform(jax.random.fold_in(base, i),
                                           (-(-b.size // 256), 256), jnp.float32))
             for i, b in enumerate(plan)]
    r = np.random.RandomState(world)
    wire_error = {f"b{i}": (r.randn(world, b.size) * 1e-2).astype(np.float32)
                  for i, b in enumerate(plan)}
    return dict(draws=draws, wire_error=wire_error, step=QUANT_STEP)


def _deferred_inputs(world, steps=6):
    r = np.random.RandomState(40 + world)

    def spd(n):
        m = r.randn(world, n + 2, n)
        return (np.einsum("wki,wkj->wij", m, m) / (n + 2)).astype(np.float32)

    return dict(
        steps=steps,
        a=[{"fc1": spd(7), "fc2": spd(6)} for _ in range(steps)],
        g=[{"fc1": spd(5), "fc2": spd(3)} for _ in range(steps)],
        grads=[{"fc1.weight": r.randn(5, 6).astype(np.float32),
                "fc1.bias": r.randn(5).astype(np.float32),
                "fc2.weight": r.randn(3, 5).astype(np.float32),
                "fc2.bias": r.randn(3).astype(np.float32)} for _ in range(steps)],
    )


def _jax_lm():
    """The JAX LM, its init batch and its parameters (the init jitted: one
    compile costs less than the eager ops' first dispatches)."""
    jmodel = jlm.get_model(LM_VOCAB, **LM_MODEL_KW)
    init = jnp.zeros((LM_BATCH, LM_SEQ), jnp.int32)
    params = jax.jit(lambda k, x: jmodel.init(k, x, train=True))(jax.random.PRNGKey(3), init)
    return jmodel, init, params["params"]


def _lm_inputs(world):
    jmodel, init, params = _jax_lm()
    r = np.random.RandomState(44)
    batches = [(r.randint(0, LM_VOCAB, size=(world * LM_BATCH, LM_SEQ)).astype(np.int32),
                r.randint(0, LM_VOCAB, size=(world * LM_BATCH, LM_SEQ)).astype(np.int32))
               for _ in range(LM_STEPS)]
    sd = {k: v.numpy() for k, v in lm_state_dict_from_jax(_np_tree(params)).items()}
    return dict(vocab=LM_VOCAB, model_kw=LM_MODEL_KW, state_dict=sd, batches=batches,
                hp=LM_HP, lr=LM_LR, momentum=LM_MOMENTUM, wd=LM_WD, clip=LM_CLIP)


LSTM_STEPS = 6
LSTM_RUNS = {"f32_deferred": ["--factor-comm-freq", "2"],
             "int8": ["--factor-comm-dtype", "int8", "--factor-comm-freq", "2"]}


def _lstm_argv(data_dir):
    return ["--data-dir", data_dir, "--model", "LSTM", "--emsize", "8", "--nhid", "8",
            "--batch-size", "4", "--bptt", "6", "--epochs", "1", "--steps-per-epoch",
            str(LSTM_STEPS), "--dropout", "0", "--kfac-update-freq", "3", "--kfac-embedding",
            "--device", "cpu"]


# the CIFAR twin's factor comm flags on the ranks (int8 rides the flush)
CIFAR_ARGV = ["--synthetic", "--model", "resnet8", "--batch-size", "4", "--epochs", "1",
              "--steps-per-epoch", "3", "--kfac-update-freq", "2", "--num-workers", "0",
              "--factor-comm-dtype", "int8", "--factor-comm-freq", "2", "--device", "cpu"]

_RESULTS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def run(world):
        if world not in _RESULTS:
            root = tmp_path_factory.mktemp(f"comm{world}")
            stats = _stats(world, 30 + world)
            inputs = dict(stats=stats, cap=CAP, quant=_quant_inputs(world, stats),
                          out_dir=str(root))
            if world == 2:
                data_dir = _write_wikitext(str(root / "wt"), seed=3)
                inputs.update(deferred=_deferred_inputs(world), lm=_lm_inputs(world),
                              lstm=dict(argv=_lstm_argv(data_dir), runs=LSTM_RUNS),
                              cifar=CIFAR_ARGV)
            _RESULTS[world] = (inputs, workers.spawn("comm", world, str(root), **inputs))
        return _RESULTS[world]
    return run


def _jax_allreduce(stats, world, dtype):
    mesh = _mesh(world)
    fc = jcomm.FactorComm(mesh=mesh, comm_dtype=dtype, comm_freq=1, max_bucket_elems=CAP)

    @partial(compat.shard_map, mesh=mesh, in_specs=(P("data"),), out_specs=P(),
             check_vma=False)
    def run(tree):
        return fc.allreduce(jax.tree_util.tree_map(lambda x: x[0], tree), "data")

    return _np_tree(jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, stats))), fc


@pytest.mark.parametrize("world", [2, 4])
def test_bucketed_mean_matches_per_leaf_and_jax(ranks, world):
    inputs, res = ranks(world)
    stats = inputs["stats"]
    # the ranks hold the same mean, bitwise
    for other in res[1:]:
        for key in ("f32", "bf16", "reference"):
            for a, b in zip(_leaves(res[0]["means"][key]), _leaves(other["means"][key])):
                np.testing.assert_array_equal(a, b)
    m = res[0]["means"]
    exact = jax.tree_util.tree_map(lambda x: x.astype(np.float64).mean(0), stats)
    ulp = 2.0 ** -23
    if world == 2:
        for key in ("f32", "f32_one_bucket"):
            for a, b in zip(_leaves(m[key]), _leaves(m["reference"])):
                np.testing.assert_array_equal(a, b)
    else:
        _close(m["f32"], m["reference"], ulp)
        _close(m["f32_one_bucket"], m["reference"], ulp)
    _close(m["f32"], exact, ulp)
    want, jfc = _jax_allreduce(stats, world, jnp.float32)
    _close(m["f32"], want, ulp)
    sizes = [b.size for b in jplan([s.shape[1:] for s in _leaves(stats)], CAP)]
    assert m["f32_wire"] == (4 * sum(sizes), len(sizes)) == (jfc.last_wire_bytes,
                                                             jfc.last_collectives)
    assert len(sizes) >= 4 and m["f32_one_bucket_wire"][1] == 1
    # the bf16 wire: one rounding per rank, half the bytes
    for g, w in zip(_leaves(m["bf16"]), _leaves(m["f32"])):
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-3 * float(np.abs(w).max()))
    want_bf16, jfc16 = _jax_allreduce(stats, world, jnp.bfloat16)
    for g, w in zip(_leaves(m["bf16"]), _leaves(want_bf16)):
        # two ranks: one sum, so at most a bfloat16 ulp apart; four: the
        # backends round partial sums in their own orders, each rounding
        # within half an ulp of a partial sum, bounded by the leaf's largest
        floor = 0.0 if world == 2 else 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=floor + 1e-30)
    assert m["bf16_wire"] == (2 * sum(sizes), len(sizes)) == (jfc16.last_wire_bytes,
                                                              jfc16.last_collectives)


@pytest.mark.parametrize("world", [2, 4])
def test_int8_merge_matches_jax_on_its_draws(ranks, world):
    inputs, res = ranks(world)
    stats, quant = inputs["stats"], inputs["quant"]
    mesh = _mesh(world)
    fc = jcomm.FactorComm(mesh=mesh, comm_dtype=jnp.int8, comm_freq=2, max_bucket_elems=CAP)

    @partial(compat.shard_map, mesh=mesh, in_specs=(P("data"), P("data"), P()),
             out_specs=(P("data"), P("data")), check_vma=False)
    def run(tree, err, step):
        local = jax.tree_util.tree_map(lambda x: x[0], (tree, err))
        merged, new_err = fc._merge_quantized(*local, step)
        return jax.tree_util.tree_map(lambda x: x[None], (merged, new_err))

    jtree = jax.tree_util.tree_map(jnp.asarray, (stats, quant["wire_error"]))
    merged, new_err = _np_tree(jax.jit(run)(*jtree, jnp.int32(QUANT_STEP)))
    plan = jplan([s.shape[1:] for s in _leaves(stats)], CAP)
    sizes = [b.size for b in plan]
    for r, out in enumerate(res):
        m = out["means"]
        _close(m["int8"], jax.tree_util.tree_map(lambda x: x[r], merged), 1e-6)
        # the residual is payload − codes·scale: XLA fuses it into one
        # multiply-add where torch rounds the product first, so the two
        # part by an ulp of the bucket's payload, not of the residual
        bufs = jcomm.flatten_buckets([jnp.asarray(x[r]) for x in _leaves(stats)], plan)
        for i, buf in enumerate(bufs):
            payload = np.asarray(buf) + quant["wire_error"][f"b{i}"][r]
            np.testing.assert_allclose(m["int8_error"][f"b{i}"], np.asarray(new_err[f"b{i}"][r]),
                                       rtol=0, atol=1e-6 * float(np.abs(payload).max()))
        assert m["int8_wire"] == (comm.quant_wire_bytes(sizes), len(sizes)) \
            == (fc.last_wire_bytes, fc.last_collectives)
        residuals_kept, leaves_kept = m["int8_in_place"]
        assert residuals_kept and all(leaves_kept[b.entries[0].index]
                                      for b in plan if len(b.entries) == 1)
    # the merge is the same on every rank; each keeps its own residual
    for a, b in zip(_leaves(res[0]["means"]["int8"]), _leaves(res[-1]["means"]["int8"])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(res[0]["means"]["int8_error"]["b0"],
                              res[-1]["means"]["int8_error"]["b0"])


def test_deferred_flush_matches_per_step_reduction(ranks):
    _, res = ranks(2)
    for r, out in enumerate(res):
        d = out["deferred"]
        per, dfr = d["per_step"], d["deferred"]
        assert ["flush_factors" in f for f in per["flags"]] == [False] * 6
        assert [f["flush_factors"] for f in dfr["flags"]] == [True, False, False] * 2
        assert dfr["ages"] == [0, 1, 2, 0, 1, 2]
        for step in range(6):
            _close(dfr["updates"][step], per["updates"][step], 1e-6, 1e-7)
            if dfr["flags"][step]["flush_factors"]:
                for g, w in zip(_leaves(dfr["factors"][step]), _leaves(per["factors"][step])):
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # between flushes each rank keeps its own running averages
    f0, f1 = (out["deferred"]["deferred"]["factors"] for out in res)
    for step in range(6):
        same = all(np.array_equal(a, b) for a, b in zip(_leaves(f0[step]), _leaves(f1[step])))
        assert same == (step % 3 == 0), step


def test_update_refusals_match_jax(ranks):
    _, res = ranks(2)
    mesh = _mesh(2)

    def msg(fn):
        with pytest.raises(ValueError) as info:
            fn()
        return str(info.value)

    want = {
        "flush_without_defer": msg(lambda: JKFAC(damping=0.01).update(
            {}, {}, lr=jnp.float32(0.1), update_factors=False, update_eigen=False,
            flush_factors=True)),
        "refresh_without_flush": msg(lambda: JKFAC(damping=0.01, mesh=mesh,
                                                   factor_comm_freq=2).update(
            {}, {}, lr=jnp.float32(0.1), update_factors=True, update_eigen=True)),
        "chunk0_without_flush": msg(lambda: JKFAC(damping=0.01, mesh=mesh, factor_comm_freq=2,
                                                  eigh_chunks=2, kfac_update_freq=4).update(
            {}, {}, lr=jnp.float32(0.1), update_factors=True, update_eigen=False,
            eigen_chunk=(0, 2))),
    }
    for out in res:
        assert out["deferred"]["refusals"] == want
    # int8 needs the deferred flush: the same refusal as the JAX constructor's
    got = msg(lambda: KFAC(device="cpu", factor_comm_dtype="int8", factor_comm_freq=1))
    assert got == msg(lambda: JKFAC(factor_comm_dtype="int8", factor_comm_freq=1))
    for kw in ({"factor_comm_dtype": "fp8"}, {"factor_comm_freq": 0}):
        assert msg(lambda: KFAC(device="cpu", **kw)) == msg(lambda: JKFAC(**kw))


def test_capture_step_collectives_equal_buckets(ranks):
    """The port's counterpart of ``scripts/check_collective_count.py``: a
    capture step issues one factor ``all_reduce`` per bucket and a plain
    step none; deferred, a capture step issues none and a flush step one
    per bucket of the running averages."""
    _, res = ranks(2)
    for out in res:
        c = out["deferred"]["collectives"]
        assert c["capture"][0] == c["capture"][1] >= 3
        assert c["plain"][0] == 0 and c["deferred_capture"][0] == 0
        assert c["deferred_flush"][0] == c["deferred_flush"][1] >= 3


def test_int8_state_checkpoint_round_trip(ranks):
    """A mid-interval int8 state: rank 0 writes its own running averages and
    residuals, and every rank restores rank 0's, as the JAX trainers'
    process-0 checkpoint of a replicated-annotated state does."""
    _, res = ranks(2)
    saved = res[0]["deferred"]["int8_state"]
    assert saved["factor_sync_age"] == 1 and set(saved["wire_error"]) == {"b0"}
    for out in res:
        assert out["deferred"]["int8_restored_step"] == 4
        for a, b in zip(_leaves(out["deferred"]["int8_restored"]), _leaves(saved)):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(res[1]["deferred"]["int8_state"]["wire_error"]["b0"],
                              saved["wire_error"]["b0"])



def test_int8_flush_without_capture_keeps_input_state(ranks):
    """The int8 merge writes into the leaves it is given: on a flush step
    with no capture the leaves are the input state's, so KFAC merges
    copies; the merged factors are the same on both ranks."""
    _, res = ranks(2)
    for out in res:
        kept, after, _ = out["deferred"]["int8_flush_only"]
        for a, b in zip(_leaves(kept), _leaves(after)):
            np.testing.assert_array_equal(a, b)
    merged = [_leaves(out["deferred"]["int8_flush_only"][2]) for out in res]
    for a, b in zip(*merged):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(
        _leaves(res[0]["deferred"]["int8_flush_only"][0]), merged[0]))


# ------------------------------------------------------------- cadences


def _stub(comm_freq, chunks=1, kfac_update_freq=6, fac_update_freq=1, staleness_budget=0,
          solver="eigh"):
    return types.SimpleNamespace(
        hparams=types.SimpleNamespace(fac_update_freq=fac_update_freq,
                                      kfac_update_freq=kfac_update_freq),
        diag_warmup=0, eigh_chunks=chunks, staleness_budget=staleness_budget,
        staleness_signal=None, solver=solver, solver_rank=128, stream_drift_signal=None,
        stream_drift_threshold=0.05, service_devices=0,
        # a two-rank plane (only its flush policy is read: no collective)
        factor_comm=comm.FactorComm(World(size=2, distributed=True), "f32", comm_freq),
    )


CADENCE_GRID = [
    dict(comm_freq=f, chunks=c, fac_update_freq=u, staleness_budget=b, solver=s)
    for f in (2, 3) for u in (1, 2)
    for c, b, s in ((1, 0, "eigh"), (3, 0, "eigh"), (3, 2, "eigh"), (1, 2, "eigh"),
                    (1, 0, "streaming"))
]


@pytest.mark.parametrize("cfg", CADENCE_GRID, ids=lambda c: "-".join(map(str, c.values())))
def test_cadence_flush_flags_match_jax(cfg):
    stub = _stub(**cfg)
    jc, tc = JCadence(stub), EigenRefreshCadence(stub)
    drift = iter([0.1, 0.01] * 40)
    for step in range(60):
        # pressure on for a few steps at a time: slips, then catch-ups
        stub.staleness_signal = (lambda: 2.0) if (step // 4) % 2 else (lambda: 0.0)
        if cfg["solver"] == "streaming":
            value = next(drift)
            stub.stream_drift_signal = lambda value=value: value
        jf, tf = jc.flags_for_step(step), tc.flags_for_step(step)
        assert tf == jf, step
        assert tc.state_dict() == jc.state_dict(), step
        assert "flush_factors" in tf
        assert jflags(step, stub) == kfac_flags_for_step(step, stub)
    assert tc._since_flush == jc._since_flush


def test_step_kind_names_a_flush():
    assert step_kind({"update_factors": True, "update_eigen": False,
                      "flush_factors": True}) == "flush"
    assert step_kind({"update_factors": True, "update_eigen": True,
                      "flush_factors": True}) == "refresh"
    assert step_kind({"update_factors": True, "update_eigen": False,
                      "flush_factors": False}) == "capture"


def test_plane_is_inert_on_one_process(capsys):
    """Without a world (and on NCCL's world of one) the plane issues
    nothing and the levers warn, as in the JAX package without a mesh."""
    kfac = KFAC(device="cpu", factor_comm_dtype="bf16", factor_comm_freq=3)
    assert "have no effect on a world of one rank" in capsys.readouterr().out
    fc = kfac.factor_comm
    assert not (fc.multi_device or fc.defer)
    assert "flush_factors" not in kfac_flags_for_step(0, kfac)
    assert "factor_sync_age" not in kfac.init(workers._tiny_mlp())
    with pytest.raises(ValueError, match="defer"):
        fc.flush({"x": {"A": torch.ones(2, 2), "G": torch.ones(1, 1)}})


# ----------------------------------------------------------------- the slice


def test_lm_slice_on_two_ranks_matches_jax(ranks):
    inputs, res = ranks(2)
    lm = inputs["lm"]
    mesh = _mesh(2)
    jmodel, init, params = _jax_lm()
    jk = JKFAC(layers=jcapture.discover_layers(jmodel, init, train=True), mesh=mesh,
               factor_comm_dtype="bf16", factor_comm_freq=2, **LM_HP)
    jtx = jmake_sgd(LM_MOMENTUM, LM_WD)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                         opt_state=jtx.init(params), kfac_state=jk.init(params))
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True}, grad_clip=LM_CLIP,
                             sgd_hyper=(LM_MOMENTUM, LM_WD), mesh=mesh,
                             grad_comm_dtype=jnp.bfloat16)
    losses = []
    for i, (x, y) in enumerate(lm["batches"]):
        flags = jflags(i, jk)
        for out in res:
            assert out["lm"]["flags"][i] == flags
        jstate, jm = jstep(jstate, put_global_batch(mesh, (x, y)), jnp.float32(LM_LR),
                           jnp.float32(LM_HP["damping"]), **flags)
        losses.append(float(jm["loss"]))
    got = res[0]["lm"]
    assert got["kinds"] == ["refresh", "capture", "refresh", "capture"]
    assert got["ages"] == [0, 1, 0, 1]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert res[1]["lm"]["losses"] == got["losses"]
    want = lm_state_dict_from_jax(_np_tree(jstate.params))
    for key, w in want.items():
        w = w.numpy()
        for out in res:
            np.testing.assert_allclose(out["lm"]["state_dict"][key], w, rtol=0,
                                       atol=1e-4 * float(np.abs(w).max()) + 1e-6, err_msg=key)
    # the factors after a capture step without a flush are each replica's
    # own: device 0's rows are rank 0's; the flush at step 2 rounded the
    # running averages to bfloat16 in both packages
    jf = _np_tree(jstate.kfac_state["factors"])
    for jn, f in jf.items():
        tn = jn.replace("block_", "blocks.").replace("/", ".")
        for side, w in f.items():
            np.testing.assert_allclose(got["factors"][tn][side], w, rtol=0,
                                       atol=2e-4 * float(np.abs(w).max()), err_msg=tn)
    assert got["wire"] == (jk.factor_comm.last_wire_bytes, jk.factor_comm.last_collectives)


def test_lstm_twin_on_two_ranks_matches_one_process(ranks):
    inputs, res = ranks(2)
    lstm = inputs["lstm"]
    one = wikitext_trainer.main(lstm["argv"])
    two = res[0]["lstm"]
    assert two["f32_deferred"]["kind"] == ["refresh", "capture", "flush", "refresh",
                                           "flush", "capture"]
    assert len(one["loss"]) == LSTM_STEPS
    for out in res:
        for name in LSTM_RUNS:
            assert out["lstm"][name]["loss"] == two[name]["loss"]
            assert out["lstm"][name]["val_loss"] == two[name]["val_loss"]
    np.testing.assert_allclose(two["f32_deferred"]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["f32_deferred"]["val_loss"], one["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(two["int8"]["loss"], two["f32_deferred"]["loss"], rtol=1e-2)
    assert all(math.isfinite(v) for v in two["int8"]["loss"])
    # the dropout masks differ per rank and per step over two ranks
    draws = [out["lstm"]["dropout_draws"] for out in res]
    seeds = {d[0] for rank in draws for d in rank}
    assert len(seeds) == 4 and draws[0][0][1] != draws[1][0][1]


def test_cifar_twin_takes_the_factor_comm_flags_on_two_ranks(ranks):
    _, res = ranks(2)
    h0, h1 = (out["cifar"] for out in res)
    assert h0["kind"] == ["refresh", "capture", "refresh"]
    assert h0["loss"] == h1["loss"] and all(math.isfinite(v) for v in h0["loss"])


def test_lm_step_keeps_the_callers_generator_on_one_process():
    """At world one the dropout masks come from the caller's generator
    itself, so one-process runs stay as they were, bitwise."""
    from kfac_pytorch_tpu_torch.models import wikitext_rnn
    from kfac_pytorch_tpu_torch.training.lm_step import init_carry, make_lm_train_step
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd

    model = wikitext_rnn.get_model("LSTM", 12, 4, 4, 1, 0.5, False)
    seen = []
    forward = model.forward

    def recording(tokens, carry, gen=None):
        seen.append(gen)
        return forward(tokens, carry, gen)

    model.forward = recording
    tx = make_sgd(0.0, 0.0)
    step_fn = make_lm_train_step(model, tx, None, grad_clip=0.25)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())))
    gen = torch.Generator().manual_seed(7)
    x = torch.zeros((2, 3), dtype=torch.int64)
    step_fn(state, (x, x), init_carry(model, 2, "cpu"), gen, 0.1, 0.0)
    assert seen == [gen]
