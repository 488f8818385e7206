"""Sequence parallelism: ring and Ulysses attention and the data×seq world.

Gloo worlds of 2 and 4 ranks (``tests/torch_dist_workers.py``'s
``context`` task, one spawn each) against the JAX package on meshes cut
from ``tests/conftest.py``'s 8 virtual devices:

* ring and Ulysses, causal and not, the whole world one seq group: each
  rank's slice of the output and of dQ/dK/dV (the gradient of
  ``Σ out·dout`` for one random cotangent), put back together, against
  the JAX versions (``shard_map`` over a ``seq`` mesh of as many devices)
  and against ``full_attention``, within the JAX tests' own bounds
  (outputs rtol/atol 1e-5; gradients rtol 1e-4, atol 1e-5);
* the tiny transformer LM (d_model 32, 2 heads, 1 layer, vocab 50, batch
  8, T 16) for 3 K-FAC steps on a 2×2 data×seq world (each rank 4 rows
  and 8 positions, global positions in the position embedding), with ring
  and with Ulysses attention, against the JAX package's 2×4 data×seq ring
  run (``tests/test_transformer_lm.py::test_sequence_parallel_training_matches_full``)
  and against one process with full attention, within that test's
  bounds (loss rtol 1e-4; parameters rtol 2e-3, atol 2e-4);
* the levers that ride one data axis refused on a world with a seq axis,
  with the JAX planner's messages, and ``grad_comm_dtype`` with the JAX
  train step's; the LM twin under ``--seq-parallel 2 --attention ring``
  and ``ulysses`` on 2 ranks, its losses against one process's;
* the data×seq world's layout: rank ``r`` is data slot ``r // sp`` and
  seq slot ``r % sp``, with its rows and its slice of the sequence.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.parallel.context import make_context_parallel_attention as jcp_attention
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
from kfac_pytorch_tpu_torch.interop import lm_state_dict_from_jax
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.parallel.context import full_attention
from kfac_pytorch_tpu_torch.parallel.mesh import World, local_rows, local_seq
from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step
from tests import torch_dist_workers as workers

B, T, H, D = 2, 16, 4, 8
CASES = [(kind, causal) for kind in ("ring", "ulysses") for causal in (True, False)]
VOCAB, LM_KW, LM_BATCH, LM_STEPS = 50, dict(d_model=32, n_heads=2, n_layers=1), 8, 3
TINY = ["--synthetic", "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1",
        "--steps-per-epoch", "3", "--device", "cpu", "--kfac-embedding"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _attn_inputs():
    r = np.random.RandomState(20)
    return {kind: tuple(r.randn(B, T, H, D).astype(np.float32) for _ in range(4))
            for kind in ("ring", "ulysses")}


def _lm_batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, size=(LM_BATCH, T + 1))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def _jax_lm_params():
    """The JAX LM's initial parameters (numpy)."""
    x = jnp.asarray(_lm_batch()[0].astype(np.int32))
    model = jlm.get_model(VOCAB, **LM_KW)
    # jitted: one compile costs less than the eager ops' first dispatches
    return _np_tree(jax.jit(lambda k, v: model.init(k, v, train=True))(
        jax.random.PRNGKey(0), x)["params"])


def _jax_lm_run(init):
    """The JAX package's 2×4 data×seq ring run from the numpy parameters
    ``init``: ``(losses, params after each step)``."""
    devices = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "seq"))
    attn = jcp_attention(mesh, seq_axis="seq", batch_axis="data")
    model = jlm.get_model(VOCAB, attention_fn=attn, **LM_KW)
    x, y = (jnp.asarray(a.astype(np.int32)) for a in _lm_batch())
    params = jax.tree_util.tree_map(jnp.asarray, init)
    kfac = JKFAC(damping=0.01, fac_update_freq=1, kfac_update_freq=1)
    tx = jmake_sgd(momentum=0.9)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params), kfac_state=jax.jit(kfac.init)(params))
    step = jmake_train_step(model, tx, kfac, train_kwargs={"train": True})
    state = jax.device_put(state, NamedSharding(mesh, P()))
    batch = jax.device_put((x, y), NamedSharding(mesh, P("data", "seq")))
    losses, after = [], []
    for i in range(LM_STEPS):
        state, m = step(state, batch, jnp.float32(0.1), jnp.float32(0.01),
                        update_factors=True, update_eigen=i == 0)
        losses.append(float(m["loss"]))
        after.append(lm_state_dict_from_jax(_np_tree(state.params)))
    return losses, after


def _one_process_run(weights):
    """The port on one process with full attention: ``(losses, params)``."""
    model = transformer_lm.get_model(VOCAB, **LM_KW)
    model.load_state_dict(weights)
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", damping=0.01,
                fac_update_freq=1, kfac_update_freq=1)
    tx = make_sgd(0.9, 0.0)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step = make_train_step(model, tx, kfac)
    batch = tuple(torch.from_numpy(a) for a in _lm_batch())
    losses, after = [], []
    for i in range(LM_STEPS):
        state, m = step(state, batch, 0.1, 0.01, update_factors=True, update_eigen=i == 0)
        losses.append(float(m["loss"]))
        after.append({k: v.clone() for k, v in model.state_dict().items()})
    return losses, after


@pytest.fixture(scope="module")
def context_runs(tmp_path_factory):
    """The ranks run while this process runs JAX and the one-process port:
    both spawns start first (the 4-rank LM takes the JAX run's initial
    weights, which the JAX model's init gives without a train step), and
    are joined after."""
    inputs = _attn_inputs()
    attn = {"inputs": inputs, "cases": CASES}
    init = _jax_lm_params()
    weights = lm_state_dict_from_jax(init)
    train = {"vocab": VOCAB, "model": LM_KW, "batch": _lm_batch(), "steps": LM_STEPS,
             "kinds": ("ring", "ulysses"), "weights": {k: v.numpy() for k, v in weights.items()}}
    twin = {kind: [*TINY, "--seq-parallel", "2", "--attention", kind]
            for kind in ("ring", "ulysses")}
    root = tmp_path_factory.mktemp("context")
    started = {
        2: workers.start("context", 2, str(root / "w2"), seq=2, attn=attn, twin=twin),
        4: workers.start("context", 4, str(root / "w4"), seq=2, attn=attn, train=train),
    }
    jlosses, jafter = _jax_lm_run(init)
    one, twin_one = _one_process_run(weights), trainer.main(TINY)["loss"]
    ranks = {n: workers.join(h) for n, h in started.items()}
    return {"ranks": ranks, "inputs": inputs, "jax": (jlosses, jafter),
            "one": one, "twin_one": twin_one}


def _jax_attention(world, kind, causal, q, k, v, do):
    """The JAX version on a ``seq`` mesh of ``world`` devices: the output
    and the gradients of ``Σ out·do``."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    attn = jcp_attention(mesh, seq_axis="seq", batch_axis=None, kind=kind)
    sharded = jax.device_put(tuple(map(jnp.asarray, (q, k, v))),
                             NamedSharding(mesh, P(None, "seq")))
    fn = partial(attn, causal=causal)
    out = jax.jit(fn)(*sharded)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * jnp.asarray(do)),
                             argnums=(0, 1, 2)))(*sharded)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _full_attention(causal, q, k, v, do):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = full_attention(q, k, v, causal=causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind,causal", CASES)
def test_attention_matches_jax_and_full(context_runs, world, kind, causal):
    ranks = context_runs["ranks"][world]
    q, k, v, do = context_runs["inputs"][kind]
    got = {key: np.concatenate([r["attn"][(kind, causal)][key] for r in ranks], axis=1)
           for key in ("out", "dq", "dk", "dv")}
    for want_out, want_grads in (_jax_attention(world, kind, causal, q, k, v, do),
                                 _full_attention(causal, q, k, v, do)):
        np.testing.assert_allclose(got["out"], want_out, rtol=1e-5, atol=1e-5)
        for key, want in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_data_seq_training_matches_jax_and_one_process(context_runs, kind):
    jlosses, jafter = context_runs["jax"]
    one_losses, one_after = context_runs["one"]
    ranks = context_runs["ranks"][4]
    for r in ranks:
        run = r["train"][kind]
        for want in (jlosses, one_losses):
            np.testing.assert_allclose(run["losses"], want, rtol=1e-4)
        for step in range(LM_STEPS):
            for want in (jafter[step], one_after[step]):
                for key, w in want.items():
                    np.testing.assert_allclose(run["params"][step][key], w.numpy(), rtol=2e-3,
                                               atol=2e-4, err_msg=f"{kind} step {step}: {key}")
    for r in ranks[1:]:  # every rank holds the same parameters
        for key, w in ranks[0]["train"][kind]["params"][-1].items():
            np.testing.assert_array_equal(r["train"][kind]["params"][-1][key], w)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_axis_refuses_the_one_data_axis_levers(context_runs, world):
    for r in context_runs["ranks"][world]:
        got = r["refusals"]
        assert "factor_sharding='owner' requires a single data axis" in got["owner"]
        assert "owner_vs_multi_axis_mesh" in got["owner"]
        for key in ("comm_dtype", "comm_freq"):
            assert "comm_vs_multi_axis_mesh" in got[key]
            assert "factor_comm_dtype/factor_comm_freq ride the explicit" in got[key]
        assert "overlap_vs_multi_axis_mesh" in got["overlap"]
        assert "grad_comm_dtype requires a data-plane mesh" in got["grad_comm_dtype"]
        assert "'seq': 2" in got["grad_comm_dtype"]


def test_lm_twin_trains_sequence_parallel_on_two_ranks(context_runs):
    want = context_runs["twin_one"]
    for r in context_runs["ranks"][2]:
        for kind, hist in r["twin"].items():
            assert hist["kind"] == ["refresh", "capture", "capture"]
            np.testing.assert_allclose(hist["loss"], want, rtol=1e-4, err_msg=kind)
            assert len(hist["val_loss"]) == 1 and math.isfinite(hist["val_loss"][0])


@pytest.mark.parametrize("argv,message", [
    (["--seq-parallel", "2", "--factor-sharding", "owner"], "owner_vs_multi_axis_mesh"),
    (["--seq-parallel", "2", "--factor-comm-dtype", "bf16"], "comm_vs_multi_axis_mesh"),
    (["--seq-parallel", "2", "--factor-comm-freq", "2"], "comm_vs_multi_axis_mesh"),
    (["--seq-parallel", "2", "--comm-overlap"], "overlap_vs_multi_axis_mesh"),
    (["--seq-parallel", "2", "--grad-comm-dtype", "bf16"],
     "--grad-comm-dtype requires a pure data-parallel mesh"),
    (["--seq-parallel", "3", "--seq-len", "18"], "--seq-parallel 3 must divide device count 2"),
])
def test_lm_twin_refuses_on_a_seq_axis(argv, message):
    args = trainer.parse_args([*TINY, *argv])
    with pytest.raises(SystemExit, match=message):
        trainer.check_world(args, World(size=2, rank=0, distributed=True))


@pytest.mark.parametrize("argv,message", [
    (["--seq-parallel", "2", "--seq-len", "15"], "--seq-len 15 must be divisible by --seq-parallel 2"),
    (["--seq-parallel", "2", "--tensor-parallel", "2"], "pick one"),
    (["--seq-parallel", "2", "--fsdp", "1"], "does not compose with --seq-parallel"),
])
def test_lm_twin_refuses_seq_compositions(argv, message):
    with pytest.raises(SystemExit, match=message):
        trainer.parse_args([*TINY, *argv])


def test_data_seq_world_layout():
    for rank in range(6):
        w = World(size=6, rank=rank, distributed=True, seq_size=3)
        assert (w.data_slot, w.seq_slot, w.data_size) == (rank // 3, rank % 3, 2)
        assert local_rows(8, w) == slice(4 * (rank // 3), 4 * (rank // 3) + 4)
        assert local_seq(12, w) == slice(4 * (rank % 3), 4 * (rank % 3) + 4)
    with pytest.raises(ValueError, match="must be divisible"):
        local_seq(10, World(size=6, seq_size=3))
    assert local_seq(10, World()) == slice(0, 10)
