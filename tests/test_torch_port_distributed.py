"""Data-parallel K-FAC (the reference's distributed algorithm) of the port,
on 2 and 4 gloo ranks on the CPU, against the JAX package on a mesh of
the same size (``tests/conftest.py``'s 8 virtual devices) and against the
port's own one-process results.

The ranks are spawned by ``tests/torch_dist_workers.py`` (a file store
under ``tmp_path``, one torch thread each): one world of 2 ranks (the ops,
the solver ops, the train step and the twins) and one of 4 (the ops and
the solver ops), both started before the module's first test so that
they run while this process runs JAX (the ``multi`` task runs several
tasks in one spawn); the tests read their results.

* The assignment plans (``layer_assignment``, ``precondition_assignment``)
  equal the JAX package's for a sweep of names, worlds, ``diag_blocks`` and
  ``distribute_layer_factors``.
* The sharded refresh: every rank holds the same result, and its
  reconstructed factors ``Q diag(d) Qᵀ`` agree with the JAX package's
  ``sharded_eigen_update`` and with the port's replicated refresh to 1e-5
  of the largest entry (eigenvectors have sign and order freedom, so they
  are compared only through what they produce).
* The distributed apply equals ``precondition_all`` (and the inverse
  method's ``precondition_all_inv``) to 1e-6 of the largest entry, in the
  replicated path's emission order (the KL clip's summation order). With
  the exchange in bfloat16 each update element is rounded once on its
  owner: within 2⁻⁸ relative of the float32 update, and within 2⁻⁷
  relative (a bfloat16 ulp: the two float32 values may round to
  neighbours) plus 1e-7 of the JAX package's ``comm_dtype=jnp.bfloat16``.
* One ResNet-8 K-FAC train step on 2 ranks against the JAX step on a
  2-device mesh fed the ranks' batches concatenated in rank order: the
  default route (BatchNorm over the global batch, the sharded refresh and
  the distributed apply) to 1e-5, and the ``grad_comm_dtype=bf16`` route
  (per-rank BatchNorm, the gradient mean in bfloat16) to its bound below.
* The CIFAR and ImageNet twins on 2 ranks with ``--num-workers 2`` on
  written data: every rank ends with the same parameters and only rank 0
  writes checkpoints and logs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.ops import precondition as jprecond
from kfac_pytorch_tpu.parallel import assignment as jassign
from kfac_pytorch_tpu.parallel.mesh import put_global_batch
from kfac_pytorch_tpu.parallel.sharded_eigh import sharded_eigen_update as jsharded
from kfac_pytorch_tpu.training.step import TrainState as JTrainState
from kfac_pytorch_tpu.training.step import make_sgd as jmake_sgd
from kfac_pytorch_tpu.training.step import make_train_step as jmake_train_step
from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.interop import state_dict_from_jax
from kfac_pytorch_tpu_torch.parallel import assignment, launch
from kfac_pytorch_tpu_torch.parallel.mesh import (
    World,
    data_axis_size,
    data_parallel_world,
    local_rows,
    put_global_batch as tput_global_batch,
)
from tests import torch_dist_workers as workers
from tests.test_torch_port_data import write_cifar
from tests.test_torch_port_imagenet_data import _write_shards
from tests.test_torch_port_train import HP, LR, MOMENTUM, WD, _np_tree, step_models


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def _spd(r, n):
    m = r.randn(n + 3, n)
    return (m.T @ m / (n + 3) + 0.05 * np.eye(n)).astype(np.float32)


# layer -> (A side (None: a diagonal-A embedding of vocab 7), G side, conv)
LAYERS = {"c1": (9, 6, True), "c2": (9, 6, True), "c3": (18, 4, True),
          "fc": (5, 3, False), "emb": (None, 4, False)}
DIAG_BLOCKS, DAMPING = 2, 0.003


def _ops_inputs():
    r = np.random.RandomState(120)
    factors, gmats, eigen, inv = {}, {}, {}, {}
    for n, (a, g, _) in LAYERS.items():
        G = _spd(r, g)
        dg, qg = np.linalg.eigh(G.astype(np.float64))
        if a is None:
            d_a = np.abs(r.randn(7)).astype(np.float32)
            factors[n] = {"A_diag": d_a, "G": G}
            gmats[n] = r.randn(g, 7).astype(np.float32)
            eigen[n] = {"dA": d_a, "QG": qg.astype(np.float32), "dG": dg.astype(np.float32)}
            inv[n] = {"iA_diag": (1 / (d_a + 0.1)).astype(np.float32),
                      "iG": np.linalg.inv(G + 0.1 * np.eye(g)).astype(np.float32)}
            continue
        A = _spd(r, a)
        da, qa = np.linalg.eigh(A.astype(np.float64))
        factors[n] = {"A": A, "G": G}
        gmats[n] = r.randn(g, a).astype(np.float32)
        eigen[n] = {"QA": qa.astype(np.float32), "dA": da.astype(np.float32),
                    "QG": qg.astype(np.float32), "dG": dg.astype(np.float32)}
        inv[n] = {"iA": np.linalg.inv(A + 0.1 * np.eye(a)).astype(np.float32),
                  "iG": np.linalg.inv(G + 0.1 * np.eye(g)).astype(np.float32)}
    return dict(factors=factors, is_conv={n: v[2] for n, v in LAYERS.items()},
                diag_blocks=DIAG_BLOCKS, dlf=None, gmats=gmats, eigen=eigen, inv=inv,
                damping=DAMPING)


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Both worlds, started before the module's first test, their parts in
    the order the tests read them; each part read as soon as its ranks are
    done with it, and both worlds joined at the module's end. ``{world:
    (inputs, handle)}``."""
    root = tmp_path_factory.mktemp("spawned")
    write_cifar(str(root / "cifar"), 8, 7)
    _write_shards(str(root / "shards"), 122, 8, 5, 40, 48)
    ops, solver = _ops_inputs(), _solver_inputs()
    step_in, step_kw = _step_inputs()
    twin_kw = dict(cifar_dir=str(root / "cifar"), shard_dir=str(root / "shards"),
                   out_dir=str(root / "out"))
    out = {
        2: ({"ops": ops, "solver": solver, "steps": step_in, "twins": root / "out"},
            workers.start("multi", 2, str(root / "two"), out_dir=str(root / "two"), parts={
                "ops": ("ops", ops), "steps": ("steps", step_kw),
                "twins": ("twins", twin_kw), "solver": ("solver_ops", solver)})),
        4: ({"ops": ops, "solver": solver},
            workers.start("multi", 4, str(root / "four"), out_dir=str(root / "four"), parts={
                "ops": ("ops", ops), "solver": ("solver_ops", solver)})),
    }
    yield out
    for _, handle in out.values():
        workers.join(handle)


def _part(spawned, world, part):
    """``(inputs, per-rank results)`` of one part of ``world``'s spawn."""
    inputs, handle = spawned[world]
    return inputs[part], workers.part(handle, part)


@pytest.fixture(scope="module")
def ops_results(spawned):
    return lambda world: _part(spawned, world, "ops")


def _reconstruct(eigen):
    out = {}
    for n, e in eigen.items():
        for side in ("A", "G"):
            if f"Q{side}" in e:
                q, d = np.asarray(e[f"Q{side}"], np.float64), np.asarray(e[f"d{side}"], np.float64)
                out[(n, side)] = (q * d) @ q.T
    return out


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_assignment_plans_equal_jax(world):
    for names in (["a"], list("abcdef"), [f"l{i}" for i in range(13)]):
        is_conv = {n: i % 3 != 2 for i, n in enumerate(names)}
        for blocks in (1, 2, 3):
            for dlf in (None, False, True):
                assert assignment.layer_assignment(names, is_conv, world, dlf, blocks) == \
                    jassign.layer_assignment(names, is_conv, world, dlf, blocks)
        r = np.random.RandomState(len(names) + world)
        shapes = {n: tuple(int(v) for v in r.randint(1, 9, size=2)) for n in names}
        for diag_a in (None, {names[0]}):
            assert assignment.precondition_assignment(shapes, world, diag_a) == \
                jassign.precondition_assignment(shapes, world, diag_a)
    rr = assignment.RoundRobin(world)
    assert [rr.next(3) for _ in range(3)] == [(i % world, (i + 1) % world, (i + 2) % world)
                                              for i in (0, 3, 6)]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_refresh_matches_jax_and_replicated(ops_results, world):
    inputs, ranks = ops_results(world)
    for key in ("sharded", "sharded_bf16q"):
        for other in ranks[1:]:  # every slot has one owner: the sum is exact
            for n, e in ranks[0][key].items():
                for k, v in e.items():
                    np.testing.assert_array_equal(other[key][n][k], v)
    names = list(LAYERS)
    table = jassign.layer_assignment(names, inputs["is_conv"], world, None, DIAG_BLOCKS)
    jfacs = {n: {k: jnp.asarray(v) for k, v in f.items()} for n, f in inputs["factors"].items()}
    mesh = _mesh(world)
    want = _reconstruct(jax.device_get(jax.jit(lambda f: jsharded(f, table, mesh))(jfacs)))
    got = _reconstruct(ranks[0]["sharded"])
    rep = _reconstruct(ranks[0]["replicated"])
    assert set(got) == set(want) == set(rep) and len(got) == 9
    for key, w in want.items():
        _close(got[key], w, 1e-5)
        _close(got[key], rep[key], 1e-5)
    # the blocked factors really are block-diagonal: the c3 A side's blocks of 9
    assert np.all(got[("c3", "A")][:9, 9:] == 0)
    # Q in bfloat16: the exchange moves the rounded vectors, bitwise those of
    # the float32 refresh rounded once
    for n, e in ranks[0]["sharded"].items():
        for side in ("A", "G"):
            if f"Q{side}" in e:
                q32 = torch.from_numpy(e[f"Q{side}"]).to(torch.bfloat16).float().numpy()
                np.testing.assert_array_equal(ranks[0]["sharded_bf16q"][n][f"Q{side}"], q32)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_apply_matches_replicated(ops_results, world):
    _, ranks = ops_results(world)
    owners = ranks[0]["owners"]
    assert set(owners.values()) == set(range(min(world, len(LAYERS))))
    for res in ranks:
        assert res["apply_order"] == res["replicated_order"]
        for n, want in res["replicated_apply"].items():
            for kind in ("auto", "dense"):
                _close(res[f"apply_{kind}"][n], want, 1e-6)
            # one rounding to bfloat16 on the owner, nothing else
            np.testing.assert_allclose(res["apply_bf16"][n], want, rtol=2.0 ** -8, atol=1e-30)
            np.testing.assert_array_equal(res["apply_bf16"][n], ranks[0]["apply_bf16"][n])
        for n, want in res["inv_replicated"].items():
            _close(res["inv_apply"][n], want, 1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_apply_bf16_wire_matches_jax(ops_results, world):
    inputs, ranks = ops_results(world)
    j = {n: {k: jnp.asarray(v) for k, v in e.items()} for n, e in inputs["eigen"].items()}
    g = {n: jnp.asarray(v) for n, v in inputs["gmats"].items()}
    owners = jassign.precondition_assignment(
        {n: tuple(v.shape) for n, v in g.items()}, world, diag_a={"emb"})
    assert owners == ranks[0]["owners"]
    want = jax.device_get(jprecond.precondition_all_distributed(
        g, j, jnp.float32(DAMPING), mesh=_mesh(world), owners=owners,
        comm_dtype=jnp.bfloat16))
    for n, w in want.items():
        np.testing.assert_allclose(ranks[0]["apply_bf16"][n], np.asarray(w), rtol=2.0 ** -7,
                                   atol=1e-7)


# -------------------------------------------------------------- train steps

STEP_BATCH = 4  # per rank
ROUTES = {
    "global": dict(port=dict(distribute_precondition=True),
                   jax_kfac=dict(distribute_precondition=True), jax_step={}),
    "bf16": dict(port=dict(grad_comm_dtype=torch.bfloat16), jax_kfac={},
                 jax_step=dict(grad_comm_dtype=jnp.bfloat16)),
}


def _step_inputs():
    """The train step's batches (for the JAX side) and the ranks' inputs."""
    _, _, _, _, model = step_models(0)
    r = np.random.RandomState(121)
    images = r.randn(2 * STEP_BATCH, 8, 8, 3).astype(np.float32)
    labels = r.randint(0, 10, size=2 * STEP_BATCH).astype(np.int32)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    hp = dict(lr=LR, momentum=MOMENTUM, wd=WD,
              kfac={k: v for k, v in HP.items() if k != "lr"})
    return (images, labels), dict(
        state_dict=sd, layers=capture.discover_layers(model), hp=hp, images=images,
        labels=labels, routes={k: v["port"] for k, v in ROUTES.items()})


@pytest.fixture(scope="module")
def step_results(spawned):
    (images, labels), ranks = _part(spawned, 2, "steps")
    return images, labels, ranks


_JAX_LAYER = {"KFACConv_0": "conv1", "KFACDense_0": "linear",
              **{f"BasicBlock_{i}/KFACConv_{j}": f"layer{i + 1}.0.conv{j + 1}"
                 for i in range(3) for j in range(2)}}


@pytest.mark.parametrize("route", ["global", "bf16"])
def test_train_step_matches_jax(step_results, route):
    """One step (a capture step with a refresh: step 0) on 2 ranks. Bounds:
    the default route is float32 against float32, 1e-5 relative for the
    loss, 1e-5 of the largest entry per tensor (+1e-6). The bf16 route
    rounds each rank's gradients to bfloat16 before the mean in both
    packages; a float32 difference of one rounding can land a gradient
    element on the neighbouring bfloat16 value (2⁻⁸ relative), and the
    preconditioned step spreads that over the layer: parameters within 1e-4
    of the largest entry (+1e-6); the loss and the factors, which the
    compression does not touch, keep 1e-5."""
    images, labels, ranks = step_results
    # fresh JAX weights: the JAX step donates its state
    jmodel, init, params, stats, _ = step_models(0)
    mesh = _mesh(2)
    cfg = ROUTES[route]
    layers = jcapture.discover_layers(jmodel, init, train=True)
    jk = JKFAC(layers=layers, mesh=mesh, **HP, **cfg["jax_kfac"])
    jtx = jmake_sgd(MOMENTUM, WD)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=jtx.init(params), kfac_state=jk.init(params))
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    jstep = jmake_train_step(jmodel, jtx, jk, train_kwargs={"train": True},
                             sgd_hyper=(MOMENTUM, WD),
                             mesh=mesh if cfg["jax_step"] else None, **cfg["jax_step"])
    jstate, jm = jstep(jstate, put_global_batch(mesh, (images, labels)), jnp.float32(LR),
                       jnp.float32(HP["damping"]), update_factors=True, update_eigen=True)
    want = state_dict_from_jax(_np_tree(jstate.params), _np_tree(jstate.batch_stats), "resnet8")
    param_rel = 1e-5 if route == "global" else 1e-4
    for loss, sd, factors in (res[route] for res in ranks):
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            w = w.numpy()
            np.testing.assert_allclose(sd[key], w, rtol=0,
                                       atol=param_rel * float(np.abs(w).max()) + 1e-6,
                                       err_msg=key)
        jf = _np_tree(jstate.kfac_state["factors"])
        for jn, tn in _JAX_LAYER.items():
            for side in ("A", "G"):
                w = jf[jn][side]
                np.testing.assert_allclose(factors[tn][side], w, rtol=0,
                                           atol=1e-5 * float(np.abs(w).max()), err_msg=tn)
    for key in ranks[0][route][1]:  # the ranks agree bitwise
        np.testing.assert_array_equal(ranks[0][route][1][key], ranks[1][route][1][key])


# -------------------------------------------------------------------- twins


@pytest.fixture(scope="module")
def twin_results(spawned):
    return _part(spawned, 2, "twins")


@pytest.mark.parametrize("twin", ["cifar", "imagenet"])
def test_twins_on_two_ranks(twin_results, twin):
    out, ranks = twin_results
    (h0, sd0, saves0), (h1, sd1, saves1) = ranks[0][twin], ranks[1][twin]
    steps = 5 if twin == "cifar" else 2  # 40 / (2·4) and 8 / (2·2)
    assert len(h0["loss"]) == len(h1["loss"]) == steps
    assert h0["loss"] == h1["loss"]  # the loss is the mean over the ranks
    assert h0["val_count"] == h1["val_count"] == [7.0 if twin == "cifar" else 5.0]
    for key, v in sd0.items():
        np.testing.assert_array_equal(sd1[key], v, err_msg=key)
    assert saves1 == [] and len(saves0) == 1 and saves0[0].endswith("checkpoint-0.tmp")
    assert sorted(os.listdir(out / f"{twin}-ck")) == ["checkpoint-0"]
    if twin == "cifar":
        lines = [json.loads(s) for s in open(out / "cifar-logs" / "scalars.jsonl")]
        assert sorted(x["tag"] for x in lines) == [
            "train/accuracy", "train/loss", "train/lr", "val/accuracy", "val/loss"]


def test_one_process_is_a_world_of_one(monkeypatch):
    """Without a launcher ``launch`` joins nothing and answers for a world
    of one; ``World()`` collectives are identities; ``local_rows`` is the
    rank's contiguous slice of the concatenated global batch."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (launch.rank(), launch.size(), launch.local_rank(), launch.is_primary()) == (0, 1, 0, True)
    assert launch.host_min(3) == 3 and launch.broadcast_host_value(5) == 5
    launch.barrier()
    w = data_parallel_world()
    assert w == World() and not w.distributed and data_axis_size(w) == 1
    x, y = tput_global_batch((np.zeros((4, 3, 2, 2), np.float32), np.arange(4)), "cpu", 2)
    assert x.shape == (2, 2, 3, 2, 2) and y.tolist() == [[0, 1], [2, 3]]
    t = torch.arange(3.0)
    w.all_reduce_mean_([t])
    w.broadcast_([t])
    assert torch.equal(w.all_reduce_sum_(t), torch.arange(3.0)) and w.sum_with_grad(t) is t
    assert local_rows(8, World(size=2, rank=1)) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        local_rows(7, World(size=2, rank=0))


# ------------------------------------------------------- truncated solvers
#
# The rank-aware refresh (``rank_fn``) and the pipelined refresh's chunks
# over 2 and 4 ranks, on the JAX package's sketch: every rank holds the
# same result (each slot has one owner, so the exchange is exact); the
# truncated entries equal the port's replicated refresh bitwise (each
# block's randomized solve is its own, whatever shares its stack); and the
# reconstructions ``Q diag(d) Qᵀ + rho (I − Q Qᵀ)`` agree with the port's
# replicated refresh and with the JAX package's on its 8-device mesh to
# 1e-5 of the largest entry. Then ``KFAC.update`` through a cadence with
# ``eigh_chunks=2`` and ``solver="rsvd"`` on the ranks against one process,
# the preconditioned gradients to 1e-4 of the largest (the damped solve
# amplifies the rounding of the differently batched solves by up to 1/λ).

# layer -> (A side, G side); threshold 20 and rank 4 truncate the A sides
# of the stacked pair (G dense), both sides of "l2", neither of "l3"
SOLVER_LAYERS = {"l0": (40, 12), "l1": (40, 12), "l2": (24, 20), "l3": (13, 16)}
SOLVER_RANK_CFG, SOLVER_CHUNKS = (20, 4), 3
SOLVER_KFAC = dict(eigh_chunks=2, solver="rsvd", solver_rank=4, solver_auto_threshold=20,
                   kfac_update_freq=3, fac_update_freq=1, factor_decay=0.5)


def _gapped_spd(r, n):
    u, _ = np.linalg.qr(r.randn(n, n))
    return ((u * (10.0 * 0.8 ** np.arange(n))) @ u.T).astype(np.float32)


def _solver_inputs():
    from kfac_pytorch_tpu.ops.rsvd import sketch_matrix as jsketch

    r = np.random.RandomState(130)
    factors = {n: {"A": _gapped_spd(r, a), "G": _gapped_spd(r, g)}
               for n, (a, g) in SOLVER_LAYERS.items()}
    stats = [tuple({n: _gapped_spd(r, SOLVER_LAYERS[n][i]) for n in SOLVER_LAYERS}
                   for i in (0, 1)) for _ in range(7)]
    grads = {}
    for n, (a, g) in SOLVER_LAYERS.items():
        grads[f"{n}.weight"] = r.randn(g, a - 1).astype(np.float32)
        grads[f"{n}.bias"] = r.randn(g).astype(np.float32)
    net = {n: ("dense", (a - 1, g)) for n, (a, g) in SOLVER_LAYERS.items()}
    return dict(
        factors=factors, is_conv={n: False for n in SOLVER_LAYERS}, rank_cfg=SOLVER_RANK_CFG,
        chunks=SOLVER_CHUNKS, sketches={"128x12": np.array(jsketch(128, 12))},
        kfac_run=dict(net=net, stats=stats, grads=grads, kwargs=SOLVER_KFAC, steps=7),
    )


@pytest.fixture(scope="module")
def solver_results(spawned):
    return lambda world: _part(spawned, world, "solver")


@pytest.fixture(scope="module")
def solver_jax(spawned):
    """The JAX package's sharded refresh and chunked pass on its 8-device
    mesh, once for both worlds (their inputs are the same): ``{solver:
    (want, want_chunked)}`` as reconstructions."""
    from kfac_pytorch_tpu.parallel.sharded_eigh import build_slots as jbuild_slots
    from kfac_pytorch_tpu.parallel.sharded_eigh import replicated_eigen_update as jreplicated
    from kfac_pytorch_tpu.parallel.sharded_eigh import sharded_eigen_chunk_update as jchunk

    inputs = spawned[2][0]["solver"]
    names = list(SOLVER_LAYERS)
    jfacs = {n: {k: jnp.asarray(v) for k, v in f.items()} for n, f in inputs["factors"].items()}
    mesh = _mesh(8)
    table = jassign.layer_assignment(names, inputs["is_conv"], 8, None, 1)
    out = {}
    for key, fn in (("rsvd", _rank_fn), ("dense", None)):
        want = _reconstruct_lr(jax.device_get(
            jax.jit(lambda f, fn=fn: jsharded(f, table, mesh, rank_fn=fn))(jfacs)))
        slots = jbuild_slots(jfacs, table)
        plan = jassign.plan_eigh_chunks(slots, SOLVER_CHUNKS, rank_fn=fn)
        pending = jax.tree_util.tree_map(
            jnp.zeros_like, jreplicated(jfacs, {n: 1 for n in names}, rank_fn=fn))
        for c in range(SOLVER_CHUNKS):
            part = [slots[i] for i in plan[c]]
            pending = jax.jit(lambda f, p, part=part, fn=fn: jchunk(
                f, p, part, mesh, rank_fn=fn))(jfacs, pending)
        out[key] = want, _reconstruct_lr(jax.device_get(pending))
    return out


def _reconstruct_lr(eigen):
    out = {}
    for n, e in eigen.items():
        for side in ("A", "G"):
            q = np.asarray(e[f"Q{side}"], np.float64)
            f = (q * np.asarray(e[f"d{side}"], np.float64)) @ q.T
            if f"rho{side}" in e:
                f += float(e[f"rho{side}"]) * (np.eye(q.shape[0]) - q @ q.T)
            out[(n, side)] = f
    return out


def _rank_fn(n):
    threshold, r = SOLVER_RANK_CFG
    return None if n < threshold or r >= n else r


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_rank_aware_and_chunked_refresh_match_jax(solver_results, solver_jax, world):
    _, ranks = solver_results(world)
    for other in ranks[1:]:
        for key in ranks[0]:
            if key.startswith(("sharded", "chunked_sharded")):
                for n, e in ranks[0][key].items():
                    for k, v in e.items():
                        np.testing.assert_array_equal(other[key][n][k], v)
    for key in ("rsvd", "dense"):
        want, want_chunked = solver_jax[key]
        rep = _reconstruct_lr(ranks[0][f"replicated_{key}"])
        for got_key in (f"sharded_{key}", f"chunked_sharded_{key}", f"chunked_replicated_{key}"):
            got = _reconstruct_lr(ranks[0][got_key])
            assert set(got) == set(want) == set(rep) and len(got) == 8
            for k, w in want.items():
                _close(got[k], w, 1e-5)
                _close(got[k], want_chunked[k], 1e-5)
                _close(got[k], rep[k], 1e-5)
        if key == "rsvd":
            for got_key in ("sharded_rsvd", "chunked_sharded_rsvd", "chunked_replicated_rsvd"):
                for n, e in ranks[0]["replicated_rsvd"].items():
                    for k in (k for k in e if k.startswith("rho")):
                        side = k[3:]
                        for part in (f"Q{side}", f"d{side}", k):
                            np.testing.assert_array_equal(ranks[0][got_key][n][part], e[part])
            e = ranks[0]["sharded_rsvd"]
            assert e["l0"]["QA"].shape == (40, 4) and e["l0"]["QG"].shape == (12, 12)
            assert e["l2"]["QG"].shape == (20, 4) and "rhoA" not in e["l3"]


@pytest.mark.parametrize("world", [2, 4])
def test_kfac_chunked_rsvd_on_ranks_matches_one_process(solver_results, world):
    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
    from kfac_pytorch_tpu_torch.models.layers import KFACDense
    from kfac_pytorch_tpu_torch.ops import rsvd

    inputs, ranks = solver_results(world)
    run = inputs["kfac_run"]
    sketch = rsvd.sketch_matrix
    rsvd.sketch_matrix = lambda m, cols, device=None: torch.from_numpy(
        inputs["sketches"][f"{m}x{cols}"])
    try:
        model = torch.nn.Module()
        for n, (_, args) in run["net"].items():
            model.add_module(n, KFACDense(*args))
        kfac = KFAC(layers=list(run["net"]), device="cpu", **run["kwargs"])
        state, cadence, kinds = kfac.init(model), EigenRefreshCadence(kfac), []
        grads = {k: torch.from_numpy(v) for k, v in run["grads"].items()}
        for step in range(run["steps"]):
            flags = cadence.flags_for_step(step)
            kinds.append("refresh" if flags["update_eigen"] else
                         "swap" if flags.get("swap_eigen") else
                         "chunk" if "eigen_chunk" in flags else "capture")
            a_c, g_s = ({n: torch.from_numpy(v) for n, v in d.items()}
                        for d in run["stats"][step])
            new, state = kfac.update(grads, state, a_contribs=a_c, g_factor_stats=g_s,
                                     lr=0.1, damping=0.003, **flags)
            for other in ranks:
                for k, v in new.items():
                    _close(other["kfac_updates"][step][k], v.numpy(), 1e-4)
    finally:
        rsvd.sketch_matrix = sketch
    assert kinds == ["refresh", "capture", "capture", "chunk", "swap", "capture", "chunk"]
