"""The 3-D data×fsdp×tensor world against the JAX package's 3-D mesh.

One spawn of 4 gloo ranks (data 1 × fsdp 2 × tensor 2, the ``fsdp`` task
of ``tests/torch_dist_workers.py``), started at module start and joined
after the JAX runs, trains the tiny ``tensor_parallel=2`` LM of
``tests/test_shardwise.py``'s ``_lm_3d_run`` (d_model 16, one layer,
vocab 50, 8 rows, 4 steps, refresh at steps 0 and 2) from the JAX
weights, with the MLP kernels split over the tensor slots (each rank
computing with its shards and keeping its own K-FAC blocks) and the other
parameters over the fsdp slots:

* plain, and composed with ``solver="rsvd"`` on the unsharded layers and
  ``factor_comm_freq=2`` (the JAX sketch injected), against JAX's
  ``data_fsdp_tensor_mesh(2, 2)`` run placed sharded: losses within 1e-5,
  the gathered parameters within ``1e-4·max + 1e-6``; the plain run also
  against the port's one-process lens model at the same global batch;
* the deferred int8 wire (``INT8``, the JAX rounding draws injected): the
  JAX package flushes the tree gathered over the tensor axis, so every
  tensor device quantizes the same payload and holds the same bits of
  every replicated factor; the port's ranks must too, checked on the row
  layer's G (the leaf a per-slot quantization left unequal) and every
  other replicated leaf, after every step. Each rank's factors, a split
  leaf as its tensor slot's blocks of the JAX leaf, lie within two int8
  steps of the largest block scale of the JAX device's (``2·max|F|/127``,
  F the whole tree, which is one bucket): the two packages' buckets hold
  the layers in different orders (flax path against module order), so
  their 256-value blocks take other scales and the factors differ by
  about one step (1.5 at most over the 4 steps);
* the per-rank bytes of every parameter, its momentum and every shard
  layer's factor/eigen leaf against JAX's ``state_bytes_local`` under
  ``lm_param_shardings``/``state_shardings``, and the MLP factor+eigen
  bytes under half the replicated dense model's;
* one clipped capture step's collectives by group: the tensor group sees
  the compute split's two all-reduces per block, ν's and the clip's, and
  nothing of the factor plane, which rides the data×fsdp group;
* a 3-D checkpoint resumed in a one-process lens run and a one-process
  checkpoint resumed on the 4 ranks, the losses against the uninterrupted
  runs'; the diagnostics (ν, the norms, the spectra) against one
  process's;
* the LM twin under ``--fsdp 2 --tensor-parallel 2`` (the JAX mesh line)
  and under ``--fsdp 2 --factor-sharding owner`` against one process at
  the global batch; ``--fsdp 1 --tensor-parallel 1`` on one process bit
  for bit the plain twin's run; the twin's ``--fsdp`` refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu import shardwise as jshardwise
from kfac_pytorch_tpu.models import transformer_lm as jlm
from kfac_pytorch_tpu.ops.rsvd import sketch_matrix as jsketch
from kfac_pytorch_tpu.parallel import comm as jcomm
from kfac_pytorch_tpu.parallel.mesh import data_fsdp_tensor_mesh
from kfac_pytorch_tpu.training import step as jstep
from kfac_pytorch_tpu_torch import KFAC, capture
from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
from kfac_pytorch_tpu_torch.interop import (
    lm_layer_name_from_jax,
    lm_rank_shards_from_jax,
    lm_state_dict_from_jax,
)
from kfac_pytorch_tpu_torch.models import transformer_lm
from kfac_pytorch_tpu_torch.ops.eigh import bucket_size
from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.shardwise import lm_param_shardings, state_bytes_local
from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step
from tests import torch_dist_workers as workers
from tests.test_shardwise import VOCAB, _lm_3d_run

LM_KW = dict(max_len=16, d_model=16, n_heads=2, n_layers=1, tensor_parallel=2)
HP = dict(damping=0.01, fac_update_freq=1, kfac_update_freq=2)
STEPS = 4
RSVD = dict(solver="rsvd", solver_rank=8, solver_auto_threshold=32)
CASES = {"plain": {}, "rsvd_deferred": {**RSVD, "factor_comm_freq": 2}}
INT8 = {"factor_comm_freq": 2, "factor_comm_dtype": "int8"}
ROW = "blocks.0.ff2#r2"
TWIN = ["--synthetic", "--d-model", "16", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "3",
        "--device", "cpu", "--kfac-embedding"]
TWIN_3D = [*TWIN, "--fsdp", "2", "--tensor-parallel", "2"]
TWIN_OWNER = [*TWIN, "--fsdp", "2", "--factor-sharding", "owner"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    """``_lm_3d_run``'s batch: 8 rows of 16 tokens, the same every step."""
    toks = np.random.RandomState(7).randint(0, VOCAB, size=(8, 17))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def _jax_params():
    """``_lm_3d_run``'s initial parameters (numpy; the init jitted: one
    compile costs less than the eager ops' first dispatches)."""
    model = jlm.get_model(VOCAB, **LM_KW)
    x, _ = _batch()
    params = jax.jit(lambda k, v: model.init(k, v, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _one_process(weights, steps, resume=None, save=None, **kfac_kw):
    """The port's one-process lens model on the whole batch, ``_lm_3d_run``'s
    flags: ``(losses, parameters, K-FAC state)``; from a checkpoint
    ``resume``, saving ``save=(root, after_step)``."""
    model = transformer_lm.get_model(VOCAB, **LM_KW)
    model.load_state_dict(workers._t(weights))
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **HP, **kfac_kw)
    tx = make_sgd(0.9, 0.0)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    if resume is not None:
        state = ckpt.restore_checkpoint(resume, 0, state, kfac)
    step_fn = make_train_step(model, tx, kfac)
    batch = tuple(torch.from_numpy(a) for a in _batch())
    losses = []
    for i in range(state.step, steps):
        state, m = step_fn(state, batch, 0.1, HP["damping"], update_factors=True,
                           update_eigen=i % 2 == 0)
        losses.append(float(m["loss"]))
        if save is not None and i == save[1]:
            ckpt.save_checkpoint(save[0], 0, state)
    return (losses, workers._np({k: v.clone() for k, v in model.state_dict().items()}),
            state.kfac_state)


def _sketches():
    """The JAX sketches of every rsvd bucket the composed case can meet."""
    cols = RSVD["solver_rank"] + 8
    return {f"{m}x{cols}": np.array(jsketch(m, cols))
            for m in {bucket_size(n) for n in range(RSVD["solver_auto_threshold"], VOCAB + 1)}}


def _int8_draws(steps=STEPS):
    """The JAX package's stochastic-rounding draws of the int8 flush,
    ``{step: {bucket: [blocks, 256]}}``: the whole factor tree of the tiny
    LM fits one bucket of ``ceil(elements / 256)`` blocks."""
    model = transformer_lm.get_model(VOCAB, **LM_KW)
    blocks = -(-sum(f.numel() for e in KFAC(
        layers=capture.discover_layers(model), device="cpu").init(model)["factors"].values()
        for f in e.values()) // 256)
    key = jax.random.PRNGKey(jcomm._QUANT_SEED)
    return {i: {0: np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, jnp.int32(i)), 0), (blocks, 256)))}
        for i in range(steps)}


def _jax_int8_factors(mesh, steps=STEPS):
    """``_lm_3d_run`` placed sharded under ``INT8`` (which returns no K-FAC
    state): after each step, each device's copy of every factor leaf,
    ``[{(layer, key): [per device in the mesh's order]}]``."""
    model = jlm.get_model(VOCAB, **LM_KW)
    x, y = _batch()
    batch = jax.device_put((jnp.asarray(x), jnp.asarray(y)),
                           NamedSharding(mesh, P(("data", "fsdp"), None)))
    params = model.init(jax.random.PRNGKey(0), batch[0], train=True)["params"]
    layers = jcapture.discover_layers(model, batch[0], train=True)
    kfac = JKFAC(damping=HP["damping"], fac_update_freq=1, kfac_update_freq=2, mesh=mesh,
                 layers=layers, **INT8)
    tx = jstep.make_sgd(momentum=0.9)
    kstate = kfac.init(params)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=None, batch_stats={},
                             opt_state=tx.init(params), kfac_state=None)
    state = jax.device_put(state, NamedSharding(mesh, P())).replace(
        params=jax.device_put(params, jshardwise.lm_param_shardings(params, layers, mesh)),
        kfac_state=jax.device_put(kstate, kfac.state_shardings(kstate)))
    step = jstep.make_train_step(model, tx, kfac, train_kwargs={"train": True})
    devices = list(mesh.devices.flat)
    out = []
    for i in range(steps):
        state, _ = step(state, batch, jnp.float32(0.1), jnp.float32(HP["damping"]),
                        update_factors=True, update_eigen=i % 2 == 0, flush_factors=i % 2 == 0)
        leaves = {}
        for name, entry in state.kfac_state["factors"].items():
            for k, leaf in entry.items():
                held = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
                assert all(v.shape == leaf.shape for v in held.values())
                leaves[(lm_layer_name_from_jax(name), k)] = [held[d] for d in devices]
        out.append(leaves)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process reference runs first (the ranks resume its
    checkpoint), then the ranks start; this process runs JAX's 3-D mesh
    runs meanwhile and joins them."""
    root = tmp_path_factory.mktemp("fsdp")
    params = _jax_params()
    weights = {k: v.numpy() for k, v in lm_state_dict_from_jax(params).items()}
    one = _one_process(weights, STEPS, save=(str(root / "one"), 1))
    lm = {"vocab": VOCAB, "model": LM_KW, "hp": HP, "weights": weights,
          "batches": [_batch()] * STEPS}
    handle = workers.start("fsdp", 4, root / "spawn", lm=lm, cases=CASES, sketches=_sketches(),
                           ck_root=str(root / "3d"), one_ck=str(root / "one"),
                           twins=[TWIN_3D, TWIN_OWNER], int8={"kfac": INT8, "draws": _int8_draws()})
    mesh = data_fsdp_tensor_mesh(2, 2, devices=jax.devices()[:4])
    jax_runs = {name: _lm_3d_run(mesh, place_sharded=True, steps=STEPS, **kw)
                for name, kw in CASES.items()}
    return {"params": params, "weights": weights, "one": one, "jax": jax_runs,
            "jax_int8": _jax_int8_factors(mesh), "ranks": workers.join(handle), "mesh": mesh,
            "root": root}


def _close(got, want, rel):
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= rel * np.abs(w).max() + 1e-6, k


@pytest.mark.parametrize("case", list(CASES))
def test_3d_run_matches_jax_mesh(runs, case):
    """Each rank's losses and the gathered parameters against JAX's
    ``data_fsdp_tensor_mesh(2, 2)`` run placed sharded."""
    jparams, jlosses = runs["jax"][case]
    want = {k: v.numpy() for k, v in lm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    for r in runs["ranks"]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        _close(got["params"], want, 1e-4)


def _tensor_spread(per_slot):
    """Per fsdp slot, the largest difference between its two tensor slots'
    copies (device or rank ``2·f + t``)."""
    return [float(np.abs(per_slot[2 * f + 1] - per_slot[2 * f]).max()) for f in range(2)]


def test_int8_3d_flush_keeps_one_factor_per_tensor_slot(runs):
    """The deferred int8 wire on the 3-D world: in both packages the two
    tensor slots of each fsdp slot hold the same bits of the row layer's G
    and of every other replicated factor leaf after every step, and after
    each flush (steps 0 and 2) all four devices or ranks do. After every
    step each rank's factors lie within two int8 steps of the largest
    block scale of the JAX device's (the module docstring), a tensor-split
    leaf against its slot's blocks of the JAX leaf: keeping the other
    slot's blocks moves the row layer's A by 9.7 steps at step 0, a wrong
    mean by the factors' size."""
    jax_steps, ranks = runs["jax_int8"], runs["ranks"]
    assert len(jax_steps) == STEPS
    split = {(ROW, "A"), ("blocks.0.ff1#c2", "G")}
    for i, leaves in enumerate(jax_steps):
        port = [r["int8"]["factors"][i] for r in ranks]
        assert set(leaves) == {(n, k) for n, e in port[0].items() for k in e}
        for r, facs in enumerate(port):
            bound = 2 * max(float(np.abs(per_dev[r]).max()) for per_dev in leaves.values()) / 127
            for (name, k), per_dev in leaves.items():
                want = per_dev[r]
                if (name, k) in split:
                    want = np.split(want, 2)[r % 2]
                got = facs[name][k]
                assert got.shape == want.shape, (i, r, name, k, got.shape, want.shape)
                err = float(np.abs(got - want).max())
                assert err <= bound, (i, r, name, k, err, bound)
        for (name, k), per_dev in leaves.items():
            assert _tensor_spread(per_dev) == [0.0, 0.0], (i, name, k)
            if (name, k) in split:
                continue
            per_rank = [p[name][k] for p in port]
            assert _tensor_spread(per_rank) == [0.0, 0.0], (i, name, k)
            if i % 2 == 0:
                for got in (per_dev, per_rank):
                    assert all(np.array_equal(v, got[0]) for v in got), (i, name, k)
    for r in ranks:
        assert r["int8"]["losses"] == ranks[0]["int8"]["losses"]
        assert all(np.isfinite(r["int8"]["losses"]))


def test_3d_run_matches_one_process_lens_model(runs):
    losses, params, _ = runs["one"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["cases"]["plain"]["losses"], losses, rtol=1e-5)
        _close(r["cases"]["plain"]["params"], params, 1e-4)


def test_diagnostics_sum_over_the_tensor_slots(runs):
    """With ``track_diagnostics`` the split layers' norms and spectra are
    summed and reduced over the tensor slots once, beside the replicated
    layers': every rank's diagnostics equal one process's after 3 steps."""
    _, _, state = _one_process(runs["weights"], 3, track_diagnostics=True)
    want = workers._np(state["diagnostics"])
    assert set(want["layer_cond"]) >= {"blocks.0.ff1#c2", "blocks.0.ff2#r2"}
    for r in runs["ranks"]:
        got = r["diagnostics"]
        jax.tree_util.tree_map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-4),
                               got, want)


def test_world_layout(runs):
    """Row-major ``(data, fsdp, tensor)``: the batch slot ``r // T``, the
    tensor peers neighbours, the fsdp peers next."""
    for g, r in enumerate(runs["ranks"]):
        lay = r["layout"]
        assert (lay["rank"], lay["size"], lay["tensor_rank"], lay["fsdp_rank"]) == (
            g // 2, 2, g % 2, g // 2)
        assert lay["group"] == [g % 2, g % 2 + 2]
        assert lay["tensor"] == [2 * (g // 2), 2 * (g // 2) + 1]
        assert lay["fsdp"] == [g % 2, g % 2 + 2]
        assert lay["batch_axes"] == ("data", "fsdp")


def test_column_output_gather(runs):
    """``parallel.tensor.gather_from_tensor``: the tensor slots' feature
    slices concatenated forward, this slot's slice of the cotangent
    backward."""
    assert all(r["gather"] == (True, True) for r in runs["ranks"])


def _jax_leaf_bytes(tree, specs, mesh):
    """``{port name: per-device bytes}`` of a JAX LM parameter tree, one
    ``state_bytes_local`` per leaf, mapped through the port's layout."""
    per_leaf = jax.tree_util.tree_map(
        lambda leaf, spec: np.full(leaf.shape, jshardwise.state_bytes_local(
            {"x": leaf}, {"x": spec}, mesh), np.float32),
        tree, specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    return {k: int(v.reshape(-1)[0]) for k, v in lm_state_dict_from_jax(per_leaf).items()}


def test_param_and_momentum_bytes_match_jax_placement(runs):
    """Every parameter's per-rank bytes, and its momentum's, equal JAX's
    ``state_bytes_local`` under ``lm_param_shardings`` leaf for leaf, as do
    the port's own placement table and ``interop.lm_rank_shards_from_jax``."""
    params, mesh = runs["params"], runs["mesh"]
    jm = jlm.get_model(VOCAB, **LM_KW)
    x, _ = _batch()
    names = jcapture.discover_layers(jm, jnp.asarray(x), train=True)
    want = _jax_leaf_bytes(params, jshardwise.lm_param_shardings(params, names, mesh), mesh)
    full = {k: torch.from_numpy(v) for k, v in runs["weights"].items()}
    port_names = [lm_layer_name_from_jax(n) for n in names]
    table = lm_param_shardings({k: tuple(v.shape) for k, v in full.items()}, port_names, 2, 2)
    assert table["blocks.0.ff1.weight"] == ("tensor", 0)
    assert table["blocks.0.ff2.weight"] == ("tensor", 1)
    for k, v in full.items():
        assert state_bytes_local({k: v}, table, 2, 2) == want[k], k
    for g, r in enumerate(runs["ranks"]):
        got = r["cases"]["plain"]["bytes"]
        assert got["params"] == want
        assert got["momentum"] == want
        w = World(tensor_size=2, tensor_rank=g % 2, fsdp_size=2, fsdp_rank=g // 2)
        shards = lm_rank_shards_from_jax(params, port_names, w)
        assert {k: t.numel() * 4 for k, t in shards.items()} == want


def test_factor_bytes_match_jax_state_shardings(runs):
    """Each shard layer's factor/eigen leaves per rank equal JAX's
    ``state_bytes_local`` under ``KFAC.state_shardings``; the split MLP's
    factor+eigen bytes per rank stay under half the dense model's."""
    params, mesh = runs["params"], runs["mesh"]
    jm = jlm.get_model(VOCAB, **LM_KW)
    x, _ = _batch()
    kfac = JKFAC(damping=0.01, mesh=mesh, layers=jcapture.discover_layers(
        jm, jnp.asarray(x), train=True))
    kstate = kfac.init(params)
    specs = kfac.state_shardings(kstate)
    mlp = 0
    for r in runs["ranks"]:
        got = r["cases"]["plain"]["bytes"]["kfac"]
        placed = r["cases"]["plain"]["kfac_placements"]
        mlp = 0
        for key in ("factors", "eigen"):
            for jname, entry in kstate[key].items():
                name = lm_layer_name_from_jax(jname)
                if name not in got[key]:
                    continue
                for k, leaf in entry.items():
                    want = jshardwise.state_bytes_local(
                        {"x": np.asarray(leaf)}, {"x": specs[key][jname][k]}, mesh)
                    assert got[key][name][k] == want, (name, k)
                    split = specs[key][jname][k].spec != jax.sharding.PartitionSpec()
                    assert (placed[key][name][k] is not None) == split, (name, k)
                    mlp += want
    # the dense model's ff1 (17 → 64) and ff2 (64 → 16) A, G, Q and d
    dense = sum(a * a * 2 + a + g * g * 2 + g for a, g in ((17, 64), (65, 16))) * 4
    assert mlp < dense / 2


def test_collectives_by_group(runs):
    """One clipped capture step: the tensor group carries the row output's
    forward all-reduce and the column input's backward one (one block), ν's
    and the clip's sums, and no factor collective; the factor plane rides
    the data×fsdp group only; the fsdp group carries the parameter gather."""
    for r in runs["ranks"]:
        calls = r["counted"]
        tensor = [c for c in calls if c[1] == "tensor"]
        assert tensor == [("all_reduce", "tensor", "step")] * 4
        factor = [c for c in calls if c[2] == "factor"]
        assert factor and all(c[1] == "data_fsdp" for c in factor)
        assert [c for c in calls if c[1] == "fsdp"] == [("all_gather_into_tensor", "fsdp", "step")]
        assert not [c for c in calls if c[1] == "other"]


def test_3d_checkpoint_resumes_in_one_process(runs):
    """The 3-D run's checkpoint (the gathered one-process layout, saved
    after step 1) resumes in a one-process lens run, whose losses match the
    3-D run's; a one-process checkpoint resumes on the 4 ranks, whose
    losses match the one-process run's."""
    losses, _, _ = _one_process(runs["weights"], STEPS, resume=str(runs["root"] / "3d"))
    np.testing.assert_allclose(losses, runs["ranks"][0]["cases"]["plain"]["losses"][2:],
                               rtol=1e-5)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["resumed"], runs["one"][0][2:], rtol=1e-5)


def test_twin_3d_mesh_line_and_owner(runs):
    """The twin under ``--fsdp 2 --tensor-parallel 2`` prints the JAX mesh
    line and its ranks agree; under ``--fsdp 2 --factor-sharding owner``
    (owner shards over data×fsdp) it matches one process at the global
    batch."""
    ranks = runs["ranks"]
    assert "mesh data=1 fsdp=2 seq=1 tensor=2 global_batch=4 seq_len=16" in (
        ranks[0]["twins"][0]["printed"])
    assert "mesh data=2 fsdp=2 seq=1 tensor=1 global_batch=8" in ranks[0]["twins"][1]["printed"]
    for r in ranks:
        assert all(np.isfinite(r["twins"][0]["loss"]))
        np.testing.assert_allclose(r["twins"][0]["loss"], ranks[0]["twins"][0]["loss"], rtol=1e-6)
    one = trainer.main([*TWIN, "--batch-size", "8"])
    for r in ranks:
        np.testing.assert_allclose(r["twins"][1]["loss"], one["loss"], rtol=1e-5)


def test_degenerate_world_is_the_plain_twin():
    """``--fsdp 1 --tensor-parallel 1`` on one process: the plain twin's
    run bit for bit."""
    assert trainer.main([*TWIN, "--fsdp", "1"])["loss"] == trainer.main(TWIN)["loss"]


@pytest.mark.parametrize("argv,message", [
    (["--fsdp", "1", "--seq-parallel", "2"],
     "--fsdp builds the 3-D data×fsdp×tensor mesh; it does not compose with --seq-parallel"),
    (["--fsdp", "1", "--tensor-parallel", "2", "--moe-experts", "2"],
     "--moe-experts replaces the MLP that a genuine --tensor-parallel split"),
    (["--fsdp", "2", "--service-devices", "1"],
     "--service-devices carves a pure data-parallel mesh; it does not compose"),
    (["--fsdp", "3"], "--fsdp 3 x --tensor-parallel 1 must divide device count 4"),
    (["--fsdp", "1", "--tensor-parallel", "2", "--factor-sharding", "owner"],
     r"\[shard_lens_vs_owner_sharding\]"),
])
def test_twin_fsdp_refusals(argv, message):
    """The JAX trainer's checks of ``--fsdp``, on a 4-rank world's sizes."""
    with pytest.raises(SystemExit, match=message):
        trainer.check_world(trainer.parse_args([*TWIN, *argv]), World(size=4, distributed=True))

