"""The port's owner-sharded factor state (``KFAC(factor_sharding="owner")``)
and overlap plane (``comm_overlap``) on 2 and 4 gloo ranks on the CPU,
against the JAX package on a mesh of the same size (``tests/conftest.py``'s
8 virtual devices).

The ranks are spawned by ``tests/torch_dist_workers.py`` (task ``owner``,
a file store under ``tmp_path``, one torch thread each): one spawn per
world size, module-scoped; the tests read its results. The JAX side feeds
each device its own rank's statistics (an array whose device buffers
differ, read by the owner plane's ``shard_map`` as the per-replica values
they are in the JAX train step).

* The shard plans equal JAX's (slots, rows, wire buckets, ``valid_rows``,
  ``wire_groups``, ``shard_plan_bytes``, ``plan_fingerprint``,
  ``plan_owner_chunks``) on dense and diagonal-A shape sets.
* ``scatter_merge`` on the same per-rank payloads: this rank's rows within
  1e-6 of the largest entry of JAX's on the float32 wire, and 2⁻⁷ (one
  bfloat16 ulp) on the bf16 wire, with the same wire bytes and buckets.
* The owner refresh (dense, and rank-aware on the JAX sketch), the
  spectrum mass and the stream fold against JAX on the same shard stacks:
  reconstructions of the valid rows within 1e-5, the gauges within 1e-5
  relative; pad rows stay zero.
* ``precondition_all_owner`` in the "update" and "tables" layouts, the
  kernel route (its plain version here) and the dense one: within 1e-4 of
  the largest entry of JAX's (λ = 0.003 amplifies rounding).
* ``KFAC.update`` owner-sharded over six steps of each case (the JAX
  ``test_owner_matches_replicated`` cases base, ``eigh_chunks``,
  ``factor_comm_freq``, ``rsvd``, plus streaming, a diagonal-A embedding
  and rsvd with bf16 eigenvectors, whose "tables" cross the gather): the
  new gradients equal on every rank, within 1e-4 of the largest entry of
  the JAX owner mode's, and within 2e-5 of the port's
  replicated mode's (the reduce-scatter sums ``(1−α)·c_r``, the
  replicated EMA ``(1−α)·mean c_r``: float32 rounding, amplified by 1/λ),
  both 4·2⁻⁸ with bf16 Q (``tests/test_torch_port_bf16.py``'s bound);
  this rank's factor rows within 1e-6 of the replicated factors.
* Overlap on and off bitwise equal over two refresh intervals (the JAX
  ``test_overlap_is_pure_reorder`` cases), the ring within its 1e-4.
* The collectives per step kind: a capture or flush step one
  reduce-scatter per wire bucket and one all-gather; a refresh none beyond
  those; a deferred capture or a plain step only the all-gather.
* The refusals' and the one-rank degrade's messages equal JAX's.
* Checkpoints: an owner state round-trips bitwise on the same world, a
  replicated one re-homes, an owner one into a replicated preconditioner
  is refused with JAX's message, and ``broadcast_state`` leaves each rank's
  rows its own.
"""

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
from kfac_pytorch_tpu.ops import precondition as jprec
from kfac_pytorch_tpu.ops.rsvd import sketch_matrix as jsketch
from kfac_pytorch_tpu.parallel import assignment as jassign
from kfac_pytorch_tpu.parallel import comm as jcomm
from kfac_pytorch_tpu.parallel import sharded_eigh as jse
from kfac_pytorch_tpu.scheduler import EigenRefreshCadence as JCadence
from kfac_pytorch_tpu.training import checkpoint as jckpt
from kfac_pytorch_tpu_torch import KFAC
from kfac_pytorch_tpu_torch.parallel import assignment
from tests import torch_dist_workers as workers


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def _per_device(arrs, mesh):
    """One array whose device ``r`` holds ``arrs[r]`` (the per-replica
    statistics of the JAX train step's wrapper)."""
    bufs = [jax.device_put(a, d) for a, d in zip(arrs, mesh.devices.flat)]
    return jax.make_array_from_single_device_arrays(arrs[0].shape, NamedSharding(mesh, P()), bufs)


def _split(mesh, tree):
    return jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree), NamedSharding(mesh, P("data")))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()) + 1e-30)


def _gapped_spd(r, n):
    u, _ = np.linalg.qr(r.randn(n, n))
    return ((u * (10.0 * 0.8 ** np.arange(n))) @ u.T).astype(np.float32)


RANK_CFG = (20, 4)  # sides from 20 keep rank 4 (the sketch is 128 x 12)
DAMPING = 0.003


def _rank_fn(n):
    threshold, r = RANK_CFG
    return None if n < threshold or r >= n else r


# {name: (kind, port args)}: a stacked same-shape pair whose A sides (24)
# truncate under rsvd, two singletons; the embedding net's diagonal-A layer
NETS = {
    "dense": {"l0": ("dense", (23, 12)), "l1": ("dense", (23, 12)),
              "l2": ("dense", (12, 16)), "l3": ("dense", (8, 4))},
    "embed": {"emb": ("embed", (40, 6)), "l2": ("dense", (12, 16)),
              "l3": ("dense", (8, 4))},
}
SHAPES = {"dense": {"l0": (12, 24), "l1": (12, 24), "l2": (16, 13), "l3": (4, 9)},
          "embed": {"emb": (6, 40), "l2": (16, 13), "l3": (4, 9)}}
DIAG = {"dense": set(), "embed": {"emb"}}
STEPS = 6
COMMON = dict(fac_update_freq=1, kfac_update_freq=3, factor_decay=0.5, damping=DAMPING)
TRUNC = dict(solver_auto_threshold=RANK_CFG[0], solver_rank=RANK_CFG[1])
CASES = {
    "base": ("dense", {}),
    # captures only at the boundaries: both chunks read one snapshot, as
    # the replicated plan's differently cut chunks do
    "eigh_chunks": ("dense", {"eigh_chunks": 2, "fac_update_freq": 3}),
    "comm_freq": ("dense", {"factor_comm_freq": 2}),
    "rsvd": ("dense", {"solver": "rsvd", **TRUNC}),
    "streaming": ("dense", {"solver": "streaming", **TRUNC}),
    "diag_a": ("embed", {}),
    # the "tables" layout ships bf16 Q, re-solved after the gather
    "bf16_tables": ("dense", {"solver": "rsvd", **TRUNC, "eigen_dtype": "bf16"}),
}
# bf16 Q: two runs store the same bf16 Q but where a float32 entry lies
# within float32 noise of a rounding boundary (tests/test_torch_port_bf16.py)
CASE_RTOL = {"bf16_tables": 4 * 2.0 ** -8}
OVERLAP_CASES = {
    "plain": {},
    "chunked": dict(eigh_chunks=2, kfac_update_freq=4),
    "deferred": dict(factor_comm_freq=2, kfac_update_freq=4),
    "rsvd": dict(solver="rsvd", solver_rank=8, solver_auto_threshold=16, kfac_update_freq=4),
    "owner": dict(factor_sharding="owner", kfac_update_freq=4),
    "ring": dict(kfac_update_freq=2),
}
FLAG_KEYS = ("update_factors", "update_eigen", "eigen_chunk", "swap_eigen", "flush_factors")


def _jax_kw(kw):
    return {k: (jnp.bfloat16 if v == "bf16" else v) for k, v in kw.items()}


def _jparams(net):
    out = {}
    for name, (kind, args) in NETS[net].items():
        if kind == "embed":
            out[name] = {"embedding": np.zeros(args, np.float32)}
        else:
            out[name] = {"kernel": np.zeros(args, np.float32),
                         "bias": np.zeros(args[1], np.float32)}
    return out


def _net_inputs(net, world, seed):
    """Per step: each rank's statistics and the replicated gradients, in
    the port's layout (the JAX layout is derived)."""
    r = np.random.RandomState(seed)
    stats, grads = [], []
    for _ in range(STEPS):
        per_rank = []
        for _ in range(world):
            a, g = {}, {}
            for name, (gn, an) in SHAPES[net].items():
                a[name] = (r.rand(an).astype(np.float32) + 0.1 if name in DIAG[net]
                           else _gapped_spd(r, an))
                g[name] = _gapped_spd(r, gn)
            per_rank.append((a, g))
        stats.append(per_rank)
        step = {}
        for name, (kind, args) in NETS[net].items():
            if kind == "embed":
                step[f"{name}.weight"] = r.randn(*args).astype(np.float32)
            else:
                step[f"{name}.weight"] = r.randn(args[1], args[0]).astype(np.float32)
                step[f"{name}.bias"] = r.randn(args[1]).astype(np.float32)
        grads.append(step)
    return {"spec": NETS[net], "stats": stats, "grads": grads}


def _jgrads(net, grads):
    out = {}
    for name, (kind, _) in NETS[net].items():
        if kind == "embed":
            out[name] = {"embedding": jnp.asarray(grads[f"{name}.weight"])}
        else:
            out[name] = {"kernel": jnp.asarray(grads[f"{name}.weight"].T),
                         "bias": jnp.asarray(grads[f"{name}.bias"])}
    return out


def _port_grads(net, new):
    """A port result's K-FAC layers in the JAX layout."""
    out = {}
    for name, (kind, _) in NETS[net].items():
        if kind == "embed":
            out[name] = {"embedding": new[f"{name}.weight"]}
        else:
            out[name] = {"kernel": new[f"{name}.weight"].T, "bias": new[f"{name}.bias"]}
    return out


def _jflags(kfac, steps):
    cad = JCadence(kfac)
    return [{k: v for k, v in cad.flags_for_step(s, 0).items() if k in FLAG_KEYS}
            for s in range(steps)]


# ------------------------------------------------------------ the op inputs


def _eigen_rows(stack, rank_fn, valid):
    """Floored eigenpairs (top ``rank`` of them and the residual mass on a
    truncated size) of each valid row of a ``[rows, n, n]`` stack."""
    rows, n, _ = stack.shape
    rank = rank_fn(n) if rank_fn is not None else None
    cols = n if rank is None else rank
    q = np.zeros((rows, n, cols), np.float32)
    d = np.zeros((rows, cols), np.float32)
    rho = np.zeros((rows,), np.float32)
    for i in np.flatnonzero(valid):
        w, v = np.linalg.eigh(stack[i].astype(np.float64))
        w = np.where(w > 1e-10, w, 0.0)
        q[i], d[i] = v[:, n - cols:], w[n - cols:]
        if rank is not None:
            rho[i] = max(np.trace(stack[i]) - d[i].sum(), 0.0) / (n - rank)
    return {"Q": q, "d": d, **({"rho": rho} if rank is not None else {})}


def _ops_inputs(world):
    r = np.random.RandomState(7 + world)
    shapes, diag = SHAPES["embed"] | SHAPES["dense"], {"emb"}
    plan = jassign.plan_factor_shards(shapes, world, 300, diag_a=diag)
    payload = {}
    for name, (gn, an) in shapes.items():
        payload[name] = {
            "A": np.stack([r.rand(an).astype(np.float32) if name in diag else _gapped_spd(r, an)
                           for _ in range(world)]),
            "G": np.stack([_gapped_spd(r, gn) for _ in range(world)]),
        }
    shard, factor_shard = {}, {}
    for key, n, rows, _ in plan.wire_groups():
        diag_group = key.startswith("v")
        shape = (world * rows, n) if diag_group else (world * rows, n, n)
        shard[key] = r.randn(*shape).astype(np.float32)
        valid = np.asarray(plan.valid_rows(n, diag_group)).reshape(-1)
        if diag_group:
            factor_shard[key] = (r.rand(*shape).astype(np.float32) + 0.1) * valid[:, None]
        else:
            factor_shard[key] = np.stack([_gapped_spd(r, n) if ok else np.zeros((n, n), np.float32)
                                          for ok in valid])
    eigen = {}
    for mode, fn in (("update", None), ("tables", _rank_fn)):
        eigen[mode] = {f"n{n}": _eigen_rows(factor_shard[f"n{n}"], fn,
                                            np.asarray(plan.valid_rows(n)).reshape(-1))
                       for n in plan.group_sizes}
        eigen[mode].update({f"v{n}": {"d": factor_shard[f"v{n}"]} for n in plan.diag_group_sizes})
    gmats = {n: r.randn(*shapes[n]).astype(np.float32) for n in shapes}
    return dict(
        shapes=shapes, diag_a=sorted(diag), bucket_cap=300, payload=payload, shard=shard,
        decay=0.5, factor_shard=factor_shard, eigen_shard_update=eigen["update"],
        eigen_shard_tables=eigen["tables"], gmats=gmats, damping=DAMPING, rank_cfg=RANK_CFG,
        sketches={"128x12": np.array(jsketch(128, 12))},
    ), plan


def _ck_inputs(world):
    k = JKFAC(mesh=_mesh(world), eigh_chunks=2, fac_update_freq=1, kfac_update_freq=3)
    return {"spec": _net_inputs("dense", world, 90), "flags": _jflags(k, 5)}


def _overlap_inputs(world):
    r = np.random.RandomState(11)
    w1, w2 = r.randn(32, 24) / 5, r.randn(10, 32) / 6
    return {
        "cases": OVERLAP_CASES,
        "weights": {"fc1.weight": w1.astype(np.float32), "fc1.bias": np.zeros(32, np.float32),
                    "fc2.weight": w2.astype(np.float32), "fc2.bias": np.zeros(10, np.float32)},
        "x": r.randn(world, 8, 4, 6).astype(np.float32),
        "y": r.randint(0, 10, size=(world, 8)).astype(np.int64),
    }


def _count_inputs(world):
    net = _net_inputs("dense", world, 40)
    return {
        "spec": net["spec"], "stats": net["stats"][0], "grads": net["grads"][0], "bucket_cap": 300,
        "kinds": [
            ("capture", {}, dict(update_factors=True, update_eigen=False)),
            ("plain", {}, dict(update_factors=False, update_eigen=False)),
            ("refresh", {}, dict(update_factors=True, update_eigen=True)),
            ("rsvd_refresh", {"solver": "rsvd", **TRUNC},
             dict(update_factors=True, update_eigen=True)),
            ("deferred_capture", {"factor_comm_freq": 2},
             dict(update_factors=True, update_eigen=False)),
            ("deferred_flush", {"factor_comm_freq": 2},
             dict(update_factors=True, update_eigen=False, flush_factors=True)),
        ],
    }


_RESULTS = {}


@pytest.fixture(scope="module")
def owner_results(tmp_path_factory):
    """``run(world)``: the inputs and the ranks' results of ``world``. The
    first call starts the ranks of both worlds, so that the 4-rank world runs
    while the 2-rank world's tests run JAX; each world is joined when first
    read, and both at the module's end."""
    def start(world):
        ops, jplan = _ops_inputs(world)
        nets = {net: _net_inputs(net, world, 50 + i) for i, net in enumerate(NETS)}
        cases = {}
        for case, (net, kw) in CASES.items():
            k = JKFAC(mesh=_mesh(world), **_jax_kw({**COMMON, **kw}))
            cases[case] = (net, {**COMMON, **kw}, _jflags(k, STEPS))
        runs = {"nets": nets, "cases": cases, "sketches": ops["sketches"]}
        root = tmp_path_factory.mktemp(f"owner{world}")
        ck = {**_ck_inputs(world), "root": str(root / "ck")}
        ranks = workers.joiner(workers.start(
            "owner", world, str(root / "run"), ops=ops, runs=runs,
            overlap=_overlap_inputs(world), counts=_count_inputs(world), ck=ck))
        return ops, jplan, runs, ranks

    def run(world):
        if not _RESULTS:
            for w in (2, 4):
                _RESULTS[w] = start(w)
        ops, jplan, runs, ranks = _RESULTS[world]
        return ops, jplan, runs, ranks()

    yield run
    for *_, ranks in _RESULTS.values():
        ranks()


# ----------------------------------------------------------------- the plans


def _plan_fields(plan):
    return (plan.world, plan.owners, [tuple(vars(s).values()) for s in plan.slots],
            plan.group_rows, plan.group_sizes, plan.diag_group_rows, plan.diag_group_sizes,
            [(b.size, [tuple(vars(e).values()) for e in b.entries]) for b in plan.wire_buckets])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("net", ["dense", "embed"])
@pytest.mark.parametrize("rank_fn", [None, _rank_fn], ids=["dense_sides", "rsvd_sides"])
def test_shard_plans_equal_jax(world, net, rank_fn):
    got = assignment.plan_factor_shards(SHAPES[net], world, 300, diag_a=DIAG[net])
    want = jassign.plan_factor_shards(SHAPES[net], world, 300, diag_a=DIAG[net])
    assert _plan_fields(got) == _plan_fields(want)
    assert got.wire_groups() == want.wire_groups() and got.owner_count() == want.owner_count()
    for key, n, _, _ in want.wire_groups():
        assert got.valid_rows(n, key[0] == "v") == want.valid_rows(n, key[0] == "v")
    assert got.slot("l2", "G") == type(got.slot("l2", "G"))(*vars(want.slot("l2", "G")).values())
    for itemsize in (4, 2):
        assert (assignment.shard_plan_bytes(got, rank_fn, itemsize)
                == jassign.shard_plan_bytes(want, rank_fn, itemsize))
    assert assignment.plan_fingerprint(got) == jassign.plan_fingerprint(want)
    for chunks in (1, 2, 3):
        assert (assignment.plan_owner_chunks(got, chunks, rank_fn=rank_fn)
                == [[tuple(j) for j in c] for c in
                    jassign.plan_owner_chunks(want, chunks, rank_fn=rank_fn)])


# ------------------------------------------------------------------ the ops


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_scatter_merge_matches_jax(owner_results, world, wire):
    ops, jplan, _, ranks = owner_results(world)
    mesh = _mesh(world)
    fc = jcomm.FactorComm(mesh=mesh, axis_name="data",
                          comm_dtype=jnp.float32 if wire == "f32" else jnp.bfloat16, sharded=True)
    payload = {n: {k: _per_device(list(v), mesh) for k, v in f.items()}
               for n, f in ops["payload"].items()}
    merge = jax.jit(lambda p, sh, d: fc.scatter_merge(p, sh, jplan, d))
    want = _np(merge(payload, _split(mesh, ops["shard"]), jnp.float32(ops["decay"])))
    rel = 1e-6 if wire == "f32" else 2.0 ** -7
    for rank, res in enumerate(ranks):
        got = res["ops"][f"scatter_{wire}"]
        for key, v in want.items():
            rows = v.reshape(world, -1, *v.shape[1:])[rank]
            _close(got[key], rows, rel)
        assert res["ops"][f"scatter_{wire}_wire"] == (fc.last_wire_bytes, fc.last_collectives)


def _recon(e, i):
    q = np.asarray(e["Q"][i], np.float64)
    f = (q * np.asarray(e["d"][i], np.float64)) @ q.T
    if "rho" in e:
        f += float(e["rho"][i]) * (np.eye(q.shape[0]) - q @ q.T)
    return f


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("solver", ["dense", "rsvd"])
def test_owner_refresh_mass_and_fold_match_jax(owner_results, world, solver):
    ops, jplan, _, ranks = owner_results(world)
    mesh = _mesh(world)
    fn = _rank_fn if solver == "rsvd" else None
    fshard = _split(mesh, ops["factor_shard"])
    want = _np(jax.jit(partial(jse.owner_eigen_update, plan=jplan, mesh=mesh, rank_fn=fn))(fshard))
    mass = float(jax.jit(partial(jse.owner_spectrum_mass, plan=jplan, mesh=mesh, rank_fn=fn))(
        fshard, _split(mesh, want)))
    diag = {f"v{n}": {"d": ops["factor_shard"][f"v{n}"]} for n in jplan.diag_group_sizes}
    folded, resid = jax.jit(partial(jse.owner_stream_fold, plan=jplan, mesh=mesh, rank_fn=fn))(
        fshard, _split(mesh, {**want, **diag}))
    folded = _np(folded)
    for rank, res in enumerate(ranks):
        got = res["ops"][f"eigen_{solver}"]
        for n in jplan.group_sizes:
            valid = jplan.valid_rows(n)[rank]
            rows = {k: v.reshape(world, -1, *v.shape[1:])[rank] for k, v in want[f"n{n}"].items()}
            for i, ok in enumerate(valid):
                if ok:
                    _close(_recon(got[f"n{n}"], i), _recon(rows, i), 1e-5)
                else:  # a pad row is never decomposed
                    assert not any(np.any(v[i]) for v in got[f"n{n}"].values())
        assert res["ops"][f"mass_{solver}"] == pytest.approx(mass, rel=1e-5)
        got_fold, got_resid = res["ops"][f"fold_{solver}"]
        assert got_resid == pytest.approx(float(resid), rel=1e-5, abs=1e-7)
        for key, e in folded.items():
            for field in ("d", "rho"):
                if field in e:
                    rows = e[field].reshape(world, -1, *e[field].shape[1:])[rank]
                    _close(got_fold[key][field], rows, 1e-5)
    if solver == "dense":
        assert mass == 1.0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", ["update", "tables"])
def test_precondition_all_owner_matches_jax(owner_results, world, layout):
    ops, jplan, _, ranks = owner_results(world)
    mesh = _mesh(world)
    fn = _rank_fn if layout == "tables" else None
    _, segments, _ = jprec._owner_gather_layout(
        ops["shapes"], jplan.owners, world, fn, set(ops["diag_a"]))
    # the embedding ships its tables in both; the truncated pair only here
    assert segments["emb"]["mode"] == "tables" and segments["l2"]["mode"] == "update"
    assert segments["l0"]["mode"] == layout
    apply = jax.jit(partial(jprec.precondition_all_owner, mesh=mesh, plan=jplan, rank_fn=fn,
                            axis_name="data"))
    want = _np(apply({n: jnp.asarray(g) for n, g in ops["gmats"].items()},
                     _split(mesh, ops[f"eigen_shard_{layout}"]), jnp.float32(DAMPING)))
    order = jprec._owner_gather_layout(ops["shapes"], jplan.owners, world, fn,
                                       set(ops["diag_a"]))[0]
    for res in ranks:
        for kind in ("auto", "dense"):
            got = res["ops"][f"apply_{layout}_{kind}"]
            assert list(got) == order  # the emission order
            for n in want:
                _close(got[n], want[n], 1e-4)


# ------------------------------------------------------------ owner training


def _jax_run(world, case):
    net, kw = CASES[case]
    mesh = _mesh(world)
    k = JKFAC(mesh=mesh, layers=list(NETS[net]), factor_sharding="owner",
              **_jax_kw({**COMMON, **kw}))
    assert k.owner_sharded
    return k, mesh


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_owner_training_matches_jax_and_replicated(owner_results, world, case):
    _, _, runs, ranks = owner_results(world)
    net, _, flags = runs["cases"][case]
    inputs = runs["nets"][net]
    k, mesh = _jax_run(world, case)
    state = k.init(jax.tree_util.tree_map(jnp.asarray, _jparams(net)))
    fns, jnew = {}, []
    for step, fl in enumerate(flags):
        key = tuple(sorted(fl.items()))
        if key not in fns:
            fns[key] = jax.jit(lambda g, s, a, gs, _fl=fl: k.update(
                g, s, a_contribs=a, g_factor_stats=gs, lr=jnp.float32(0.1),
                damping=jnp.float32(DAMPING), **_fl))
        per = inputs["stats"][step]
        a_c = {n: _per_device([per[r][0][n] for r in range(world)], mesh) for n in SHAPES[net]}
        g_s = {n: _per_device([per[r][1][n] for r in range(world)], mesh) for n in SHAPES[net]}
        new, state = fns[key](_jgrads(net, inputs["grads"][step]), state, a_c, g_s)
        jnew.append(_np(new))
    owner = [r["runs"][case]["owner"] for r in ranks]
    for step in range(STEPS):
        got = owner[0]["new"][step]
        for other in owner[1:]:  # one all_gather: every rank the same bits
            for n, v in got.items():
                np.testing.assert_array_equal(other["new"][step][n], v)
        want = jax.tree_util.tree_leaves(jnew[step])
        for g, w in zip(jax.tree_util.tree_leaves(_port_grads(net, got)), want, strict=True):
            _close(g, w, CASE_RTOL.get(case, 1e-4))
        rep = ranks[0]["runs"][case]["replicated"]["new"][step]
        for n, v in rep.items():
            _close(got[n], v, CASE_RTOL.get(case, 2e-5))
    # this rank's factor rows against the replicated factors (deferred,
    # the last step was no flush: both hold unmerged statistics then)
    plan = assignment.plan_factor_shards(SHAPES[net], world, 1 << 20, diag_a=DIAG[net])
    for rank, res in enumerate(ranks):
        shard = res["runs"][case]["owner"]["state"]["factor_shard"]
        facs = res["runs"][case]["replicated"]["state"]["factors"]
        for s in plan.slots:
            if s.owner == rank and case != "comm_freq":
                key = f"v{s.size}" if s.diag else f"n{s.size}"
                want = facs[s.name]["A_diag" if s.diag else s.factor]
                _close(shard[key][s.row], want, 1e-6)
        info = res["runs"][case]["plan_info"]
        assert info == jassign.shard_plan_bytes(
            jassign.plan_factor_shards(SHAPES[net], world, 1 << 20, diag_a=DIAG[net]),
            rank_fn=k._rank_fn(), eigen_itemsize=2 if case == "bf16_tables" else 4)
        assert info["per_owner"][rank] < info["replicated_total"]


# -------------------------------------------------------------------- overlap


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(OVERLAP_CASES))
def test_overlap_is_pure_reorder(owner_results, world, case):
    ranks = owner_results(world)[3]
    for res in ranks:
        (off, mode_off), (on, mode_on) = res["overlap"][(case, False)], res["overlap"][(case, True)]
        if case == "ring":
            assert mode_on == 2  # KFAC_OVERLAP_PPERMUTE=1: a different summation order
            for n, v in on[-1].items():
                np.testing.assert_allclose(v, off[-1][n], rtol=1e-4, atol=1e-5)
            continue
        assert (mode_off, mode_on) == (0, 1)
        for p_on, p_off in zip(on, off, strict=True):
            for n, v in p_on.items():
                np.testing.assert_array_equal(v, p_off[n])


# ---------------------------------------------------------------- collectives


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_per_step_kind(owner_results, world):
    for res in owner_results(world)[3]:
        counts = res["counts"]
        for key, (calls, buckets) in counts.items():
            assert buckets > 1
            scatter = buckets if key in ("capture", "refresh", "rsvd_refresh",
                                         "deferred_flush") else 0
            want = {"reduce_scatter_tensor": scatter, "all_gather_into_tensor": 1,
                    # the rank-aware refresh's spectrum mass: one (cap, total) sum
                    "all_reduce": 1 if key == "rsvd_refresh" else 0,
                    "broadcast": 0, "batch_isend_irecv": 0}
            assert calls == want, key


# ------------------------------------------------------ refusals and degrade


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(precond_method="inverse"), dict(diag_blocks=2), dict(distribute_precondition=True),
    dict(track_diagnostics=True), dict(factor_comm_dtype="int8", factor_comm_freq=2),
], ids=["inverse", "diag_blocks", "distribute_precondition", "diagnostics", "int8"])
def test_owner_refusals_carry_jax_messages(kw, capsys):
    port = dict(kw)
    if "factor_comm_dtype" in kw:
        kw = {**kw, "factor_comm_dtype": jnp.int8}
    want = _message(lambda: JKFAC(mesh=_mesh(2), factor_sharding="owner", **kw))
    assert _message(lambda: KFAC(device="cpu", factor_sharding="owner", **port)) == want


def test_owner_and_overlap_degrade_on_one_rank(capsys):
    JKFAC(factor_sharding="owner", comm_overlap=True)
    want = capsys.readouterr().out
    kfac = KFAC(device="cpu", factor_sharding="owner", comm_overlap=True)
    assert capsys.readouterr().out == want and "WARNING" in want
    assert not kfac.owner_sharded and not kfac.comm_overlap
    assert kfac.requested_factor_sharding == "owner" and kfac.factor_comm.overlap_mode == 0
    assert not kfac.factor_comm.sharded and not kfac.factor_comm.overlaps_exchange


# ----------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("world", [2, 4])
def test_owner_checkpoint(owner_results, world):
    refusal = _message(lambda: jckpt.rehome_kfac_state(
        types.SimpleNamespace(owner_sharded=False), {"factor_shard": {}}))
    ranks = owner_results(world)[3]
    rows = []
    for rank, res in enumerate(ranks):
        ck = res["ck"]
        saved, back = ck["round_trip"]
        for key in ("factor_shard", "eigen_shard", "eigen_pending_shard"):
            for a, b in zip(jax.tree_util.tree_leaves(saved[key]),
                            jax.tree_util.tree_leaves(back[key]), strict=True):
                np.testing.assert_array_equal(a, b)
        want, got, rep_facs = ck["rehomed"]
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        plan = assignment.plan_factor_shards(SHAPES["dense"], world)
        for s in plan.slots:
            if s.owner == rank:
                np.testing.assert_array_equal(got["factor_shard"][f"n{s.size}"][s.row],
                                              rep_facs[s.name][s.factor])
        assert ck["refused"] == refusal and ck["refused_rehome"] == refusal
        before, after = ck["broadcast"]
        for a, b in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(after),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        rows.append(after["factor_shard"])
    assert any(not np.array_equal(rows[0][k], rows[1][k]) for k in rows[0])
