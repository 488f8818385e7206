"""The port's elastic runtime across gloo ranks on the CPU
(``kfac_pytorch_tpu_torch/elastic``), the counterpart of the JAX package's
``tests/test_elastic.py`` on its 8-device mesh.

The ranks are spawned by ``tests/torch_dist_workers.py`` (task
``elastic``, a file store under ``tmp_path``, one torch thread each): four
ranks write the resize snapshots, then two ranks run the mid-interval and
mid-stream cases and resume the four ranks' snapshots. Every rank trains
the overlap tests' 24 → 32 → 10 MLP on its own batch.

* **Mid-interval resume, owner form** (the JAX
  ``test_mid_interval_resume_bitwise[owner]`` schedule:
  ``kfac_update_freq=4, eigh_chunks=3, factor_comm_freq=3``, a snapshot at
  step 6 with chunks 0 and 1 landed and ``factor_sync_age`` 1): the
  snapshot packs both ranks' ``factor_local`` (``packed_world`` 2), each
  rank gets its own row back, and every tensor at step 12 is the
  uninterrupted run's, bit for bit, on each rank.
* **Mid-stream resume, owner form** (``solver="streaming"``, a quiet drift
  signal, ``factor_comm_freq=2``, a snapshot at step 7): bitwise at step
  12, and the resumed run does not re-orthonormalize at the step-8
  boundary.
* **The int8 wire, replicated**: a snapshot just after a flush packs both
  ranks' ``wire_error`` residuals, and the resumed run is bitwise.
* Every state key of these runs (owner, deferred, int8) is in the
  manifest's table.
* **Resize 4 → 2** (the JAX ``test_mesh_resize_replan_8_to_4`` at half
  the ranks): an owner snapshot of four ranks resumes on two through the
  replan (``kfac/replan_count`` set, the manifest's world 4), and after one
  refresh interval the parameters are within 1e-6 (relative and absolute,
  the JAX test's bound) of the replicated run's continuation on two ranks.
* **Resize 4 → 1**: on one process the owner mode runs replicated, so the
  replan gathers the stacks back by the old plan; after one refresh
  interval within the same 1e-6 of the replicated continuation.
* **The LM twin** killed in signal mode and resumed bitwise on the 3-D
  world (data 1 × fsdp 2 × tensor 2; ``world`` 2) and on the data×tensor
  world of 2 ranks; with the deferred int8 wire on the 3-D world the
  snapshot packs the residuals of all 4 ranks (``packed_world`` 4,
  ``world`` 2) and every rank resumes bitwise.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.elastic.state_io import KFAC_STATE_KEYS
from tests import torch_dist_workers as workers


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    r = np.random.RandomState(11)
    w1, w2 = r.randn(32, 24) / 5, r.randn(10, 32) / 6
    return {
        "weights": {"fc1.weight": w1.astype(np.float32), "fc1.bias": np.zeros(32, np.float32),
                    "fc2.weight": w2.astype(np.float32), "fc2.bias": np.zeros(10, np.float32)},
        "x": r.randn(4, 8, 4, 6).astype(np.float32),
        "y": r.randint(0, 10, size=(4, 8)).astype(np.int64),
    }


MID = {
    "interval": (dict(kfac_update_freq=4, eigh_chunks=3, factor_sharding="owner",
                      factor_comm_freq=3), 6, 12),
    "stream": (dict(kfac_update_freq=4, solver="streaming", solver_rank=8,
                    solver_auto_threshold=16, stream_drift_threshold=0.5,
                    factor_sharding="owner", factor_comm_freq=2), 7, 12),
    # replicated, int8 wire: a snapshot just after the step-3 flush, when
    # the ranks' factors agree and their wire residuals do not
    "int8": (dict(kfac_update_freq=3, factor_comm_freq=3, factor_comm_dtype="int8"), 4, 9),
}
RESIZE_KW = dict(kfac_update_freq=2)
# the LM twin (tests/test_torch_port_fsdp.py's widths), 6 steps, killed at
# step 3: on 4 ranks the 3-D world (data 1 × fsdp 2 × tensor 2), and with
# the deferred int8 wire, whose residuals a snapshot packs over the 4 ranks
# while its world is the data×fsdp 2; on 2 ranks the data×tensor world
TWIN = ["--synthetic", "--d-model", "16", "--n-heads", "2", "--n-layers", "1",
        "--seq-len", "16", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "6",
        "--kfac-update-freq", "2", "--device", "cpu", "--kfac-embedding"]
TWIN_3D = [*TWIN, "--fsdp", "2", "--tensor-parallel", "2"]
TWIN_3D_INT8 = [*TWIN_3D, "--factor-comm-freq", "2", "--factor-comm-dtype", "int8"]
TWIN_DT = [*TWIN, "--tensor-parallel", "2"]
TWIN_KILL = 3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank snapshots, then the 2-rank runs; both worlds' results and
    the snapshots' directory."""
    root = tmp_path_factory.mktemp("elastic")
    inputs = _inputs()
    four = workers.spawn("elastic", 4, str(root / "four"), **inputs,
                         save=dict(kw=RESIZE_KW, at=4, root=str(root / "snaps")),
                         twin={"3d": dict(argv=TWIN_3D, kill=TWIN_KILL, root=str(root / "t3d")),
                               "3d_int8": dict(argv=TWIN_3D_INT8, kill=TWIN_KILL,
                                               root=str(root / "t3d8"))})
    two = workers.spawn("elastic", 2, str(root / "two"), **inputs,
                        mid=dict(cases=MID, root=str(root / "mid")),
                        resize=dict(kw=RESIZE_KW, end=8, root=str(root / "snaps")),
                        twin={"data_tensor": dict(argv=TWIN_DT, kill=TWIN_KILL,
                                                  root=str(root / "tdt"))})
    return four, two, str(root / "snaps"), inputs


@pytest.mark.parametrize("case", list(MID))
def test_mid_resume_bitwise_on_two_ranks(ranks, case):
    _, two, _, _ = ranks
    for rank, res in enumerate(two):
        got = res["mid"][case]
        assert got["differ"] == [], (rank, got["differ"])
        assert got["found"]["step"] == MID[case][1]
        assert got["found"]["cadence"] == got["seen"]["cadence"]
        assert got["found"]["manifest"] == {
            "world": 2, "sharding": "replicated" if case == "int8" else "owner",
            "packed_world": 2, "packed_replica_local": True}
        assert set(got["seen"]["keys"]) <= set(KFAC_STATE_KEYS)
        # this rank's deferred accumulators (or wire residuals) came back,
        # row for row
        assert set(got["seen"]["local"]) == {"interval": {"factor_local"}, "stream":
                                             {"factor_local"}, "int8": {"wire_error"}}[case]
        for key, tree in got["seen"]["local"].items():
            for a, b in zip(_leaves(tree), _leaves(got["found"]["local"][key]), strict=True):
                np.testing.assert_array_equal(b, a)
        if case == "int8":
            assert got["seen"]["sync_age"] == 0
        elif case == "interval":
            assert got["seen"]["cadence"]["landed"] == [0, 1]
            assert got["seen"]["sync_age"] == 1
        else:
            assert got["seen"]["fold_steps"] > 0
            assert got["seen"]["cadence"]["reorth_count"] == 1
            # boundary 8 stayed quiet in both runs
            assert [c["reorth_count"] for c in got["cadence_end"]] == [1, 1]
    if case != "stream":  # step 7 follows a flush: the accumulators are zero
        # the ranks' rows differ: a pack of rank 0's alone would not do
        a, b = ([_leaves(res["mid"][case]["seen"]["local"]) for res in two])
        assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def _close_params(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)


def test_resize_four_to_two_ranks(ranks):
    four, two, _, _ = ranks
    assert [r["save"] for r in four] == [{"owner": True, "replicated": False}] * 4
    for res in two:
        got = res["resize"]
        assert got["owner"]["world"] == 4 and got["owner"]["step"] == 4
        assert got["owner_replans"] == 1 and got["replicated_replans"] == 1
        assert "factor_shard" in got["owner"]["keys"]
        _close_params(got["owner"]["params"], got["replicated"]["params"])
    # one all_gather keeps the ranks' parameters the same bits
    for k, v in two[0]["resize"]["owner"]["params"].items():
        np.testing.assert_array_equal(two[1]["resize"]["owner"]["params"][k], v)


def test_resize_four_ranks_to_one_process(ranks):
    """An owner snapshot of four ranks resumed by one process: the
    preconditioner asks for the owner mode, runs replicated, and gets the
    stacks gathered back into per-layer factors and bases."""
    _, _, snaps, inputs = ranks
    from kfac_pytorch_tpu_torch.elastic import replan as _replan
    from tests.torch_dist_workers import _elastic_build, _elastic_resize

    before = _replan._REPLANS["count"]
    got = _elastic_resize(1, inputs["weights"],
                          (torch.from_numpy(inputs["x"][0]), torch.from_numpy(inputs["y"][0])),
                          RESIZE_KW, 8, snaps)
    assert _replan._REPLANS["count"] == before + 1
    assert got["owner"]["world"] == 4 and "factor_shard" not in got["owner"]["keys"]
    assert got["owner"]["keys"] == got["replicated"]["keys"]
    _close_params(got["owner"]["params"], got["replicated"]["params"])
    kfac = _elastic_build(1, inputs["weights"], {**RESIZE_KW, "factor_sharding": "owner"})[0]
    assert kfac.requested_factor_sharding == "owner" and not kfac.owner_sharded


@pytest.mark.parametrize("world", ["3d", "data_tensor"])
def test_lm_twin_killed_and_resumed_bitwise(ranks, world):
    """The LM twin killed in signal mode at step 3 and rerun: every rank's
    losses from step 3 are the uninterrupted run's, bit for bit, and the
    manifest's world is the K-FAC data world (data×fsdp, without the
    tensor axis)."""
    four, two, _, _ = ranks
    results, data_world = (four, 2) if world == "3d" else (two, 1)
    for res in results:
        got = res["twin"][world]
        assert got["killed"] == got["full"][:TWIN_KILL]
        assert got["resumed"] == got["full"][TWIN_KILL:]
        assert got["manifest"] == {"world": data_world, "sharding": "replicated",
                                   "packed_world": None, "step": TWIN_KILL}


def test_3d_int8_snapshot_packs_every_rank(ranks):
    """On the 3-D world the int8 wire's residuals are packed over all 4
    ranks while the manifest's world is the data×fsdp 2 (the JAX
    package's ``packed_world`` and ``world``), and every rank, each tensor
    slot included, resumes the uninterrupted run's losses bit for bit: the
    flush quantizes the tensor-gathered tree, so the snapshot's factors
    are every tensor slot's own."""
    four = ranks[0]
    for res in four:
        got = res["twin"]["3d_int8"]
        assert got["killed"] == got["full"][:TWIN_KILL]
        assert got["resumed"] == got["full"][TWIN_KILL:]
        assert got["manifest"] == {"world": 2, "sharding": "replicated", "packed_world": 4,
                                   "step": TWIN_KILL}
