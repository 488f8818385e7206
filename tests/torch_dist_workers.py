"""Rank bodies of ``tests/test_torch_port_distributed.py``,
``tests/test_torch_port_comm.py``, ``tests/test_torch_port_owner.py``,
``tests/test_torch_port_lens.py``, ``tests/test_torch_port_context.py``,
``tests/test_torch_port_moe.py``, ``tests/test_torch_port_fsdp.py``,
``tests/test_torch_port_observability.py``,
``tests/test_torch_port_elastic_ranks.py``,
``tests/test_torch_port_service.py`` and
``tests/test_torch_port_compile_cache.py`` (not a test file).

Each task runs in every rank of a gloo world started by :func:`spawn`
(or :func:`start`, then :func:`join`, so that the test process works
while the ranks run) through ``torch.multiprocessing`` with a file store
under the test's ``tmp_path`` and one torch thread per rank. This module imports only torch
and the port, so the spawned ranks start without JAX; the test process
holds the JAX side. A task's inputs and per-rank results travel as
``torch.save`` files.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240


def _run(rank, world, root, task):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(f"{root}/inputs.pt", weights_only=False)
        result = TASKS[task](rank, world, **inputs)
        torch.save(result, f"{root}/result-{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(task, world, root, **inputs):
    """Start ``task`` on ``world`` gloo ranks; :func:`join` the handle for
    the ranks' results."""
    os.makedirs(root, exist_ok=True)
    torch.save(inputs, f"{root}/inputs.pt")
    ctx = mp.spawn(_run, args=(world, str(root), task), nprocs=world, join=False)
    return task, world, str(root), ctx, time.monotonic() + SPAWN_TIMEOUT_S


def join(handle):
    """Wait for :func:`start`'s ranks; returns their results."""
    task, world, root, ctx, deadline = handle
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} on {world} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(f"{root}/result-{r}.pt", weights_only=False) for r in range(world)]


def joiner(handle):
    """A function that joins :func:`start`'s ``handle`` on its first call and
    returns the ranks' results on every call."""
    results = []

    def get():
        if not results:
            results.append(join(handle))
        return results[0]

    return get


def spawn(task, world, root, **inputs):
    """Run ``task`` on ``world`` gloo ranks; returns the ranks' results."""
    return join(start(task, world, root, **inputs))


def _t(tree):
    """numpy leaves → torch tensors, recursively."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _leaves(tree):
    """The tensors of a tensor or a nested dict, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree


# ------------------------------------------------------------------ the ops


def ops(rank, world, factors, is_conv, diag_blocks, dlf, gmats, eigen, inv, damping):
    """The sharded refresh and the distributed applies on one rank, beside
    the port's replicated results."""
    from kfac_pytorch_tpu_torch.ops import precondition as P
    from kfac_pytorch_tpu_torch.parallel.assignment import (
        layer_assignment,
        precondition_assignment,
    )
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
        replicated_eigen_update,
        sharded_eigen_update,
    )

    w = data_parallel_world()
    assert (w.size, w.rank) == (world, rank)
    facs, names = _t(factors), list(factors)
    table = layer_assignment(names, is_conv, world, dlf, diag_blocks)
    blocks = {n: diag_blocks if is_conv[n] else 1 for n in names}
    out = {
        "sharded": _np(sharded_eigen_update(facs, table, w)),
        "sharded_bf16q": _np(sharded_eigen_update(facs, table, w, q_dtype=torch.bfloat16)),
        "replicated": _np(replicated_eigen_update(facs, blocks)),
    }
    g, e, i = _t(gmats), _t(eigen), _t(inv)
    singles, stacked = P.split_eigen_state(e)
    isingles, istacked = P.split_inv_state(i)
    owners = precondition_assignment({n: tuple(m.shape) for n, m in g.items()}, world,
                                     diag_a=P.diag_a_names(e))
    common = dict(world=w, owners=owners)
    out["replicated_apply"] = _np(P.precondition_all(g, singles, damping, stacked))
    for kind in ("auto", "dense"):
        out[f"apply_{kind}"] = _np(P.precondition_all_distributed(
            g, singles, damping, stacked, kind=kind, **common))
    out["apply_bf16"] = _np(P.precondition_all_distributed(
        g, singles, damping, stacked, comm_dtype=torch.bfloat16, **common))
    out["apply_order"] = list(P.precondition_all_distributed(g, singles, damping, stacked,
                                                             **common))
    out["replicated_order"] = list(P.precondition_all(g, singles, damping, stacked))
    out["inv_replicated"] = _np(P.precondition_all_inv(g, isingles, istacked))
    out["inv_apply"] = _np(P.precondition_all_inv_distributed(g, isingles, istacked, **common))
    out["owners"] = owners
    return out


# -------------------------------------------------------------- train steps


def steps(rank, world, state_dict, layers, hp, images, labels, routes):
    """One ResNet-8 K-FAC train step per route on this rank's rows of the
    global batch: ``{route: (loss, state_dict, factors)}``."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world, local_rows
    from kfac_pytorch_tpu_torch.training.step import (
        TrainState,
        kfac_flags_for_step,
        make_sgd,
        make_train_step,
    )

    w = data_parallel_world()
    rows = local_rows(len(images), w)
    x = torch.from_numpy(np.ascontiguousarray(images[rows].transpose(0, 3, 1, 2)))
    y = torch.from_numpy(labels[rows])
    out = {}
    for route, kw in routes.items():
        model = cifar_resnet.CifarResNet(1, 10)
        model.load_state_dict(_t(state_dict))
        tx = make_sgd(hp["momentum"], hp["wd"])
        kfac = KFAC(layers=layers, device="cpu", lr=hp["lr"], **hp["kfac"],
                    distribute_precondition=kw.get("distribute_precondition", False))
        assert kfac.world.size == world
        state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                           kfac_state=kfac.init(model))
        step = make_train_step(model, tx, kfac, sgd_hyper=(hp["momentum"], hp["wd"]),
                               grad_comm_dtype=kw.get("grad_comm_dtype"))
        state, metrics = step(state, (x, y), hp["lr"], hp["kfac"]["damping"],
                              **kfac_flags_for_step(0, kfac))
        out[route] = (float(metrics["loss"]), _np(model.state_dict()),
                      _np(state.kfac_state["factors"]))
    return out


# -------------------------------------------------------------------- twins


def twins(rank, world, cifar_dir, shard_dir, out_dir):
    """The CIFAR and ImageNet twins on this rank, the paths of every
    ``torch.save`` recorded: ``{twin: (history, state_dict, saves)}``."""
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as imagenet
    from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet

    cifar_resnet._DEPTHS["resnet8"] = 1
    imagenet_resnet._MODELS["tiny_resnext"] = (imagenet_resnet.Bottleneck, (1, 1), 4, 4)
    saves = []
    real_save = torch.save
    torch.save = lambda obj, f, *a, **k: (saves.append(str(f)), real_save(obj, f, *a, **k))
    built = {}
    out = {}
    try:
        for name, module, argv in (
            ("cifar", cifar, ["--data-dir", cifar_dir, "--model", "resnet8",
                              "--batch-size", "4", "--val-batch-size", "3",
                              "--bn-recal-batches", "1", "--kfac-update-freq", "2",
                              "--distribute-precondition", "--log-dir", f"{out_dir}/cifar-logs"]),
            ("imagenet", imagenet, ["--data-dir", shard_dir, "--model", "tiny_resnext",
                                    "--image-size", "32", "--val-resize", "36",
                                    "--batch-size", "2", "--val-batch-size", "2",
                                    "--kfac-update-freq", "2", "--grad-comm-dtype", "bf16"]),
        ):
            build = module.build

            def keep(*args, build=build, name=name):
                res = built[name] = build(*args)
                return res

            module.build = keep
            del saves[:]
            hist = module.main([*argv, "--epochs", "1", "--num-workers", "2", "--device", "cpu",
                                "--checkpoint-dir", f"{out_dir}/{name}-ck"])
            module.build = build
            out[name] = (hist, _np(built[name][0].state_dict()), list(saves))
    finally:
        torch.save = real_save
    return out


# ------------------------------------------------------- truncated solvers


def solver_ops(rank, world, factors, is_conv, rank_cfg, chunks, sketches, kfac_run):
    """The rank-aware (``rank_fn``) and chunked refreshes on this rank,
    sharded and replicated, on the JAX package's sketches (``sketches``:
    ``{"<m>x<cols>": array}``); then ``KFAC.update`` over a cadence with
    ``eigh_chunks`` and ``solver="rsvd"`` on ``kfac_run``'s statistics."""
    from kfac_pytorch_tpu_torch import EigenRefreshCadence, KFAC
    from kfac_pytorch_tpu_torch.ops import rsvd
    from kfac_pytorch_tpu_torch.parallel.assignment import layer_assignment, plan_eigh_chunks
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
        build_slots,
        replicated_eigen_chunk_update,
        replicated_eigen_update,
        sharded_eigen_chunk_update,
        sharded_eigen_update,
    )

    rsvd.sketch_matrix = lambda m, cols, device=None: torch.from_numpy(sketches[f"{m}x{cols}"])
    w = data_parallel_world()
    facs, names = _t(factors), list(factors)
    threshold, r = rank_cfg

    def rank_fn(n):
        return None if n < threshold or r >= n else r

    out = {}
    for key, fn in (("rsvd", rank_fn), ("dense", None)):
        table = layer_assignment(names, is_conv, world, None, 1)
        out[f"sharded_{key}"] = _np(sharded_eigen_update(facs, table, w, rank_fn=fn))
        out[f"replicated_{key}"] = _np(replicated_eigen_update(facs, {n: 1 for n in names},
                                                               rank_fn=fn))
        slots = build_slots(facs, table)
        plan = plan_eigh_chunks(slots, chunks, rank_fn=fn)
        template = replicated_eigen_update(facs, {n: 1 for n in names}, rank_fn=fn)
        for mode in ("sharded", "replicated"):
            pending = {n: {k: torch.zeros_like(v) for k, v in e.items()}
                       for n, e in template.items()}
            for c in range(chunks):
                part = [slots[i] for i in plan[c]]
                if mode == "sharded":
                    pending = sharded_eigen_chunk_update(facs, pending, part, w, rank_fn=fn)
                else:
                    pending = replicated_eigen_chunk_update(facs, pending, part, rank_fn=fn)
            out[f"chunked_{mode}_{key}"] = _np(pending)

    net, stats, grads, kw, steps = (kfac_run[k] for k in
                                    ("net", "stats", "grads", "kwargs", "steps"))
    model = torch.nn.Module()
    for name, (kind, args) in net.items():
        from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense

        model.add_module(name, (KFACConv if kind == "conv" else KFACDense)(*args))
    kfac = KFAC(layers=list(net), device="cpu", **kw)
    assert kfac.world.size == world
    state, cadence, updates = kfac.init(model), EigenRefreshCadence(kfac), []
    for step in range(steps):
        a_c, g_s = (_t(x) for x in stats[step])
        new, state = kfac.update(_t(grads), state, a_contribs=a_c, g_factor_stats=g_s,
                                 lr=0.1, damping=0.003, **cadence.flags_for_step(step))
        updates.append(_np(new))
    out["kfac_updates"] = updates
    out["kfac_eigen"] = (_np(state["eigen"]), _np(state["eigen_stacked"]))
    return out


# -------------------------------------------------------- factor comm plane


def _rank_tree(tree, rank):
    """Rank ``rank``'s slice of a tree of ``[world, ...]`` numpy leaves."""
    if isinstance(tree, dict):
        return {k: _rank_tree(v, rank) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree[rank]))


def _comm_means(rank, w, stats, cap, quant):
    """The plane's wire ops on this rank's stat tree: the bucketed float32
    mean (a small bucket cap and the default one), the per-leaf reference,
    the bf16 wire, and the int8 merge on the injected draws."""
    from kfac_pytorch_tpu_torch.parallel import comm

    tree = _rank_tree(stats, rank)
    out = {"reference": _np(comm.per_layer_pmean_reference(tree, w))}
    for key, dtype, bucket_cap in (("f32", "f32", cap), ("f32_one_bucket", "f32", 1 << 20),
                                   ("bf16", "bf16", cap)):
        fc = comm.FactorComm(w, dtype, 1, max_bucket_elems=bucket_cap)
        out[key] = _np(fc.allreduce(tree))
        out[f"{key}_wire"] = (fc.last_wire_bytes, fc.last_collectives)
    fc = comm.FactorComm(w, "int8", 2, max_bucket_elems=cap)
    draws = quant["draws"]
    fc.draw = lambda step, b, first, n, device: torch.from_numpy(draws[b][first:first + n])
    # the merge overwrites the tree's leaves and the residuals: give it copies
    tree = {n: {k: v.clone() for k, v in f.items()} for n, f in tree.items()}
    err = {k: v.clone() for k, v in _rank_tree(quant["wire_error"], rank).items()}
    before = dict(err)
    merged, err = fc._merge_quantized(tree, err, quant["step"])
    # in place: the residuals in their buffers, a lone leaf's mean in the leaf
    out["int8_in_place"] = (all(err[k] is v for k, v in before.items()), [
        m.data_ptr() == t.data_ptr()
        for m, t in zip(comm.tree_leaves(merged), comm.tree_leaves(tree))])
    out["int8"], out["int8_error"] = _np(merged), _np(err)
    out["int8_wire"] = (fc.last_wire_bytes, fc.last_collectives)
    return out


def _tiny_mlp():
    from kfac_pytorch_tpu_torch.models.layers import KFACDense

    model = torch.nn.Module()
    model.add_module("fc1", KFACDense(6, 5))
    model.add_module("fc2", KFACDense(5, 3))
    return model


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _deferred(rank, w, deferred, root):
    """Per-step reduction against the deferred flush (``factor_comm_freq=3``)
    on the same statistics, the ages, the ranks' diverged factors between
    flushes, the update's refusals, the factor collectives per step, and an
    int8 state's checkpoint round trip (rank 0 writes)."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState, kfac_flags_for_step

    hp = dict(damping=0.01, fac_update_freq=1, kfac_update_freq=10, device="cpu")
    model = _tiny_mlp()
    runs = {"per_step": KFAC(**hp), "deferred": KFAC(**hp, factor_comm_freq=3)}
    assert runs["deferred"].factor_comm.defer and not runs["per_step"].factor_comm.defer
    out = {k: {"updates": [], "factors": [], "flags": [], "ages": []} for k in runs}
    states = {k: kfac.init(model) for k, kfac in runs.items()}
    for step in range(deferred["steps"]):
        a_c = {n: torch.from_numpy(v[rank]) for n, v in deferred["a"][step].items()}
        g_s = {n: torch.from_numpy(v[rank]) for n, v in deferred["g"][step].items()}
        grads = {n: torch.from_numpy(v) for n, v in deferred["grads"][step].items()}
        for key, kfac in runs.items():
            flags = kfac_flags_for_step(step, kfac)
            new, states[key] = kfac.update(grads, states[key], a_contribs=a_c,
                                           g_factor_stats=g_s, lr=0.05, damping=0.01, **flags)
            rec = out[key]
            rec["updates"].append(_np(new))
            rec["factors"].append(_np(states[key]["factors"]))
            rec["flags"].append(flags)
            rec["ages"].append(int(states[key].get("factor_sync_age", -1)))

    # the refusals of update(): a refresh (or chunk 0) without the flush
    kfac = runs["deferred"]
    chunked = KFAC(**{**hp, "kfac_update_freq": 4}, factor_comm_freq=2, eigh_chunks=2)
    out["refusals"] = {
        "flush_without_defer": _raised(lambda: runs["per_step"].update(
            {}, {}, lr=0.1, update_factors=False, update_eigen=False, flush_factors=True)),
        "refresh_without_flush": _raised(lambda: kfac.update(
            {}, {}, lr=0.1, update_factors=True, update_eigen=True)),
        "chunk0_without_flush": _raised(lambda: chunked.update(
            {}, {}, lr=0.1, update_factors=True, update_eigen=False, eigen_chunk=(0, 2))),
    }

    # factor all_reduces per step, counted in this rank
    real = dist.all_reduce
    calls = []

    def counting(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)

    counts = {}
    a_c = {n: torch.from_numpy(v[rank]) for n, v in deferred["a"][0].items()}
    g_s = {n: torch.from_numpy(v[rank]) for n, v in deferred["g"][0].items()}
    grads = {n: torch.from_numpy(v) for n, v in deferred["grads"][0].items()}
    dist.all_reduce = counting
    try:
        for key, freq, flags in (
            ("capture", 1, dict(update_factors=True, update_eigen=False)),
            ("plain", 1, dict(update_factors=False, update_eigen=False)),
            ("deferred_capture", 2, dict(update_factors=True, update_eigen=False)),
            ("deferred_flush", 2, dict(update_factors=True, update_eigen=False,
                                       flush_factors=True)),
        ):
            k = KFAC(**hp, factor_comm_freq=freq)
            k.factor_comm.max_bucket_elems = 40  # several buckets
            st = k.init(model)
            del calls[:]
            k.update(grads, st, a_contribs=a_c, g_factor_stats=g_s, lr=0.05, damping=0.01,
                     **flags)
            counts[key] = (len(calls), k.factor_comm.last_collectives)
    finally:
        dist.all_reduce = real
    out["collectives"] = counts

    # an int8 state mid-interval through a checkpoint: rank 0 writes its own
    k8 = KFAC(**hp, factor_comm_freq=2, factor_comm_dtype="int8")
    st = k8.init(model)
    for step in range(4):
        a_c = {n: torch.from_numpy(v[rank]) for n, v in deferred["a"][step].items()}
        g_s = {n: torch.from_numpy(v[rank]) for n, v in deferred["g"][step].items()}
        _, st = k8.update(grads, st, a_contribs=a_c, g_factor_stats=g_s, lr=0.05,
                          damping=0.01, **kfac_flags_for_step(step, k8))
    saved = TrainState(step=4, model=model, opt_state={}, kfac_state=st)
    ckpt.save_checkpoint(f"{root}/ck", 0, saved)
    dist.barrier()
    fresh = TrainState(step=0, model=model, opt_state={}, kfac_state=k8.init(model))
    restored = ckpt.restore_checkpoint(f"{root}/ck", 0, fresh)
    out["int8_state"] = _np({k: st[k] for k in ("factors", "wire_error", "factor_sync_age")})
    out["int8_restored"] = _np({k: restored.kfac_state[k]
                                for k in ("factors", "wire_error", "factor_sync_age")})
    out["int8_restored_step"] = restored.step
    # a flush step with no capture merges copies: the input state keeps its
    # factors (each leaf a bucket of its own, which the merge writes into)
    k1 = KFAC(**hp, factor_comm_freq=2, factor_comm_dtype="int8")
    k1.factor_comm.max_bucket_elems = 1
    st = k1.init(model)
    for step in range(2):
        a_c = {n: torch.from_numpy(v[rank]) for n, v in deferred["a"][step].items()}
        g_s = {n: torch.from_numpy(v[rank]) for n, v in deferred["g"][step].items()}
        _, st = k1.update(grads, st, a_contribs=a_c, g_factor_stats=g_s, lr=0.05,
                          damping=0.01, **kfac_flags_for_step(step, k1))
    kept = {n: {k: v.clone() for k, v in f.items()} for n, f in st["factors"].items()}
    _, flushed = k1.update(grads, st, lr=0.05, damping=0.01, update_factors=False,
                           update_eigen=False, flush_factors=True)
    out["int8_flush_only"] = (_np(kept), _np(st["factors"]), _np(flushed["factors"]))
    return out


def _lm_slice(rank, w, lm):
    """The tiny transformer LM, K-FAC with the token embedding, on this
    rank's rows of each global batch: the bf16 factor wire deferred to every
    second capture step and bf16 gradients."""
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.parallel.context import full_attention
    from kfac_pytorch_tpu_torch.parallel.mesh import local_rows
    from kfac_pytorch_tpu_torch.training.step import (
        TrainState,
        kfac_flags_for_step,
        make_sgd,
        make_train_step,
        step_kind,
    )

    model = transformer_lm.get_model(lm["vocab"], attention_fn=full_attention, **lm["model_kw"])
    model.load_state_dict(_t(lm["state_dict"]))
    tx = make_sgd(lm["momentum"], lm["wd"])
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **lm["hp"],
                factor_comm_dtype="bf16", factor_comm_freq=2)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step_fn = make_train_step(model, tx, kfac, sgd_hyper=(lm["momentum"], lm["wd"]),
                              grad_clip=lm["clip"], grad_comm_dtype=torch.bfloat16)
    out = {"losses": [], "flags": [], "kinds": [], "ages": []}
    for i, (x, y) in enumerate(lm["batches"]):
        rows = local_rows(len(x), w)
        flags = kfac_flags_for_step(i, kfac)
        state, m = step_fn(state, (torch.from_numpy(x[rows].astype(np.int64)),
                                   torch.from_numpy(y[rows].astype(np.int64))),
                           lm["lr"], lm["hp"]["damping"], **flags)
        out["losses"].append(float(m["loss"]))
        out["flags"].append(flags)
        out["kinds"].append(step_kind(flags))
        out["ages"].append(int(state.kfac_state["factor_sync_age"]))
    out["state_dict"] = _np(model.state_dict())
    out["factors"] = _np(state.kfac_state["factors"])
    out["wire"] = (kfac.factor_comm.last_wire_bytes, kfac.factor_comm.last_collectives)
    return out


def _lstm(rank, w, lstm):
    """The WikiText twin on this rank for each of ``lstm["runs"]``, and the
    dropout generators the LM step hands the model on two steps."""
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer
    from kfac_pytorch_tpu_torch.models import wikitext_rnn
    from kfac_pytorch_tpu_torch.training.lm_step import init_carry, make_lm_train_step
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd

    out = {name: trainer.main([*lstm["argv"], *extra]) for name, extra in lstm["runs"].items()}
    model = wikitext_rnn.get_model("LSTM", 12, 4, 4, 1, 0.5, False)
    seeds = []
    forward = model.forward

    def recording(tokens, carry, gen=None):
        seeds.append((gen.initial_seed(), float(torch.rand((), generator=gen))))
        return forward(tokens, carry, gen)

    model.forward = recording
    tx = make_sgd(0.0, 0.0)
    step_fn = make_lm_train_step(model, tx, None, grad_clip=0.25)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())))
    gen = torch.Generator().manual_seed(7)
    x = torch.zeros((2, 3), dtype=torch.int64)
    for _ in range(2):
        state, _, _ = step_fn(state, (x, x), init_carry(model, 2, "cpu"), gen, 0.1, 0.0)
    out["dropout_draws"] = seeds
    return out


def comm(rank, world, stats, cap, quant, out_dir, deferred=None, lm=None, lstm=None,
         cifar=None):
    """The factor comm plane's tests on this rank (``tests/test_torch_port_comm.py``)."""
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    w = data_parallel_world()
    assert (w.size, w.rank) == (world, rank)
    out = {"means": _comm_means(rank, w, stats, cap, quant)}
    if deferred is not None:
        out["deferred"] = _deferred(rank, w, deferred, out_dir)
    if lm is not None:
        out["lm"] = _lm_slice(rank, w, lm)
    if lstm is not None:
        out["lstm"] = _lstm(rank, w, lstm)
    if cifar is not None:
        from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
        from kfac_pytorch_tpu_torch.models import cifar_resnet

        cifar_resnet._DEPTHS["resnet8"] = 1
        out["cifar"] = trainer.main(cifar)
    return out


# ------------------------------------------------- owner sharding, overlap


def _owner_net(spec):
    """A module of ``KFACDense`` / ``KFACEmbed`` layers from ``{name: (kind,
    args)}``."""
    from kfac_pytorch_tpu_torch.models.layers import KFACDense, KFACEmbed

    model = torch.nn.Module()
    for name, (kind, args) in spec.items():
        model.add_module(name, (KFACEmbed if kind == "embed" else KFACDense)(*args))
    return model


def _rows(tree, rank, world):
    """Rank ``rank``'s rows of a tree of global ``[world·rows, ...]`` stacks."""
    if isinstance(tree, dict):
        return {k: _rows(v, rank, world) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t.reshape(world, -1, *t.shape[1:])[rank].contiguous()


def _counting(names):
    """Patch ``torch.distributed``'s ``names`` to count their calls;
    returns ``(calls, restore)``."""
    calls = {n: 0 for n in names}
    real = {n: getattr(dist, n) for n in names}

    def wrap(n):
        def fn(*args, **kwargs):
            calls[n] += 1
            return real[n](*args, **kwargs)
        return fn

    for n in names:
        setattr(dist, n, wrap(n))
    return calls, lambda: [setattr(dist, n, f) for n, f in real.items()]


@contextlib.contextmanager
def _jax_sketches(sketches):
    """The port's rsvd draws the JAX package's sketches (``{"<m>x<cols>":
    array}``) inside the block."""
    from kfac_pytorch_tpu_torch.ops import rsvd

    real = rsvd.sketch_matrix
    rsvd.sketch_matrix = lambda m, cols, device=None: torch.from_numpy(sketches[f"{m}x{cols}"])
    try:
        yield
    finally:
        rsvd.sketch_matrix = real


def _owner_ops(rank, w, ops):
    """The owner plane's pieces on this rank's rows: ``scatter_merge`` on
    both wires, the owner refresh (dense and rank-aware), spectrum mass,
    stream fold, and ``precondition_all_owner`` in both layouts."""
    from kfac_pytorch_tpu_torch.ops import precondition as P
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_shards
    from kfac_pytorch_tpu_torch.parallel.comm import FactorComm
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
        owner_eigen_update,
        owner_spectrum_mass,
        owner_stream_fold,
    )

    threshold, r = ops["rank_cfg"]

    def rank_fn(n):
        return None if n < threshold or r >= n else r

    plan = plan_factor_shards(ops["shapes"], w.size, ops["bucket_cap"], diag_a=set(ops["diag_a"]))
    payload = _rank_tree(ops["payload"], rank)
    shard = _rows(ops["shard"], rank, w.size)
    out = {}
    for wire in ("f32", "bf16"):
        fc = FactorComm(w, wire, 1, sharded=True)
        out[f"scatter_{wire}"] = _np(fc.scatter_merge(payload, shard, plan, ops["decay"]))
        out[f"scatter_{wire}_wire"] = (fc.last_wire_bytes, fc.last_collectives)
    fshard = _rows(ops["factor_shard"], rank, w.size)
    for key, fn in (("dense", None), ("rsvd", rank_fn)):
        with _jax_sketches(ops["sketches"]):
            eig = owner_eigen_update(fshard, plan, rank, rank_fn=fn)
        out[f"eigen_{key}"] = _np(eig)
        out[f"mass_{key}"] = float(owner_spectrum_mass(fshard, eig, plan, w, rank_fn=fn))
        diag = {f"v{n}": {"d": fshard[f"v{n}"]} for n in plan.diag_group_sizes}
        folded, resid = owner_stream_fold(fshard, {**eig, **diag}, plan, w, rank_fn=fn)
        out[f"fold_{key}"] = (_np(folded), float(resid))
    gmats = _t(ops["gmats"])
    for key, fn in (("update", None), ("tables", rank_fn)):
        eshard = _rows(ops[f"eigen_shard_{key}"], rank, w.size)
        for kind in ("auto", "dense"):
            out[f"apply_{key}_{kind}"] = _np(P.precondition_all_owner(
                gmats, eshard, ops["damping"], world=w, plan=plan, rank_fn=fn, kind=kind))
    return out


def _owner_runs(rank, w, runs):
    """``KFAC.update`` over a cadence's flags for every case, owner-sharded
    and replicated, on this rank's statistics: the new gradients per step,
    the replicated factors and this rank's factor rows at the end."""
    from kfac_pytorch_tpu_torch import KFAC

    out = {}
    for case, (net, kw, flags) in runs["cases"].items():
        spec, stats, grads = (runs["nets"][net][k] for k in ("spec", "stats", "grads"))
        res = {}
        for mode in ("owner", "replicated"):
            model = _owner_net(spec)
            kw = {k: (torch.bfloat16 if v == "bf16" else v) for k, v in kw.items()}
            kfac = KFAC(layers=list(spec), device="cpu", factor_sharding=mode, **kw)
            assert kfac.owner_sharded == (mode == "owner")
            state, news = kfac.init(model), []
            for step, fl in enumerate(flags):
                a_c, g_s = (_t(x) for x in stats[step][rank])
                with _jax_sketches(runs["sketches"]):
                    new, state = kfac.update(_t(grads[step]), state, a_contribs=a_c,
                                             g_factor_stats=g_s, lr=0.1, damping=0.003, **fl)
                news.append(_np(new))
            keep = {k: state[k] for k in ("factors", "factor_shard", "eigen_shard",
                                          "factor_local", "factor_sync_age", "spectrum_mass",
                                          "stream_residual") if k in state}
            res[mode] = {"new": news, "state": _np(keep)}
            if mode == "owner":
                res["plan_info"] = kfac.shard_plan_info
                res["gather_width"] = kfac.precond_gather_width
        out[case] = res
    return out


class _MLP(torch.nn.Module):
    """The JAX overlap tests' BatchNorm-free toy: 24 → 32 → 10."""

    def __init__(self):
        from kfac_pytorch_tpu_torch.models.layers import KFACDense

        super().__init__()
        self.fc1, self.fc2 = KFACDense(24, 32), KFACDense(32, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.reshape(x.shape[0], -1))))


def _owner_overlap(rank, w, overlap):
    """Overlap on against off through ``make_train_step`` on this rank's
    batch, every step's parameters (bitwise is the contract), and the
    point-to-point ring's run with ``KFAC_OVERLAP_PPERMUTE=1``."""
    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    x = torch.from_numpy(overlap["x"][rank])
    y = torch.from_numpy(overlap["y"][rank])
    out = {}
    for case, kw in overlap["cases"].items():
        for on in (False, True):
            if case == "ring":
                os.environ["KFAC_OVERLAP_PPERMUTE"] = "1" if on else "0"
            model = _MLP()
            model.load_state_dict(_t(overlap["weights"]))
            kfac = KFAC(layers=["fc1", "fc2"], device="cpu", damping=0.01,
                        fac_update_freq=1, comm_overlap=on or case == "ring", **kw)
            tx = make_sgd(0.9, 5e-4)
            state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                               kfac_state=kfac.init(model))
            step_fn = make_train_step(model, tx, kfac, sgd_hyper=(0.9, 5e-4))
            cad, traj = EigenRefreshCadence(kfac), []
            for step in range(2 * kfac.hparams.kfac_update_freq):
                state, _ = step_fn(state, (x, y), 0.05, 0.01, **cad.flags_for_step(step))
                traj.append(_np(model.state_dict()))
            out[(case, on)] = (traj, kfac.factor_comm.overlap_mode)
        os.environ.pop("KFAC_OVERLAP_PPERMUTE", None)
    return out


def _owner_collectives(rank, w, counts):
    """Collectives per step kind of the owner mode, counted in this rank."""
    from kfac_pytorch_tpu_torch import KFAC

    spec, stats, grads = (counts[k] for k in ("spec", "stats", "grads"))
    a_c, g_s = (_t(x) for x in stats[rank])
    out = {}
    names = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce", "broadcast",
             "batch_isend_irecv")
    for key, kw, flags in counts["kinds"]:
        kfac = KFAC(layers=list(spec), device="cpu", factor_sharding="owner", **kw)
        kfac.factor_comm.max_bucket_elems = counts["bucket_cap"]  # several buckets
        state = kfac.init(_owner_net(spec))
        calls, restore = _counting(names)
        try:
            kfac.update(_t(grads), state, a_contribs=a_c, g_factor_stats=g_s, lr=0.1,
                        damping=0.003, **flags)
        finally:
            restore()
        (plan,) = kfac._shard_plans.values()
        out[key] = (dict(calls), len(plan.wire_buckets))
    return out


def _owner_checkpoint(rank, w, ck):
    """An owner state through a checkpoint on this world, a replicated one
    re-homed, the refusal of an owner one into a replicated preconditioner,
    and ``broadcast_state`` leaving each rank's rows its own."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState

    spec, stats, grads = (ck["spec"][k] for k in ("spec", "stats", "grads"))
    model = _owner_net(spec)
    out = {}
    states = {}
    for mode in ("owner", "replicated"):
        kfac = KFAC(layers=list(spec), device="cpu", factor_sharding=mode, eigh_chunks=2,
                    fac_update_freq=1, kfac_update_freq=3)
        st = kfac.init(model)
        for step, fl in enumerate(ck["flags"]):
            a_c, g_s = (_t(x) for x in stats[step][rank])
            _, st = kfac.update(_t(grads[step]), st, a_contribs=a_c, g_factor_stats=g_s,
                                lr=0.1, damping=0.003, **fl)
        states[mode] = (kfac, st)
        ckpt.save_checkpoint(f"{ck['root']}/{mode}", 0, TrainState(step=len(ck["flags"]),
                             model=model, opt_state={}, kfac_state=st))
    dist.barrier()
    kfac, st = states["owner"]
    fresh = TrainState(step=0, model=model, opt_state={}, kfac_state=kfac.init(model))
    back = ckpt.restore_checkpoint(f"{ck['root']}/owner", 0, fresh, kfac)
    out["round_trip"] = (_np(st), _np(back.kfac_state))
    fresh = TrainState(step=0, model=model, opt_state={}, kfac_state=kfac.init(model))
    rehomed = ckpt.restore_checkpoint(f"{ck['root']}/replicated", 0, fresh, kfac)
    out["rehomed"] = (_np(kfac.owner_state_from_replicated(states["replicated"][1])),
                      _np(rehomed.kfac_state), _np(states["replicated"][1]["factors"]))
    rkfac = states["replicated"][0]
    target = TrainState(step=0, model=model, opt_state={}, kfac_state=rkfac.init(model))
    out["refused"] = _raised(lambda: ckpt.restore_checkpoint(f"{ck['root']}/owner", 0, target,
                                                             rkfac))
    out["refused_rehome"] = _raised(lambda: ckpt.rehome_kfac_state(rkfac, st))
    before = _np({k: st[k] for k in ("factor_shard", "eigen_shard", "eigen_pending_shard")})
    ckpt.broadcast_state(TrainState(step=0, model=model, opt_state={}, kfac_state=st), w)
    out["broadcast"] = (before, _np({k: st[k] for k in before}))
    return out


def owner(rank, world, ops=None, runs=None, overlap=None, counts=None, ck=None):
    """Task of ``tests/test_torch_port_owner.py``: the sections given."""
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    w = data_parallel_world()
    out = {}
    for key, fn, arg in (("ops", _owner_ops, ops), ("runs", _owner_runs, runs),
                         ("overlap", _owner_overlap, overlap),
                         ("counts", _owner_collectives, counts),
                         ("ck", _owner_checkpoint, ck)):
        if arg is not None:
            out[key] = fn(rank, w, arg)
    return out


# ------------------------------------------------------ the expand lens


class _LensNet(torch.nn.Module):
    """A fused QKV projection under the expand lens (``fused``), or its
    oracle, three narrow projections concatenated, then a dense head."""

    def __init__(self, fused, cin, m, classes):
        from kfac_pytorch_tpu_torch.models.layers import KFACDense

        super().__init__()
        self.fused = fused
        if fused:
            self.qkv = KFACDense(cin, 3 * m, lens_splits=3)
        else:
            self.q, self.k, self.v = (KFACDense(cin, m) for _ in range(3))
        self.head = KFACDense(3 * m, classes)

    def forward(self, x):
        y = self.qkv(x) if self.fused else torch.cat([self.q(x), self.k(x), self.v(x)], -1)
        return self.head(torch.tanh(y))


def _lens_weights(unfused):
    """The fused net's weights from the unfused net's: q, k and v stacked
    along the out side (the rows of PyTorch's ``[out, in]`` weight)."""
    fused = {k: v for k, v in unfused.items() if k.startswith("head.")}
    for kind in ("weight", "bias"):
        fused[f"qkv.{kind}"] = torch.cat([unfused[f"{p}.{kind}"] for p in "qkv"])
    return fused


def lens(rank, world, weights, x, y, shape, cases, steps, ck_root):
    """The lensed net and its unfused oracle through ``make_train_step``
    under each case's levers on this rank's rows: the parameters after
    every step (the fused ones split back into q, k, v); then a lensed
    owner state through a checkpoint, and a replicated one re-homed."""
    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence, capture
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    w0 = _t(weights)
    xb, yb = torch.from_numpy(x[rank]), torch.from_numpy(y[rank]).long()
    out = {}
    kept = {}
    for case, kw in cases.items():
        runs = {}
        for fused in (True, False):
            model = _LensNet(fused, *shape)
            model.load_state_dict(_lens_weights(w0) if fused else w0)
            kw = {k: (torch.bfloat16 if v == "bf16" else v) for k, v in kw.items()}
            kfac = KFAC(layers=capture.discover_layers(model), device="cpu", damping=0.01,
                        fac_update_freq=1, kfac_update_freq=3, **kw)
            tx = make_sgd(0.9, 0.0)
            state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                               kfac_state=kfac.init(model))
            step_fn = make_train_step(model, tx, kfac)
            cad, traj = EigenRefreshCadence(kfac), []
            for i in range(steps):
                state, _ = step_fn(state, (xb, yb), 0.1, 0.01, **cad.flags_for_step(i))
                sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
                if fused:
                    for kind in ("weight", "bias"):
                        for p, part in zip("qkv", sd.pop(f"qkv.{kind}").chunk(3)):
                            sd[f"{p}.{kind}"] = part
                traj.append(_np(sd))
            runs["fused" if fused else "unfused"] = traj
            if fused:
                kept[case] = (kfac, state, model)
        out[case] = runs
    # the lensed state's "#s" names through a checkpoint: an owner state
    # round trip, and a replicated one re-homed into the owner rows
    okfac, ostate, model = kept["owner"]
    rkfac, rstate, _ = kept["replicated"]
    for name, st in (("owner", ostate), ("replicated", rstate)):
        ckpt.save_checkpoint(f"{ck_root}/{name}", 0, TrainState(
            step=steps, model=model, opt_state={}, kfac_state=st.kfac_state))
    dist.barrier()
    back = ckpt.restore_checkpoint(f"{ck_root}/owner", 0, TrainState(
        step=0, model=model, opt_state={}, kfac_state=okfac.init(model)), okfac)
    rehomed = ckpt.restore_checkpoint(f"{ck_root}/replicated", 0, TrainState(
        step=0, model=model, opt_state={}, kfac_state=okfac.init(model)), okfac)
    out["ck"] = {
        "round_trip": (_np(ostate.kfac_state), _np(back.kfac_state)),
        "rehomed": (_np(okfac.owner_state_from_replicated(rstate.kfac_state)),
                    _np(rehomed.kfac_state)),
        "names": sorted(rstate.kfac_state["factors"]),
    }
    return out


# ------------------------------------------- sequence-parallel attention


def _attn_cases(w, attn):
    """Each ``(kind, causal)`` case of ``attn`` on this rank's slice of the
    global q, k, v and output cotangent: ``(out, dq, dk, dv)``."""
    from kfac_pytorch_tpu_torch.parallel.context import make_context_parallel_attention
    from kfac_pytorch_tpu_torch.parallel.mesh import local_seq

    out = {}
    for kind, causal in attn["cases"]:
        q, k, v, do = attn["inputs"][kind]
        cols = local_seq(q.shape[1], w)
        q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, cols])).requires_grad_()
                   for a in (q, k, v))
        o = make_context_parallel_attention(w, kind)(q, k, v, causal=causal)
        o.backward(torch.from_numpy(np.ascontiguousarray(do[:, cols])))
        out[(kind, causal)] = _np({"out": o, "dq": q.grad, "dk": k.grad, "dv": v.grad})
    return out


def _lm_train(w, train):
    """The tiny transformer LM on this rank's rows and positions over the
    data×seq world ``w``: the loss and the parameters after every K-FAC
    step (refresh at step 0, capture at every step)."""
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.parallel.context import make_context_parallel_attention
    from kfac_pytorch_tpu_torch.parallel.mesh import local_rows, local_seq
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    out = {}
    for kind in train["kinds"]:
        model = transformer_lm.get_model(
            train["vocab"], attention_fn=make_context_parallel_attention(w, kind),
            seq_shards=w.seq_size, seq_index=w.seq_slot, **train["model"])
        model.load_state_dict(_t(train["weights"]))
        kfac = KFAC(layers=capture.discover_layers(model), device="cpu", damping=0.01,
                    fac_update_freq=1, kfac_update_freq=1, seq_parallel=w.seq_size)
        tx = make_sgd(0.9, 0.0)
        state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                           kfac_state=kfac.init(model))
        step_fn = make_train_step(model, tx, kfac, world=w)
        x, y = train["batch"]
        rows, cols = local_rows(x.shape[0], w), local_seq(x.shape[1], w)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows, cols])).long() for a in (x, y))
        losses, params = [], []
        for i in range(train["steps"]):
            state, m = step_fn(state, batch, 0.1, 0.01, update_factors=True, update_eigen=i == 0)
            losses.append(float(m["loss"]))
            params.append(_np({k: v.clone() for k, v in model.state_dict().items()}))
        out[kind] = {"losses": losses, "params": params}
    return out


def _seq_refusals(w):
    """What the port refuses on a world with a seq axis: the messages."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.training.step import make_sgd, make_train_step

    model = _tiny_mlp()
    out = {
        lever: _raised(lambda kw=kw: KFAC(layers=["fc1", "fc2"], device="cpu",
                                          seq_parallel=w.seq_size, **kw))
        for lever, kw in (("owner", {"factor_sharding": "owner"}),
                          ("comm_dtype", {"factor_comm_dtype": "bf16"}),
                          ("comm_freq", {"factor_comm_freq": 2}),
                          ("overlap", {"comm_overlap": True}))
    }
    out["grad_comm_dtype"] = _raised(lambda: make_train_step(
        model, make_sgd(), None, world=w, grad_comm_dtype=torch.bfloat16))
    return out


def context(rank, world, seq, attn=None, train=None, twin=None):
    """Task of ``tests/test_torch_port_context.py``: the attention cases on
    a world of one seq group, the LM's train steps on a data×seq world of
    ``seq`` slots, the refusals there, and the LM twin's runs."""
    from kfac_pytorch_tpu_torch.parallel.mesh import data_seq_world

    out = {}
    if attn is not None:
        out["attn"] = _attn_cases(data_seq_world(world), attn)
    w = data_seq_world(seq)
    assert (w.data_slot, w.seq_slot) == divmod(rank, seq)
    if train is not None:
        out["train"] = _lm_train(w, train)
    out["refusals"] = _seq_refusals(w)
    if twin is not None:
        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

        out["twin"] = {name: trainer.main(argv) for name, argv in twin.items()}
    return out


# ------------------------------------------------------------ the shard lenses


def lm_run(w, lm, model="dense", **kfac_kw):
    """The tiny transformer LM ``model`` (a key of ``lm``'s model options
    and weights; ``lm`` also holds the widths, batches and K-FAC
    hyperparameters) on this rank's rows of each global batch over the
    world ``w`` (a world of one outside a process group): the loss and
    the parameters after every step of the refresh cadence, and the state."""
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.parallel.mesh import local_rows
    from kfac_pytorch_tpu_torch.training.step import (
        TrainState,
        kfac_flags_for_step,
        make_sgd,
        make_train_step,
    )

    weights = lm["weights"][model]
    model = transformer_lm.get_model(lm["vocab"], **lm["models"][model], **lm["model"])
    model.load_state_dict(_t(weights))
    kfac = KFAC(layers=capture.discover_layers(model), device="cpu", **lm["hp"], **kfac_kw,
                process_group=w.group if w.distributed else None)
    tx = make_sgd(0.9, 0.0)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step_fn = make_train_step(model, tx, kfac, world=w)
    losses, params = [], []
    for i, (x, y) in enumerate(lm["batches"]):
        rows = local_rows(x.shape[0], w)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).long() for a in (x, y))
        state, m = step_fn(state, batch, 0.1, 0.01, **kfac_flags_for_step(i, kfac))
        losses.append(float(m["loss"]))
        params.append(_np({k: v.clone() for k, v in model.state_dict().items()}))
    return {"losses": losses, "params": params}, state, kfac


def _tensor_checkpoint(w, lm, root):
    """An owner-sharded run on the data×tensor world through a checkpoint:
    saved over the data subgroup, restored into a fresh state on every
    rank; ``(saved, restored)`` K-FAC states."""
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    _, state, kfac = lm_run(w, lm, factor_sharding="owner")
    ckpt.save_checkpoint(root, 0, state, w)
    dist.barrier()
    fresh = lm_run(w, {**lm, "batches": []}, factor_sharding="owner")[1]
    back = ckpt.restore_checkpoint(root, 0, fresh, kfac)
    return _np(state.kfac_state), _np(back.kfac_state)


def shardwise(rank, world, lm, cases, twin, ck_root):
    """Task of ``tests/test_torch_port_moe.py`` on 4 ranks: each case of
    ``cases`` (``{name: (model, kfac kwargs)}``, :func:`lm_run`) on the data×tensor
    world of 2 data slots and 2 tensor slots, and on a 2-rank data-parallel
    world of ranks 0 and 1 (the others wait); an owner checkpoint on the
    data×tensor world; the LM twin's ``twin`` argv on all four."""
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world, data_tensor_world

    tw = data_tensor_world(2)
    assert (tw.rank, tw.size) == (rank // 2, 2)
    assert dist.get_process_group_ranks(tw.group) == [rank % 2, rank % 2 + 2]
    pair = dist.new_group([0, 1])
    out = {"tensor": {}, "dp": {}}
    for name, (model, kw) in cases.items():
        out["tensor"][name] = lm_run(tw, lm, model, **kw)[0]
        if rank < 2:
            out["dp"][name] = lm_run(data_parallel_world(pair), lm, model, **kw)[0]
    out["ck"] = _tensor_checkpoint(tw, lm, ck_root)
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    out["twin"] = trainer.main(twin)
    return out


# the torch.distributed calls the 3-D collective count records, by group
_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast",
                "all_gather", "all_to_all_single", "batch_isend_irecv")


@contextlib.contextmanager
def _by_group(w, kfac):
    """Record every ``_COLLECTIVES`` call inside the block as ``(name,
    group, plane)``: ``group`` one of ``tensor``/``fsdp``/``data_fsdp``,
    ``plane`` ``factor`` while the preconditioner's factor exchange or
    flush runs, else ``step``."""
    groups = {id(w.tensor_group): "tensor", id(w.fsdp_group): "fsdp", id(w.group): "data_fsdp"}
    calls, plane = [], ["step"]
    real = {n: getattr(dist, n) for n in _COLLECTIVES}

    def wrap(n):
        def fn(*args, **kwargs):
            g = args[0][0].group if n == "batch_isend_irecv" else kwargs.get("group")
            calls.append((n, groups.get(id(g), "other"), plane[0]))
            return real[n](*args, **kwargs)
        return fn

    comm = kfac.factor_comm
    real_comm = {n: getattr(comm, n) for n in ("exchange_contribs", "flush")}

    def in_plane(f):
        def fn(*args, **kwargs):
            plane[0] = "factor"
            try:
                return f(*args, **kwargs)
            finally:
                plane[0] = "step"
        return fn

    for n in _COLLECTIVES:
        setattr(dist, n, wrap(n))
    for n, f in real_comm.items():
        setattr(comm, n, in_plane(f))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(dist, n, f)
        for n in real_comm:
            delattr(comm, n)


def lm3d_run(w, lm, steps, resume=None, save=None, count=None, grad_clip=0.0, draws=None,
             **kfac_kw):
    """The tiny ``tensor_parallel=2`` transformer LM on the data×fsdp×tensor
    world ``w`` from ``lm``'s one-process weights (its MLP kernels split
    over the tensor slots, the other parameters over the fsdp slots), this
    rank's rows of each global batch, the JAX ``_lm_3d_run`` flags (capture
    every step, refresh at the even ones, a deferred flush on each
    refresh), from a checkpoint ``resume=(root, epoch)`` when given. Saves
    ``save=(root, epoch, after_step)``; records the collectives of step
    ``count``; the int8 wire rounds on ``draws[step][bucket]`` (the JAX
    package's uniform draws) when given. Returns the losses, this rank's
    factors after each step, the gathered one-process parameters after the
    last step, the per-rank bytes and the collective calls."""
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.parallel.fsdp import FsdpParams
    from kfac_pytorch_tpu_torch.parallel.mesh import local_rows
    from kfac_pytorch_tpu_torch.shardwise import lm_param_shardings
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    model = transformer_lm.get_model(lm["vocab"], **lm["model"])
    model.load_state_dict(_t(lm["weights"]))
    names = capture.discover_layers(model)
    placements = lm_param_shardings({n: tuple(p.shape) for n, p in model.named_parameters()},
                                    names, w.tensor_size, w.fsdp_size)
    transformer_lm.split_tensor_layers(model, w)
    kfac = KFAC(layers=names, device="cpu", **lm["hp"], **kfac_kw, process_group=w.group,
                tensor_group=w.tensor_group)
    tx = make_sgd(0.9, 0.0)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model), fsdp=FsdpParams(model, placements, w))
    first = 0
    if resume is not None:
        state = ckpt.restore_checkpoint(resume[0], resume[1], state, kfac)
        first = state.step
    state.fsdp.shard_(state.opt_state)
    if draws is not None:
        kfac.factor_comm.draw = lambda step, b, first, n, device: torch.from_numpy(
            draws[step][b][first:first + n]).to(device)
    step_fn = make_train_step(model, tx, kfac, world=w, grad_clip=grad_clip)
    out = {"losses": [], "factors": [], "calls": None, "placements": placements,
           "kfac_placements": kfac.state_placements(state.kfac_state)}
    for i in range(first, steps):
        x, y = lm["batches"][i]
        rows = local_rows(x.shape[0], w)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).long() for a in (x, y))
        flags = dict(update_factors=True, update_eigen=i % 2 == 0)
        if kfac.factor_comm.defer and flags["update_eigen"]:
            flags["flush_factors"] = True
        with _by_group(w, kfac) if i == count else contextlib.nullcontext() as calls:
            state, m = step_fn(state, batch, 0.1, lm["hp"]["damping"], **flags)
        if i == count:
            out["calls"] = list(calls)
        out["losses"].append(float(m["loss"]))
        # copies: the next flush merges into the leaves
        out["factors"].append(_np({n: {k: v.clone() for k, v in f.items()}
                                   for n, f in state.kfac_state["factors"].items()}))
        if save is not None and i == save[2]:
            ckpt.save_checkpoint(save[0], save[1], state, w)
    out["params"] = _np(ckpt.global_payload(state, w)["model"])
    out["diagnostics"] = _np(state.kfac_state.get("diagnostics"))
    out["bytes"] = {
        "params": {n: (state.fsdp.parts[n] if n in state.fsdp else p).numel() * 4
                   for n, p in model.named_parameters()},
        "momentum": {n: m.numel() * 4 for n, m in state.opt_state.items()},
        "kfac": {key: {n: {k: v.numel() * 4 for k, v in e.items()}
                       for n, e in state.kfac_state[key].items() if n in kfac.shard_layers}
                 for key in ("factors", "eigen")},
    }
    return out


def fsdp(rank, world, lm, cases, sketches, ck_root, one_ck, twins, int8):
    """Task of ``tests/test_torch_port_fsdp.py`` on 4 ranks (data 1 × fsdp
    2 × tensor 2): each case of ``cases`` (``{name: kfac kwargs}``,
    :func:`lm3d_run`, the rsvd bases on the JAX ``sketches``), the plain one
    saving a checkpoint after step 1; the deferred int8 wire
    (``int8["kfac"]``) rounding on the JAX draws ``int8["draws"]``;
    a run resumed from ``one_ck`` (a one-process lens checkpoint); the
    diagnostics after 3 steps; one
    clipped capture step's collectives by group; the layout of the world;
    and the LM twin under each argv of ``twins`` with rank 0's printed
    mesh line; and the column-output gather's forward and backward."""
    import io

    from kfac_pytorch_tpu_torch.parallel.mesh import batch_axes, data_fsdp_tensor_world

    w = data_fsdp_tensor_world(2, 2)
    out = {"layout": {
        "rank": w.rank, "size": w.size, "tensor_rank": w.tensor_rank, "fsdp_rank": w.fsdp_rank,
        "group": dist.get_process_group_ranks(w.group),
        "tensor": dist.get_process_group_ranks(w.tensor_group),
        "fsdp": dist.get_process_group_ranks(w.fsdp_group),
        "batch_axes": batch_axes(w),
    }}
    # a column output gathered over the tensor slots (no row layer after it)
    from kfac_pytorch_tpu_torch.parallel.tensor import gather_from_tensor

    full = torch.arange(12.0).reshape(3, 4)
    x = full.chunk(2, -1)[w.tensor_rank].clone().requires_grad_(True)
    y = gather_from_tensor(x, w)
    (y * full).sum().backward()
    out["gather"] = (torch.equal(y.detach(), full),
                     torch.equal(x.grad, full.chunk(2, -1)[w.tensor_rank]))
    steps = len(lm["batches"])
    with _jax_sketches(sketches):
        out["cases"] = {
            name: lm3d_run(w, lm, steps, save=(ck_root, 0, 1) if name == "plain" else None, **kw)
            for name, kw in cases.items()}
    out["int8"] = lm3d_run(w, lm, steps, draws=int8["draws"], **int8["kfac"])
    out["resumed"] = lm3d_run(w, lm, steps, resume=(one_ck, 0))["losses"]
    out["diagnostics"] = lm3d_run(w, lm, 3, track_diagnostics=True)["diagnostics"]
    out["counted"] = lm3d_run(w, lm, 2, count=1, grad_clip=0.25)["calls"]
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    out["twins"] = []
    for argv in twins:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            hist = trainer.main(argv)
        out["twins"].append({"loss": hist["loss"], "printed": printed.getvalue()})
    return out


def multi(rank, world, parts, out_dir):
    """Several tasks in one spawn of the same ranks, in order: ``parts`` is
    ``{key: (task, inputs)}``. Each part's result is written to ``out_dir`` as
    soon as it is done (:func:`part` reads it before the spawn ends);
    returns ``{key: that task's result}``."""
    out = {}
    for key, (task, inputs) in parts.items():
        out[key] = TASKS[task](rank, world, **inputs)
        torch.save(out[key], f"{out_dir}/part-{key}-{rank}.tmp")
        os.replace(f"{out_dir}/part-{key}-{rank}.tmp", f"{out_dir}/part-{key}-{rank}.pt")
    return out


def part(handle, key):
    """The ranks' results of part ``key`` of a :func:`start`-ed ``multi``
    spawn, as soon as every rank has written it."""
    _, world, root, ctx, deadline = handle
    paths = [f"{root}/part-{key}-{r}.pt" for r in range(world)]
    while not all(os.path.exists(p) for p in paths):
        if ctx.join(timeout=1) and not all(os.path.exists(p) for p in paths):
            raise RuntimeError(f"the ranks ended without part {key!r}")
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"part {key!r} on {world} ranks did not finish")
    return [torch.load(p, weights_only=False) for p in paths]


def telemetry(rank, world, cases):
    """The rank-aware summary, once per case of ``cases``: rank ``r``
    observes ``case[r]`` (``{span: [seconds]}``; ragged counts, and the
    ranks' span names may differ) into a registry of its own; every rank
    gathers the reservoirs and builds the summary table."""
    from kfac_pytorch_tpu_torch.observability import Telemetry, export

    out = []
    for samples in cases:
        tel = Telemetry(enabled=True)
        for name, values in samples[rank].items():
            for v in values:
                tel.observe(name, v)
        merged = export._allgather_span_samples(tel.hists)
        out.append({"table": export.summary_table(tel),
                    "merged": {n: v.tolist() for n, v in merged.items()}})
    return out


def _elastic_build(w, weights, kw):
    """``(kfac, state, step_fn, cadence)`` of the overlap tests' ``_MLP``
    at ``weights`` on this world (a quiet drift signal under streaming)."""
    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    model = _MLP()
    model.load_state_dict(_t(weights))
    kfac = KFAC(layers=["fc1", "fc2"], device="cpu", damping=0.01, fac_update_freq=1, **kw)
    if kfac.solver == "streaming":
        kfac.stream_drift_signal = lambda: 0.0
    tx = make_sgd(0.9, 5e-4)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    return kfac, state, make_train_step(model, tx, kfac, sgd_hyper=(0.9, 5e-4)), \
        EigenRefreshCadence(kfac)


def _elastic_steps(fn, cad, state, batch, lo, hi):
    for step in range(lo, hi):
        state, _ = fn(state, batch, 0.05, 0.01, **cad.flags_for_step(step))
    return state


def _elastic_flat(state):
    """Every tensor of ``state`` (model, momentum, K-FAC), copied, with its
    path."""
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"opt/{k}": v.clone() for k, v in state.opt_state.items()})

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, torch.Tensor):
            out[path] = tree.clone()
        else:
            out[path] = tree

    walk(state.kfac_state, "kfac")
    return out


def _elastic_mid(w, weights, batch, cases, root):
    """Per case ``{name: (kfac kwargs, snapshot step, last step)}``: a run
    snapshot mid-interval and continued, and a fresh build resumed from the
    snapshot and continued; what the snapshot saw, what the resume found,
    and whether every tensor of the two ends is the same bits."""
    from kfac_pytorch_tpu_torch.elastic import Supervisor

    out = {}
    for case, (kw, at, end) in cases.items():
        kfac, state, fn, cad = _elastic_build(w, weights, kw)
        state = _elastic_steps(fn, cad, state, batch, 0, at)
        seen = {"cadence": cad.state_dict(), "keys": sorted(state.kfac_state),
                "sync_age": int(state.kfac_state.get("factor_sync_age", -1)),
                "local": _np({k: state.kfac_state[k] for k in ("factor_local", "wire_error")
                              if k in state.kfac_state}),
                "fold_steps": int(state.kfac_state.get("stream_fold_steps", -1))}
        Supervisor(f"{root}/{case}", kfac=kfac, cadence=cad).snapshot(at, state)
        final = _elastic_flat(_elastic_steps(fn, cad, state, batch, at, end))
        kfac2, state2, fn2, cad2 = _elastic_build(w, weights, kw)
        rstate, manifest, rstep = Supervisor(f"{root}/{case}", kfac=kfac2,
                                             cadence=cad2).scan_resume(state2)
        found = {"step": rstep, "cadence": cad2.state_dict(),
                 "manifest": {k: manifest[k] for k in ("world", "sharding", "packed_world",
                                                       "packed_replica_local")},
                 "local": _np({k: rstate.kfac_state[k] for k in ("factor_local", "wire_error")
                               if k in rstate.kfac_state})}
        resumed = _elastic_flat(_elastic_steps(fn2, cad2, rstate, batch, rstep, end))
        differ = sorted(k for k in final if not (torch.equal(final[k], resumed[k])
                                                 if isinstance(final[k], torch.Tensor)
                                                 else final[k] == resumed[k]))
        out[case] = {"seen": seen, "found": found, "differ": differ, "cadence_end":
                     (cad.state_dict(), cad2.state_dict())}
    return out


def _elastic_save(w, weights, batch, kw, at, root):
    """An owner run and its replicated twin, each snapshot at ``at``."""
    from kfac_pytorch_tpu_torch.elastic import Supervisor

    out = {}
    for mode in ("owner", "replicated"):
        kfac, state, fn, cad = _elastic_build(w, weights, {**kw, "factor_sharding": mode})
        state = _elastic_steps(fn, cad, state, batch, 0, at)
        Supervisor(f"{root}/{mode}", kfac=kfac, cadence=cad).snapshot(at, state)
        out[mode] = kfac.owner_sharded
    return out


def _elastic_resize(w, weights, batch, kw, end, root):
    """Both snapshots of :func:`_elastic_save` resumed on this world (the
    owner one through the resize replan) and continued to ``end``; the
    parameters, the replan gauge and the manifest's world."""
    from kfac_pytorch_tpu_torch.elastic import Supervisor
    from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry

    out = {}
    tel = get_telemetry()
    was, tel.enabled = tel.enabled, True
    try:
        for mode in ("owner", "replicated"):
            kfac, state, fn, cad = _elastic_build(w, weights, {**kw, "factor_sharding": mode})
            rstate, manifest, rstep = Supervisor(f"{root}/{mode}", kfac=kfac,
                                                 cadence=cad).scan_resume(state)
            out[f"{mode}_replans"] = tel.gauges.get("kfac/replan_count")
            rstate = _elastic_steps(fn, cad, rstate, batch, rstep, end)
            out[mode] = {"params": _np(dict(rstate.model.state_dict())),
                         "world": manifest["world"], "step": rstep,
                         "keys": sorted(rstate.kfac_state)}
    finally:
        tel.enabled = was
    return out


def _elastic_twin(argv, kill, root, runs=("full", "killed", "resumed")):
    """The LM twin with ``argv`` run through, killed by the fault injector
    in signal mode at step ``kill``, and resumed (those of the three
    ``runs`` given): their losses and the killed run's manifest."""
    import signal

    from kfac_pytorch_tpu_torch.elastic import state_io
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    out = {}
    for name, at, save_dir in (("full", None, "full"), ("killed", kill, "k"),
                               ("resumed", None, "k")):
        if name not in runs:
            continue
        handler = signal.getsignal(signal.SIGTERM)
        if at is not None:
            os.environ.update(KFAC_FAULT_KILL_AT_STEP=str(at), KFAC_FAULT_KILL_MODE="signal")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                hist = trainer.main([*argv, "--preempt-save-dir", f"{root}/{save_dir}",
                                     "--snapshot-every", str(kill)])
        finally:
            os.environ.pop("KFAC_FAULT_KILL_AT_STEP", None)
            os.environ.pop("KFAC_FAULT_KILL_MODE", None)
            signal.signal(signal.SIGTERM, handler)
        out[name] = hist["loss"]
        if name == "killed":
            manifest = state_io.load_manifest(state_io.snapshot_dir(f"{root}/k", kill))
            out["manifest"] = {k: manifest.get(k) for k in ("world", "sharding", "packed_world",
                                                             "step")}
    return out


def elastic(rank, world, weights, x, y, mid=None, save=None, resize=None, twin=None):
    """Task of ``tests/test_torch_port_elastic_ranks.py``: the sections
    given, on this rank's batch."""
    batch = (torch.from_numpy(x[rank % len(x)]), torch.from_numpy(y[rank % len(y)]))
    out = {}
    if mid is not None:
        out["mid"] = _elastic_mid(world, weights, batch, **mid)
    if save is not None:
        out["save"] = _elastic_save(world, weights, batch, **save)
    if resize is not None:
        out["resize"] = _elastic_resize(world, weights, batch, **resize)
    if twin is not None:
        out["twin"] = {name: _elastic_twin(**kw) for name, kw in twin.items()}
    return out


# ------------------------------------------------------- curvature service


def _svc_net(sizes):
    """``tests/test_service.py``'s dense model: ``KFACDense`` layers ``l0``, ``l1``, ..."""
    from kfac_pytorch_tpu_torch.models.layers import KFACDense

    net = torch.nn.Module()
    for i, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
        net.add_module(f"l{i}", KFACDense(nin, nout))
    return net


def _svc_inputs(stats):
    """``(a_contribs, g_factor_stats, grads)`` of one step's numpy statistics
    ``{layer: (A contribution, G statistic, kernel grad [in, out], bias grad)}``."""
    a = {n: torch.from_numpy(v[0]) for n, v in stats.items()}
    g = {n: torch.from_numpy(v[1]) for n, v in stats.items()}
    grads = {}
    for n, v in stats.items():
        grads[f"{n}.weight"] = torch.from_numpy(np.ascontiguousarray(v[2].T))
        grads[f"{n}.bias"] = torch.from_numpy(v[3])
    return a, g, grads


@contextlib.contextmanager
def _eigh_calls():
    """Count ``torch.linalg.eigh`` calls (every refresh path ends in it)."""
    calls = [0]
    real = torch.linalg.eigh

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    torch.linalg.eigh = counted
    try:
        yield calls
    finally:
        torch.linalg.eigh = real


def service_run(kfac, sizes, steps, svc):
    """``KFAC.update`` over the cadence's flags with the service's hooks
    around each step: the preconditioned gradients of every step (numpy)."""
    from kfac_pytorch_tpu_torch import EigenRefreshCadence

    state = kfac.init(_svc_net(sizes))
    cad = svc.cadence if svc.cadence is not None else EigenRefreshCadence(kfac)
    out = []
    for step, stats in enumerate(steps):
        a, g, grads = _svc_inputs(stats)
        state = svc.before_step(step, state)
        flags = cad.flags_for_step(step)
        new, state = kfac.update(grads, state, a_contribs=a, g_factor_stats=g, lr=0.1,
                                 damping=0.003, **flags)
        svc.after_step(step, state)
        out.append(_np(new))
    return out


def service(rank, world, sizes, steps, hp, box, twin=None):
    """Task of ``tests/test_torch_port_service.py``: the trailing rank of
    the world carved as the curvature worker (``service_world``) serving
    the training ranks' ``HostMailbox`` pair under ``box``, at staleness 0;
    or, with ``twin``, the CIFAR twin's ``--service-devices 1`` run twice."""
    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence
    from kfac_pytorch_tpu_torch.parallel import launch
    from kfac_pytorch_tpu_torch.parallel.mesh import service_world
    from kfac_pytorch_tpu_torch.service import CurvatureService, CurvatureWorker, HostMailbox

    if twin is not None:
        from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar

        runs = []
        for _ in range(2):
            with _eigh_calls() as eighs, contextlib.redirect_stdout(io.StringIO()):
                hist = cifar.main(twin)
            runs.append({"loss": hist["loss"], "service": hist.get("service"),
                         "refresh_ms": hist.get("refresh_ms"), "eigh": eighs[0]})
        return {"twin": runs}
    w, workers = service_world(1)
    launch.set_world_group(w.group)
    try:
        kfac = KFAC(device="cpu", service_devices=1, process_group=w.group, **hp)
        out = {"world": (w.size, w.rank), "workers": workers}
        calls, restore = _counting(_COLLECTIVES)
        try:
            with _eigh_calls() as eighs:
                if rank in workers:
                    worker = CurvatureWorker(kfac, HostMailbox(box, "job0-factors"),
                                             HostMailbox(box, "job0-basis"))
                    out["served"] = worker.serve(idle_timeout_s=120.0)
                else:
                    svc = CurvatureService(kfac, EigenRefreshCadence(kfac), mailbox_dir=box,
                                           run_worker=False, staleness_budget=0)
                    out["updates"] = service_run(kfac, sizes, steps, svc)
                    out["installs"] = svc.record["installs"]
                    svc.close()
        finally:
            restore()
        out["eigh"] = eighs[0]
        out["collectives"] = dict(calls)
        if rank not in workers:
            out["owner"] = _raised(lambda: KFAC(device="cpu", service_devices=1,
                                                process_group=w.group,
                                                factor_sharding="owner"))
    finally:
        launch.set_world_group(None)
    return out


def compile_cache(rank, world, configs):
    """``compile_cache.expected_step_variants`` of a ``KFAC`` built on this
    world for each ``(name, kfac kwargs, Plan kwargs or None, autotune
    candidates)`` of ``configs``: ``{name: count}``."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.compile_cache import expected_step_variants
    from kfac_pytorch_tpu_torch.planner import Plan

    out = {}
    for name, kw, plan, autotune in configs:
        kfac = KFAC(damping=0.01, device="cpu", **kw)
        out[name] = expected_step_variants(
            kfac, plan=None if plan is None else Plan(**plan), autotune_candidates=autotune)
    return out


TASKS = {"ops": ops, "steps": steps, "twins": twins, "solver_ops": solver_ops, "comm": comm,
         "owner": owner, "lens": lens, "context": context, "shardwise": shardwise, "fsdp": fsdp,
         "multi": multi, "telemetry": telemetry, "elastic": elastic, "service": service,
         "compile_cache": compile_cache}
