"""Rank bodies of ``tests/test_torch_port_distributed.py`` (not a test file).

Each task runs in every rank of a gloo world started by :func:`spawn`
through ``torch.multiprocessing`` with a file store under the test's
``tmp_path`` and one torch thread per rank. This module imports only torch
and the port, so the spawned ranks start without JAX; the test process
holds the JAX side. A task's inputs and per-rank results travel as
``torch.save`` files.
"""

from __future__ import annotations

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


def spawn(task, world, root, **inputs):
    """Run ``task`` on ``world`` gloo ranks; returns the ranks' results."""
    os.makedirs(root, exist_ok=True)
    torch.save(inputs, f"{root}/inputs.pt")
    ctx = mp.spawn(_run, args=(world, str(root), task), nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} on {world} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(f"{root}/result-{r}.pt", weights_only=False) for r in range(world)]


def _t(tree):
    """numpy leaves → torch tensors, recursively."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


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


TASKS = {"ops": ops, "steps": steps, "twins": twins, "solver_ops": solver_ops}
