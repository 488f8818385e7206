"""The factor-communication plane: bucketed, compressed, deferrable means.

Port of ``kfac_pytorch_tpu/parallel/comm.py``. The ranks' K-FAC factor
statistics cross the wire through one plane that owns these levers:

* **Tensor fusion.** Every per-layer A/G leaf gets a slice of a few flat
  buckets (``parallel.assignment.plan_factor_buckets``) and one
  ``all_reduce`` moves each bucket, where the port's first data-parallel
  step issued one flat mean per dtype of unbounded size.
* **Wire compression.** ``factor_comm_dtype="bf16"`` casts only the bucket
  payload for the wire; the float32 running averages are untouched.
* **Deferred reduction.** ``factor_comm_freq=N`` skips the per-step
  exchange: each rank keeps the running averages of its own statistics,
  and :meth:`FactorComm.flush` merges them every N capture steps and before
  every eigen refresh (``ops.factors.merge_running_avg_buckets``, exact by
  the EMA's linearity). ``"int8"`` rides the flush only: each bucket
  crosses as block-scaled, stochastically rounded int8 codes plus float32
  scales (an ``all_gather``), and each rank carries what its codes rounded
  away into the next flush (error feedback, ``state["wire_error"]``).
* **Owner sharding** (``sharded``, ``KFAC(factor_sharding="owner")``).
  :meth:`FactorComm.scatter_merge` reduce-scatters each rank's statistics
  onto the owner's rows of the shard stacks
  (``parallel.assignment.plan_factor_shards``), one
  ``reduce_scatter_tensor`` per wire bucket, the bf16 wire on the payload
  only; the per-step exchange then hands ``KFAC.update`` the local
  statistics.
* **Overlap** (``overlap``, ``KFAC(comm_overlap=True)``). The buckets'
  means are issued in reverse bucket order (the last layers' statistics,
  ready first in the backward pass, go first), all of them
  ``async_op=True`` before any is waited on; the train steps start them
  before the gradient mean (:meth:`FactorComm.start_exchange`). Every
  bucket is the same collective on the same payload, so the values are
  bitwise those of the serial order. ``KFAC_OVERLAP_PPERMUTE=1`` takes
  :func:`ring_allreduce_mean` instead, a ring of point-to-point hops
  (``batch_isend_irecv``), as the JAX package takes its ``ppermute`` ring:
  another summation order, so equal to the mean only to reassociation.

Every leaf shape capture produces rides the buckets: the shard lenses'
stacks (``[T, m/T, m/T]``, ``[T, a/T, a/T]``, ``[E, ·, ·]``) and an MoE
bank's A pair ``{"S", "f"}`` (both leaves averaged before the weighted
EMA); the deferred flush and its int8 wire take the column and row
stacks, and ``KFAC`` refuses them for an MoE bank (its EMA is not linear).
On a data×tensor world the plane's group is the data subgroup.

The plane is inert on a world of one (``multi_device`` is False), NCCL's
world of one included: no factor collective is issued there. The JAX
package's stochastic rounding draws from threefry; the port cannot
reproduce it, so :meth:`FactorComm.draw` seeds a generator on the bucket's
device from ``(QUANT_SEED, step, bucket, chunk)``, the same on every rank,
and :func:`quantize_bucket` takes its draw ``u`` explicitly (the parity
tests inject the JAX package's). The plane publishes the
``kfac/factor_wire_bytes`` and ``kfac/factor_collectives`` gauges (also
kept as ``last_wire_bytes``, ``last_collectives``), the int8 flush the
``kfac/wire_quant_error_norm`` gauge (a device scalar, read at export), and
each exchange a ``trace/kfac/factor_comm`` span (host dispatch); the
cadence publishes ``kfac/overlap_mode``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.observability.telemetry import get_telemetry
from kfac_pytorch_tpu_torch.ops import factors as factor_ops
from kfac_pytorch_tpu_torch.parallel.assignment import FactorBucket, plan_factor_buckets
from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.shardwise import lenses

# Block-scaled int8 wire: each bucket is quantized per contiguous 256-element
# block against its own max-abs scale (4 / 256 = 1.6% of the payload, so the
# int8 wire is ~0.51x the bf16 bytes), which bounds the dynamic range one
# scale covers when A and G leaves of different layers share a bucket.
QUANT_BLOCK = 256
# the JAX package's base seed of the stochastic rounding (arxiv 2107.06533)
QUANT_SEED = 21070653
# blocks quantized per pass: the draw and the quantizer's temporaries stay a
# few hundred MB while a 4.4 GB bucket (WikiText-2's decoder G) goes through
QUANT_CHUNK_BLOCKS = 1 << 16

#: ``KFAC(factor_comm_dtype=...)`` names and dtypes → the wire dtype
FACTOR_COMM_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def resolve_factor_comm_dtype(value) -> torch.dtype:
    """The wire dtype of a ``factor_comm_dtype`` (a name or a dtype), or
    ``ValueError``."""
    if isinstance(value, torch.dtype) and value in FACTOR_COMM_DTYPES.values():
        return value
    if isinstance(value, str) and value.lower() in FACTOR_COMM_DTYPES:
        return FACTOR_COMM_DTYPES[value.lower()]
    raise ValueError(f"Invalid factor_comm_dtype: {value}")


def quantize_bucket(buf: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled stochastic int8 quantization of one flat float32 bucket:
    ``(codes [nblocks, 256] int8, scales [nblocks, 1] float32)``.

    ``codes = clip(floor(x / scale + u), −127, 127)`` with ``scale =
    amax / 127`` per block and the draw ``u ~ U[0, 1)`` of shape
    ``[nblocks, 256]``: unbiased, ``E[codes·scale] = x``. An all-zero block
    quantizes against scale 1 to zero codes."""
    n = buf.numel()
    pad = (-n) % QUANT_BLOCK
    x = F.pad(buf, (0, pad)) if pad else buf
    blocks = x.reshape(-1, QUANT_BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.floor(blocks / scale + u), -127.0, 127.0)
    return codes.to(torch.int8), scale


def dequantize_bucket(codes: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`quantize_bucket`: the float32 ``[n]`` payload."""
    return (codes.float() * scale).reshape(-1)[:n]


def quant_wire_bytes(sizes: Sequence[int]) -> int:
    """Exact int8 wire bytes of buckets of ``sizes`` elements: one byte per
    element plus four per 256-element block scale."""
    return sum(s + (-(-s // QUANT_BLOCK)) * 4 for s in sizes)


def publish_wire_quant_error(wire_error: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the error-feedback residuals onto the
    ``kfac/wire_quant_error_norm`` gauge, as a 0-d device tensor (no host
    sync; the registry reads it at export), and returned. A norm that
    trends upward instead of hovering says the int8 wire fights the factor
    dynamics."""
    norm = torch.sqrt(sum(torch.sum(v.float() ** 2) for v in wire_error.values()))
    get_telemetry().set_gauge("kfac/wire_quant_error_norm", norm)
    return norm


def flatten_buckets(
    leaves: Sequence[torch.Tensor], plan: Tuple[FactorBucket, ...]
) -> List[torch.Tensor]:
    """Pack stat leaves into the plan's flat wire buffers (a lone leaf's
    buffer is a view of it)."""
    bufs = []
    for bucket in plan:
        parts = [leaves[e.index].reshape(-1) for e in bucket.entries]
        bufs.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return bufs


def unflatten_buckets(
    bufs: Sequence[torch.Tensor], plan: Tuple[FactorBucket, ...],
    like_leaves: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Slice bucket buffers back into leaves (inverse of
    :func:`flatten_buckets`); ``like_leaves`` supplies any leaf the plan
    does not cover."""
    out = list(like_leaves)
    for bucket, buf in zip(plan, bufs):
        for e in bucket.entries:
            out[e.index] = buf[e.offset:e.offset + e.size].reshape(e.shape)
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in insertion order (the port's leaf
    order: layers in module order, a layer's A before its G)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """A nested dict of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(like)


def per_layer_pmean_reference(tree, world: World):
    """The pre-plane wire: one float32 ``all_reduce`` mean per stat leaf.
    The parity oracle of the bucketed float32 mean; unused by the port."""
    out = []
    for leaf in tree_leaves(tree):
        t = leaf.clone()
        world.all_reduce_sum_(t)
        out.append(t / world.size)
    return tree_unflatten(tree, out)


def ring_allreduce_mean(buf: torch.Tensor, world: World,
                        wire_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The ranks' mean of one flat bucket by a ring of point-to-point hops
    (the JAX package's ``ppermute`` ring): ``world − 1`` send-and-add hops,
    after which rank ``d`` holds the whole sum of chunk ``(d + 1) mod
    world``, then ``world − 1`` hops that pass the finished chunks on. Each
    hop is one ``batch_isend_irecv`` of a send to the next rank and a
    receive from the previous one. The sum is taken in ring order, in
    ``wire_dtype`` when given: equal to the all-reduce mean only to
    reassociation."""
    w = world.size
    if not world.distributed or w <= 1:
        return buf.clone()
    r = world.rank
    n = buf.numel()
    x = F.pad(buf, (0, (-n) % w))
    if wire_dtype is not None:
        x = x.to(wire_dtype)
    acc = x.reshape(w, -1).clone()
    peer = (lambda i: i) if world.group is None else (
        lambda i: dist.get_global_rank(world.group, i))
    nxt, prv = peer((r + 1) % w), peer((r - 1) % w)

    def hop(send):
        recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, world.group),
            dist.P2POp(dist.irecv, recv, prv, world.group),
        ]):
            work.wait()
        return recv

    for s in range(w - 1):
        acc[(r - s - 1) % w] += hop(acc[(r - s) % w].clone())
    for s in range(w - 1):
        acc[(r - s) % w] = hop(acc[(r + 1 - s) % w].clone())
    return (acc.reshape(-1).float() / w).to(buf.dtype)[:n]


def _draw_seed(step: int, bucket: int, chunk: int) -> int:
    s = QUANT_SEED
    for v in (step, bucket, chunk):
        s = (s * 1_000_003 + int(v)) % (1 << 63)
    return s


class FactorComm:
    """The factor-statistics exchange plane of one ``KFAC``.

    Keeps the bucket layout (cached per leaf-shape signature), the wire
    dtype and the deferral policy. :meth:`exchange_contribs` is the
    per-capture-step exchange (a no-op when deferred); :meth:`flush` merges
    the ranks' running averages in deferred mode. ``last_wire_bytes`` and
    ``last_collectives`` hold the last exchange's planned bytes and bucket
    count."""

    def __init__(self, world: World, comm_dtype: Any = "f32", comm_freq: int = 1,
                 max_bucket_elems: int = 1 << 20, sharded: bool = False,
                 overlap: bool = False):
        if int(comm_freq) < 1:
            raise ValueError(f"Invalid factor_comm_freq: {comm_freq}")
        self.world = world
        self.comm_dtype = resolve_factor_comm_dtype(comm_dtype)
        self.comm_freq = int(comm_freq)
        self.max_bucket_elems = int(max_bucket_elems)
        # owner sharding: the statistics reduce-scatter onto their owners
        # (scatter_merge) and the per-step exchange returns the local ones
        self.sharded = bool(sharded)
        # the overlap plane: reversed, asynchronous bucket issue; the
        # point-to-point ring instead with KFAC_OVERLAP_PPERMUTE=1
        self.overlap = bool(overlap)
        self.overlap_ppermute = self.overlap and os.environ.get(
            "KFAC_OVERLAP_PPERMUTE", "") not in ("", "0")
        self.last_wire_bytes: Optional[int] = None
        self.last_collectives: Optional[int] = None
        self._plans: Dict[Any, Tuple[FactorBucket, ...]] = {}
        self._generators: Dict[Any, torch.Generator] = {}
        # the stochastic rounding's uniform draw of one chunk of a bucket:
        # draw(step, bucket, first_block, nblocks, device) -> [nblocks, 256]
        self.draw: Callable[..., torch.Tensor] = self._default_draw

    # -- policy ---------------------------------------------------------

    @property
    def multi_device(self) -> bool:
        """More than one rank: otherwise the plane issues nothing."""
        return self.world.size > 1

    @property
    def defer(self) -> bool:
        """Deferred reduction: statistics stay local between flushes."""
        return self.comm_freq > 1 and self.multi_device

    @property
    def overlap_mode(self) -> int:
        """The JAX package's ``kfac/overlap_mode`` gauge: 0 serial, 1 the
        reversed asynchronous bucket means, 2 the point-to-point ring."""
        if not (self.overlap and self.multi_device):
            return 0
        return 2 if self.overlap_ppermute else 1

    @property
    def overlaps_exchange(self) -> bool:
        """The train steps start the per-step exchange before the gradient
        mean (a capture step's bucket means, not deferred, not sharded)."""
        return self.overlap and self.multi_device and not (self.defer or self.sharded)

    @property
    def quantized(self) -> bool:
        """The int8 wire (deferred flushes only, with error feedback)."""
        return self.comm_dtype == torch.int8

    def flush_due(self, step: int, fac_update_freq: int) -> bool:
        """A deferred flush is due at ``step``: every ``comm_freq``-th
        capture step (the cadence also forces one before eigen work)."""
        return step % fac_update_freq == 0 and (step // fac_update_freq) % self.comm_freq == 0

    # -- plan -----------------------------------------------------------

    def _plan_for(self, leaves: Sequence[torch.Tensor]) -> Tuple[FactorBucket, ...]:
        key = tuple(tuple(leaf.shape) for leaf in leaves)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = plan_factor_buckets(
                [leaf.shape for leaf in leaves], self.max_bucket_elems
            )
        sizes = [b.size for b in plan]
        if self.quantized:
            self.last_wire_bytes = quant_wire_bytes(sizes)
        else:
            self.last_wire_bytes = sum(sizes) * self.comm_dtype.itemsize
        self.last_collectives = len(plan)
        self._publish()
        return plan

    def _publish(self) -> None:
        tel = get_telemetry()
        tel.set_gauge("kfac/factor_wire_bytes", self.last_wire_bytes)
        tel.set_gauge("kfac/factor_collectives", self.last_collectives)

    # -- wire ops -------------------------------------------------------

    def allreduce(self, tree):
        """The bucketed mean over the ranks of a stat tree (nested dicts of
        tensors), in the wire dtype; a new tree of the same structure."""
        return self.start_allreduce(tree)()

    def start_allreduce(self, tree) -> Callable[[], Any]:
        """Issue :meth:`allreduce`'s bucket means and return the function
        that finishes it. Serial, each mean completes here; under
        ``overlap`` the buckets go in reverse order, each an asynchronous
        ``all_reduce``, and the returned function waits on them (the ring,
        ``overlap_ppermute``, completes here)."""
        if self.quantized:
            raise ValueError(
                "int8 factor wire routes through FactorComm.flush(..., "
                "wire_error=...) only — the plain bucketed mean cannot "
                "reduce int8 codes"
            )
        with get_telemetry().span("trace/kfac/factor_comm"):
            return self._start_allreduce(tree)

    def _start_allreduce(self, tree) -> Callable[[], Any]:
        leaves = tree_leaves(tree)
        plan = self._plan_for(leaves)
        wire = None if self.comm_dtype == torch.float32 else self.comm_dtype
        bufs = flatten_buckets(leaves, plan)

        def done(merged):
            return lambda: tree_unflatten(tree, unflatten_buckets(merged, plan, leaves))

        if not self.overlap:
            return done(factor_ops.merge_running_avg_buckets(bufs, wire, self.world))
        order = list(range(len(bufs)))[::-1]
        merged: List[Optional[torch.Tensor]] = [None] * len(bufs)
        if self.overlap_ppermute:
            for i in order:
                merged[i] = ring_allreduce_mean(bufs[i], self.world, wire)
            return done(merged)
        # the wire buffers and their work, exactly merge_running_avg_buckets'
        # arithmetic around the same collective
        pending = []
        for i in order:
            w = bufs[i].clone() if wire is None else bufs[i].to(wire)
            pending.append((i, w, self.world.all_reduce_sum_async(w)))

        def finish():
            for i, w, work in pending:
                if work is not None:
                    work.wait()
                merged[i] = w.div_(self.world.size).to(bufs[i].dtype)
            return done(merged)()

        return finish

    def exchange_contribs(
        self, a_contribs: Dict[str, torch.Tensor], g_stats: Dict[str, torch.Tensor]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The per-capture-step exchange: the A and G dicts as one stat tree,
        so both share buckets. Deferred mode returns the local statistics
        unchanged, and so does owner sharding: :meth:`scatter_merge`, from
        ``KFAC.update``, is its exchange."""
        return self.start_exchange(a_contribs, g_stats)()

    def start_exchange(
        self, a_contribs: Dict[str, torch.Tensor], g_stats: Dict[str, torch.Tensor]
    ) -> Callable[[], Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        """:meth:`exchange_contribs` issued now; the returned function
        finishes it: the overlap plane's train steps start it before the
        gradient mean and finish it before ``KFAC.update`` reads the
        statistics."""
        if self.defer or self.sharded:
            return lambda: (a_contribs, g_stats)
        finish = self.start_allreduce(capture.factor_stat_tree(a_contribs, g_stats))
        return lambda: capture.split_factor_stat_tree(finish())

    def scatter_merge(self, payload, shard: Dict[str, torch.Tensor], plan, decay
                      ) -> Dict[str, torch.Tensor]:
        """Reduce-scatter each rank's statistics onto the owners' shard rows
        (owner sharding, DP-KFAC): ``shard ← decay·shard + mean_r(payload_r)``
        on this rank's rows.

        ``payload`` is this rank's ``{layer: {"A", "G"}}`` statistics
        (``(1−α)·contrib`` every capture step, or the deferred local running
        averages at a flush, ``A`` a vector for a diagonal-A layer);
        ``shard`` holds this rank's ``{"n<size>": [rows, n, n], "v<size>":
        [rows, n]}`` rows of ``plan``'s stacks; ``decay`` is ``α``, or
        ``α^m`` after ``m`` deferred capture steps (exact by the EMA's
        linearity). Each wire bucket of ``plan.wire_buckets`` is one
        ``[world, width]`` buffer, the owner's rows in the owner's row, and
        one ``reduce_scatter_tensor`` (the wire dtype on the payload only);
        a pad row takes a zero payload and only decays."""
        world = self.world
        wire = None if self.comm_dtype == torch.float32 else self.comm_dtype
        self.last_wire_bytes = (
            sum(b.size for b in plan.wire_buckets) * plan.world * self.comm_dtype.itemsize
        )
        self.last_collectives = len(plan.wire_buckets)
        self._publish()
        wgroups = plan.wire_groups()
        device = next(iter(shard.values())).device
        groups: Dict[str, torch.Tensor] = {}
        for key, n, rows, elems in wgroups:
            flat = torch.zeros((plan.world * rows, elems), dtype=torch.float32, device=device)
            for s in plan.group_slots(n, diag=key.startswith("v")):
                flat[s.owner * rows + s.row] = payload[s.name][s.factor].reshape(-1)
            groups[key] = flat.view(plan.world, rows * elems)
        new_shard = dict(shard)
        with get_telemetry().span("trace/kfac/factor_comm"):
            for bucket in plan.wire_buckets:
                parts = [groups[wgroups[e.index][0]] for e in bucket.entries]
                buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
                if wire is not None:
                    buf = buf.to(wire)
                red = world.reduce_scatter_mean(buf)
                for e in bucket.entries:
                    key = wgroups[e.index][0]
                    seg = red[e.offset:e.offset + e.size].view(shard[key].shape)
                    new_shard[key] = decay * shard[key] + seg
        return new_shard

    def _tensor_split(self, facs) -> List[bool]:
        """Per leaf of the factor tree ``facs`` (``{layer: {key: tensor}}``,
        :func:`tree_leaves` order), whether the world's genuine tensor axis
        splits it: this rank then holds its tensor slot's blocks of the
        stack (a column layer's G side, a row layer's A side)."""
        t = self.world.tensor_size
        return [t > 1 and lenses.factor_leaf_spec(
                    name, key, (capture.split_shard_name(name)[2],), t) is not None
                for name, entry in facs.items() for key, v in entry.items()
                for _ in tree_leaves(v)]

    def wire_error_init(self, facs) -> Dict[str, torch.Tensor]:
        """Zero error-feedback residuals, one float32 buffer per bucket of
        the plan of ``facs``' one-process shapes (the tensor-split stacks
        whole, as :meth:`_merge_quantized` flushes them), keyed ``"b<i>"``
        (the plan is a function of the leaf shapes, so the keys are stable
        across restarts)."""
        leaves = tree_leaves(facs)
        t = self.world.tensor_size
        shapes = [(leaf.shape[0] * t, *leaf.shape[1:]) if split else leaf.shape
                  for leaf, split in zip(leaves, self._tensor_split(facs))]
        plan = plan_factor_buckets(shapes, self.max_bucket_elems)
        return {f"b{i}": torch.zeros(b.size, dtype=torch.float32, device=leaves[0].device)
                for i, b in enumerate(plan)}

    def _default_draw(self, step: int, bucket: int, first_block: int, nblocks: int,
                      device) -> torch.Tensor:
        device = torch.device(device)
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
        gen.manual_seed(_draw_seed(step, bucket, first_block // QUANT_CHUNK_BLOCKS))
        return torch.rand((nblocks, QUANT_BLOCK), generator=gen, device=device,
                          dtype=torch.float32)

    def quantize_payload_(self, payload: torch.Tensor, step: int, bucket: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize a flat float32 payload in passes of
        ``QUANT_CHUNK_BLOCKS`` blocks, each with its own draw, and turn the
        payload into its residual ``payload − dequantized`` in place:
        ``(codes [nblocks, 256] int8, scales [nblocks, 1])``, with no second
        full float32 copy of the bucket."""
        n = payload.numel()
        nblocks = -(-n // QUANT_BLOCK)
        codes = torch.empty((nblocks, QUANT_BLOCK), dtype=torch.int8, device=payload.device)
        scale = torch.empty((nblocks, 1), dtype=torch.float32, device=payload.device)
        for first in range(0, nblocks, QUANT_CHUNK_BLOCKS):
            rows = min(QUANT_CHUNK_BLOCKS, nblocks - first)
            part = payload[first * QUANT_BLOCK:min((first + rows) * QUANT_BLOCK, n)]
            c, s = quantize_bucket(part, self.draw(step, bucket, first, rows, payload.device))
            codes[first:first + rows] = c
            scale[first:first + rows] = s
            part.sub_(dequantize_bucket(c, s, part.numel()))
        return codes, scale

    def _merge_quantized(self, tree, wire_error: Dict[str, torch.Tensor], step: int):
        """The int8 bucket merge with error feedback: per bucket, fold the
        carried residual into the payload, quantize it, put only the int8
        codes and the float32 scales on the wire (``all_gather``: a sum
        would widen the codes first), and average the dequantized payloads
        locally, in rank order. The new residual is this rank's payload
        minus its own dequantized codes. Returns ``(tree, new_wire_error)``.

        In place, so that a 4.4 GB bucket costs no float32 copy: each payload
        is formed in its ``wire_error`` buffer, which becomes the new
        residual, and the mean is written into the bucket's storage, which
        for a bucket of one leaf is that leaf of ``tree``.

        On a genuine tensor axis the tensor-split stacks are gathered over
        the tensor slots first and the whole tree is flushed, as the JAX
        package flushes the gathered tree on every tensor device: the slots
        quantize one payload, so the replicated factors keep the same bits
        on every slot; each slot keeps its own blocks of the merged stacks."""
        world = self.world
        local = tree_leaves(tree)
        split = self._tensor_split(tree)
        leaves = [world.tensor_all_gather(leaf, 0) if s else leaf
                  for leaf, s in zip(local, split)]
        plan = self._plan_for(leaves)
        merged = []
        for i, buf in enumerate(flatten_buckets(leaves, plan)):
            n = buf.numel()
            payload = wire_error[f"b{i}"].add_(buf)
            codes, scale = self.quantize_payload_(payload, step, i)
            all_codes = [torch.empty_like(codes) for _ in range(world.size)]
            all_scale = [torch.empty_like(scale) for _ in range(world.size)]
            dist.all_gather(all_codes, codes, group=world.group)
            dist.all_gather(all_scale, scale, group=world.group)
            del codes, scale
            for first in range(0, all_codes[0].shape[0], QUANT_CHUNK_BLOCKS):
                rows = slice(first, first + QUANT_CHUNK_BLOCKS)
                acc = all_codes[0][rows].float() * all_scale[0][rows]
                for c, s in zip(all_codes[1:], all_scale[1:]):
                    acc.add_(c[rows].float() * s[rows])
                out = buf[first * QUANT_BLOCK:min((first + QUANT_CHUNK_BLOCKS) * QUANT_BLOCK, n)]
                out.copy_(acc.div_(world.size).reshape(-1)[:out.numel()])
            del all_codes, all_scale
            merged.append(buf)
        out = [leaf.chunk(world.tensor_size)[world.tensor_rank] if s else leaf
               for leaf, s in zip(unflatten_buckets(merged, plan, leaves), split)]
        return tree_unflatten(tree, out), wire_error

    def flush(self, facs, wire_error: Optional[Dict[str, torch.Tensor]] = None,
              step: Optional[int] = None):
        """Merge the ranks' factor running averages (deferred mode only).
        With the int8 wire the caller passes the error-feedback residuals
        (``state["wire_error"]``) and the rounding draw's step (the K-FAC
        state's counter), and gets ``(facs, new_wire_error)`` back; that
        merge overwrites both ``facs``' leaves and ``wire_error``'s buffers
        (:meth:`_merge_quantized`)."""
        if not self.defer:
            raise ValueError(
                "FactorComm.flush() requires deferred factor communication "
                "(factor_comm_freq > 1 over more than one rank)"
            )
        if self.quantized:
            if wire_error is None:
                raise ValueError(
                    "int8 factor wire needs the error-feedback residuals: "
                    "flush(facs, wire_error=state['wire_error'], step=step)"
                )
            tel = get_telemetry()
            with tel.span("trace/kfac/factor_comm"):
                merged = self._merge_quantized(facs, wire_error, 0 if step is None else int(step))
            if tel.enabled:
                publish_wire_quant_error(merged[1])
            return merged
        return self.allreduce(facs)
