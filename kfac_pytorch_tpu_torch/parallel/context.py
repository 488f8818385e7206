"""Exact softmax attention, and sequence parallelism: ring and Ulysses.

Port of ``kfac_pytorch_tpu/parallel/context.py``. ``full_attention`` is the
single-device oracle: the semantics the flash kernels
(``ops/flash_attention.py``) and the sequence-parallel tiers reproduce.
The JAX package's ring and Ulysses attention are plain ``jnp`` inside a
``shard_map`` over a ``seq`` mesh axis; here they are plain PyTorch over
the seq subgroup of a data×seq ``parallel.mesh.World``
(``data_seq_world``), each rank holding its ``[B, T/sp, H, D]`` slice of
the sequence:

* **Ring** (:func:`ring_attention`) — K/V blocks travel the seq ring, one
  ``batch_isend_irecv`` hop to the next slot per step
  (``World.seq_shift``, the port's ``lax.ppermute``), while each rank folds
  one block per step into an online softmax. ``torch.distributed``'s
  point-to-point has no autograd, so the ring is a
  ``torch.autograd.Function``: its forward keeps only the local q, k, v,
  the output and the per-row log-sum-exp; its backward runs the ring again,
  recomputes each block's probabilities, accumulates dQ locally and
  carries each block's dK and dV around the ring with the block, so that
  after ``sp`` hops every rank holds the gradient of its own shard. At no
  time does a rank hold more than one foreign block. The causal mask uses
  global positions (``slot·t + arange(t)``); a block wholly above the
  diagonal is skipped, which changes no value (its fold is the identity).
* **Ulysses** (:func:`ulysses_attention`) — one all-to-all
  (``World.seq_all_to_all``, ``lax.all_to_all(tiled=True)``) reshards
  ``[B, T/sp, H, D]`` into ``[B, T, H/sp, D]``, :func:`full_attention`
  runs over the whole sequence on the local heads, and the inverse
  all-to-all reshards back; the backward of each all-to-all is the other.
  Needs ``H % sp == 0``.

Both are exact, in float32 (no flash kernel under sequence parallelism,
as in the JAX package).
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/max NaN-free


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Exact softmax attention, ``[B, T, H, D] → [B, T, H, D]``, in float32.

    Materializes the ``[B, H, T, S]`` logits, as the JAX version does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        t, s = q.shape[1], k.shape[1]
        pos = torch.arange(max(t, s), device=q.device)
        mask = pos[:t, None] >= pos[None, :s]
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)


def _block_logits(qf, kb, q_pos, src, causal):
    """``[B, H, t, t]`` logits of the (pre-scaled) local queries against the
    block that started on seq slot ``src``, masked by global position."""
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kb)
    if causal:
        k_pos = src * kb.shape[2] + torch.arange(kb.shape[2], device=kb.device)
        logits = logits.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
    return logits


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, world, causal):
        sp, me = world.seq_size, world.seq_slot
        t, d = q.shape[1], q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        # [B, H, t, D] float32 throughout
        qf = q.float().transpose(1, 2) * scale
        kv = torch.stack([k.float().transpose(1, 2), v.float().transpose(1, 2)]).contiguous()
        q_pos = me * t + torch.arange(t, device=q.device)
        m = torch.full(qf.shape[:-1], _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for s in range(sp):
            if s:
                kv = world.seq_shift(kv)
            src = (me - s) % sp
            if causal and src > me:  # wholly above the diagonal
                continue
            logits = _block_logits(qf, kv[0], q_pos, src, causal)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ kv[1]
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out = acc / l[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.world, ctx.causal = world, causal
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        world, causal = ctx.world, ctx.causal
        sp, me = world.seq_size, world.seq_slot
        t, d = q.shape[1], q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        qf = q.float().transpose(1, 2) * scale
        do = dout.float().transpose(1, 2)
        delta = (do * out).sum(dim=-1)
        q_pos = me * t + torch.arange(t, device=q.device)
        # the travelling block: its k, v and the dK, dV it has gathered
        blk = torch.zeros((4,) + qf.shape, dtype=torch.float32, device=q.device)
        blk[0], blk[1] = k.float().transpose(1, 2), v.float().transpose(1, 2)
        dq = torch.zeros_like(qf)
        for s in range(sp):
            if s:
                blk = world.seq_shift(blk)
            src = (me - s) % sp
            if causal and src > me:
                continue
            kb, vb = blk[0], blk[1]
            p = torch.exp(_block_logits(qf, kb, q_pos, src, causal) - lse[..., None])
            blk[3] += p.transpose(-1, -2) @ do
            ds = p * (do @ vb.transpose(-1, -2) - delta[..., None])
            dq += (ds @ kb) * scale
            blk[2] += ds.transpose(-1, -2) @ qf
        # one more hop brings each block's dK, dV home
        dkv = world.seq_shift(blk[2:].contiguous()) if sp > 1 else blk[2:]
        return (
            dq.transpose(1, 2).to(q.dtype),
            dkv[0].transpose(1, 2).to(k.dtype),
            dkv[1].transpose(1, 2).to(v.dtype),
            None,
            None,
        )


def ring_attention(q, k, v, world, causal: bool = True) -> torch.Tensor:
    """Blockwise ring attention over the seq subgroup of ``world``:
    ``q, k, v`` are this rank's ``[B, T/sp, H, D]`` slices; returns its
    slice of the output."""
    return _RingAttention.apply(q, k, v, world, causal)


class _SeqAllToAll(torch.autograd.Function):
    """``[B, t, H, D] → [B, t·sp, H/sp, D]`` (``to_heads``) or back; the
    backward is the other direction."""

    @staticmethod
    def forward(ctx, x, world, to_heads):
        ctx.world, ctx.to_heads = world, to_heads
        return _reshard(x, world, to_heads)

    @staticmethod
    def backward(ctx, grad):
        return _reshard(grad, ctx.world, not ctx.to_heads), None, None


def _reshard(x, world, to_heads):
    sp = world.seq_size
    b = x.shape[0]
    if to_heads:
        # chunk j of the heads goes to slot j; slot i's sequence chunk lands
        # at row i of the result
        t, h, d = x.shape[1:]
        send = x.reshape(b, t, sp, h // sp, d).permute(2, 0, 1, 3, 4)
        recv = world.seq_all_to_all(send.contiguous())
        return recv.permute(1, 0, 2, 3, 4).reshape(b, sp * t, h // sp, d)
    tt, hp, d = x.shape[1:]
    send = x.reshape(b, sp, tt // sp, hp, d).permute(1, 0, 2, 3, 4)
    recv = world.seq_all_to_all(send.contiguous())
    return recv.permute(1, 2, 0, 3, 4).reshape(b, tt // sp, sp * hp, d)


def ulysses_attention(q, k, v, world, causal: bool = True) -> torch.Tensor:
    """All-to-all sequence parallelism over the seq subgroup of ``world``:
    exact attention over the whole sequence on this rank's ``H/sp`` heads.
    Requires ``H % sp == 0``."""
    sp = world.seq_size
    if q.shape[2] % sp != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[2]}) divisible by the "
            f"'seq' axis size ({sp}); use ring attention otherwise"
        )
    qh, kh, vh = (_SeqAllToAll.apply(x, world, True) for x in (q, k, v))
    out = full_attention(qh, kh, vh, causal=causal)
    return _SeqAllToAll.apply(out, world, False)


def make_context_parallel_attention(world, kind: str = "ring"):
    """``attn(q, k, v, causal=True)`` over this rank's sequence slices,
    sharded over ``world``'s seq subgroup: ring or Ulysses. The drop-in for
    :func:`full_attention` in ``TransformerLM(attention_fn=...)``."""
    inner = {"ring": ring_attention, "ulysses": ulysses_attention}[kind]

    def attn(q, k, v, causal: bool = True):
        return inner(q, k, v, world, causal=causal)

    return attn

