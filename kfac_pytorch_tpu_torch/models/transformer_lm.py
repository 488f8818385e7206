"""Decoder-only transformer LM with K-FAC layers and pluggable attention.

Port of ``kfac_pytorch_tpu/models/transformer_lm.py`` (``TransformerBlock``,
``TransformerLM``, ``get_model``), tied or untied, with the flax model's
module names (``tok_embed``, ``pos_embed``, ``blocks.{i}`` for
``block_{i}``, ``ln_attn``, ``qkv``, ``out``, ``ln_mlp``, ``ff1``, ``ff2``,
``moe`` and its ``router``, ``ln_f``, ``decoder``), so
``interop.lm_state_dict_from_jax`` maps one tree onto the other. The flax
semantics it keeps:

* LayerNorm epsilon 1e-6 (flax's default; PyTorch's is 1e-5);
* GELU is the tanh approximation (``flax.linen.gelu``'s default);
* position embeddings are a plain, SGD-trained embedding over the global
  positions; the token embedding is a ``KFACEmbed`` with
  ``kfac_embedding=True``;
* every projection and the decoder head are ``KFACDense`` with bias;
  with ``tie_embeddings`` the head is the token table instead
  (``KFACEmbed.attend`` under ``kfac_embedding``: the reduce lens of
  ``capture.py`` keeps one factor pair over both use sites);
* ``qkv_lens``: the fused QKV projection is ``KFACDense(lens_splits=3)``,
  the expand lens (three ``d_model``-side G factors for the q, k and v
  column slices in place of one ``3·d_model``-side factor);
* ``tensor_parallel = T > 1``: the Megatron MLP split's curvature model,
  ``ff1`` a column-sharded and ``ff2`` a row-sharded, bias-free
  ``KFACShardedDense`` of T shards (the shard lenses, ``shardwise/``); the
  compute stays whole on one process, as the JAX model's until a mesh
  splits it. On a world with a genuine tensor axis
  (``parallel.mesh.data_fsdp_tensor_world``) :func:`split_tensor_layers`
  splits them after the init: each rank keeps its kernel shards and
  computes with them (``KFACShardedDense.split_``), cut from the same
  whole weights as one process's. Attention, the embeddings, the
  LayerNorms and the decoder stay whole on every tensor slot, as in the
  JAX package;
* ``moe_experts = E > 0``: the MLP is a ``KFACMoE`` bank of E experts with
  top-1 routing (exclusive with ``tensor_parallel``, with the JAX error);
* ``remat``: each block runs under ``torch.utils.checkpoint``
  (``use_reentrant=False``) and recomputes its forward in the backward
  pass, inside ``layers.recomputing()`` so that the K-FAC hooks see one
  forward per step, as flax's overwriting ``sow`` does;
* ``dropout``: after ``out`` and after the MLP, in training mode only
  (``model.train()``, flax's ``train=True``). The masks are drawn from the
  ``generator`` passed to ``forward``, which dropout in training requires
  (the JAX model needs a ``dropout`` key there): each block draws one seed
  from it and its masks from a generator of its own seeded with it, so a
  recompute under ``remat`` draws the same masks. threefry masks cannot be
  reproduced here, so parity with the JAX model holds at dropout 0.

``attention_fn(q, k, v, causal=True)`` takes ``[B, T, H, D]`` tensors:
``ops.flash_attention.best_attention_fn(device)`` picks the CUDA flash
kernels on a GPU; ``parallel.context.full_attention`` is the exact oracle;
``parallel.context.make_context_parallel_attention`` shards the sequence
over a seq axis (ring or Ulysses). Under a seq axis of ``seq_shards``
slots the model sees its slot's ``[B, T/seq_shards]`` tokens and embeds
their global positions ``seq_index·T/seq_shards + arange``; ``max_len``
bounds the global T, as under the JAX package's GSPMD.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kfac_pytorch_tpu_torch.models.layers import (
    KFACDense,
    KFACEmbed,
    KFACMoE,
    KFACShardedDense,
    recomputing,
)
from kfac_pytorch_tpu_torch.parallel.context import full_attention

AttentionFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out

LN_EPS = 1e-6


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability ``1 − rate``, kept values
    scaled by ``1 / (1 − rate)``; the mask from ``generator``."""
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


class TransformerBlock(nn.Module):
    """Pre-LN block: attention and MLP residuals, all projections K-FAC layers."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        d_ff: int,
        attention_fn: AttentionFn = full_attention,
        dropout: float = 0.0,
        qkv_lens: bool = False,
        tensor_parallel: int = 1,
        moe_experts: int = 0,
    ):
        super().__init__()
        if tensor_parallel > 1 and moe_experts > 0:
            raise ValueError(
                "tensor_parallel > 1 and moe_experts > 0 are mutually "
                "exclusive: the MoE expert bank replaces the MLP the "
                "tensor-parallel split would shard"
            )
        self.d_model, self.n_heads = d_model, n_heads
        self.attention_fn = attention_fn
        self.dropout = dropout
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.qkv = KFACDense(d_model, 3 * d_model, lens_splits=3 if qkv_lens else 1)
        self.out = KFACDense(d_model, d_model)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        # the MLP: an MoE bank, the Megatron split's shard lenses, or dense
        self.moe = KFACMoE(d_model, d_model, moe_experts) if moe_experts > 0 else None
        if self.moe is None and tensor_parallel > 1:
            self.ff1 = KFACShardedDense(d_model, d_ff, tensor_parallel, sharding="column")
            self.ff2 = KFACShardedDense(d_ff, d_model, tensor_parallel, sharding="row",
                                        bias=False)
        elif self.moe is None:
            self.ff1 = KFACDense(d_model, d_ff)
            self.ff2 = KFACDense(d_ff, d_model)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """``seed`` seeds this block's dropout masks (``None``: no dropout)."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        b, t, _ = x.shape
        shape = (b, t, self.n_heads, self.d_model // self.n_heads)
        # q, k, v stay strided views of the fused projection: the flash
        # kernels read them through their strides
        q, k, v = self.qkv(self.ln_attn(x)).split(self.d_model, dim=-1)
        a = self.attention_fn(q.reshape(shape), k.reshape(shape), v.reshape(shape), causal=True)
        a = self.out(a.reshape(b, t, self.d_model))
        if gen is not None:
            a = _dropout(a, self.dropout, gen)
        x = x + a
        h = self.ln_mlp(x)
        if self.moe is not None:
            f = self.moe(h)
        else:
            f = self.ff2(F.gelu(self.ff1(h), approximate="tanh"))
        if gen is not None:
            f = _dropout(f, self.dropout, gen)
        return x + f


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the first forward,
    ``layers.recomputing()`` around the recompute."""
    return contextlib.nullcontext(), recomputing()


class TransformerLM(nn.Module):
    """Token + learned-position embeddings → N blocks → LN → K-FAC decoder."""

    def __init__(
        self,
        vocab_size: int,
        max_len: int = 512,
        d_model: int = 256,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: Optional[int] = None,
        attention_fn: AttentionFn = full_attention,
        dropout: float = 0.0,
        kfac_embedding: bool = False,
        qkv_lens: bool = False,
        tie_embeddings: bool = False,
        remat: bool = False,
        tensor_parallel: int = 1,
        moe_experts: int = 0,
        seq_shards: int = 1,
        seq_index: int = 0,
    ):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        self.max_len = max_len
        self.dropout = dropout
        self.remat = remat
        self.seq_shards, self.seq_index = seq_shards, seq_index
        embed_cls = KFACEmbed if kfac_embedding else nn.Embedding
        self.tok_embed = embed_cls(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, d_ff or 4 * d_model, attention_fn,
                             dropout, qkv_lens, tensor_parallel, moe_experts)
            for _ in range(n_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.decoder = None if tie_embeddings else KFACDense(d_model, vocab_size)

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of this rank's ``[B, T/seq_shards]`` tokens. In training
        mode with ``dropout > 0`` the masks come from ``generator``."""
        t = tokens.shape[1]
        if t * self.seq_shards > self.max_len:
            raise ValueError(
                f"sequence length {t * self.seq_shards} exceeds max_len {self.max_len}"
            )
        drop = self.training and self.dropout > 0
        if drop and generator is None:
            raise ValueError(
                "dropout > 0 in training mode draws its masks from a "
                "generator: call model(tokens, generator=...)"
            )
        start = self.seq_index * t
        x = self.tok_embed(tokens) + self.pos_embed(
            torch.arange(start, start + t, device=tokens.device)
        )[None]
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            seed = None
            if drop:
                seed = int(torch.randint(1 << 62, (), generator=generator,
                                         device=generator.device))
            if remat:
                x = checkpoint(block, x, seed, use_reentrant=False,
                               context_fn=_remat_contexts)
            else:
                x = block(x, seed)
        x = self.ln_f(x)
        if self.decoder is not None:
            return self.decoder(x)
        if isinstance(self.tok_embed, KFACEmbed):
            return self.tok_embed.attend(x)
        return F.linear(x, self.tok_embed.weight)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers, drawn from ``generator`` on the CPU: lecun-normal
    projections (truncated at ±2σ, variance 1/fan_in; an MoE bank's fan_in
    is E·a, as flax counts it) with zero biases, normal(0, 1/d) embeddings,
    unit LayerNorm scales."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, KFACMoE)):
            fan_in = m.in_features * (m.num_experts if isinstance(m, KFACMoE) else 1)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def get_model(
    vocab_size: int,
    max_len: int = 512,
    d_model: int = 256,
    n_heads: int = 4,
    n_layers: int = 2,
    attention_fn: AttentionFn = full_attention,
    dropout: float = 0.0,
    kfac_embedding: bool = False,
    qkv_lens: bool = False,
    tie_embeddings: bool = False,
    remat: bool = False,
    tensor_parallel: int = 1,
    moe_experts: int = 0,
    generator: Optional[torch.Generator] = None,
    seq_shards: int = 1,
    seq_index: int = 0,
) -> TransformerLM:
    """Factory with the JAX factory's arguments, built on the CPU from
    ``generator`` (seed 0 when none is given), and the seq slot
    (``seq_shards``, ``seq_index``) of a rank under sequence parallelism."""
    model = TransformerLM(
        vocab_size, max_len=max_len, d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, attention_fn=attention_fn, dropout=dropout,
        kfac_embedding=kfac_embedding, qkv_lens=qkv_lens,
        tie_embeddings=tie_embeddings, remat=remat, tensor_parallel=tensor_parallel,
        moe_experts=moe_experts, seq_shards=seq_shards, seq_index=seq_index,
    )
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model


def split_tensor_layers(model: nn.Module, world) -> nn.Module:
    """Every ``KFACShardedDense`` of ``model`` cut to ``world``'s tensor
    slot's shard (``KFACShardedDense.split_``), in place."""
    for m in model.modules():
        if isinstance(m, KFACShardedDense):
            m.split_(world)
    return model
