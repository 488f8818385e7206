"""Word-level RNN language model (LSTM/GRU/RNN_TANH/RNN_RELU).

Port of ``kfac_pytorch_tpu/models/wikitext_rnn.py`` (``RNNModel``,
``get_model``, ``RNN_TYPES``): embedding → ``nlayers`` recurrent layers with
dropout between them → decoder, optionally tied to the embedding. The
decoder is a ``KFACDense`` (K-FAC preconditions it); the recurrent layers
train with plain SGD, as in the JAX package. ``kfac_embedding`` makes the
encoder a ``KFACEmbed``; with ``tie_weights`` the decoder is then
``encoder.attend`` and the tied table keeps one factor pair over both use
sites (``capture.py``'s reduce lens).

The cells compute flax's maths, not PyTorch's defaults:

* ``LSTM`` is ``nn.OptimizedLSTMCell``: gates i, f, g, o; the input side
  has no bias, the hidden side has one; no forget-gate offset; the carry
  is ``(c, h)``;
* ``GRU`` is ``nn.GRUCell``: biases on the input side (r, z, n) and on
  ``hn`` only, ``n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))``,
  ``h' = (1 − z) ⊙ n + z ⊙ h``;
* ``RNN_TANH``/``RNN_RELU`` are ``nn.SimpleCell``: the bias on the input
  side.

PyTorch's fused recurrences (``torch.lstm``, ``torch.gru``,
``torch.rnn_tanh``/``rnn_relu``; cuDNN on the card) carry each layer, as
flax's scan carried it in the JAX package (no Pallas kernel there). Those
take both an input-side and a hidden-side bias; the ones flax lacks (the
LSTM's input side, the GRU's hidden r and z thirds, a simple cell's hidden
side) are zero buffers outside the parameters and the state_dict, so they
get no gradient and the trained parameters hold exactly flax's values.
Each layer is its own call, so the dropout between layers is this module's
and not cuDNN's. Dropout masks come from an explicit ``torch.Generator``
(flax's ``where(keep, x / keep_prob, 0)``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.models.layers import KFACDense, KFACEmbed

RNN_TYPES = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")
_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}

Carry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class RecurrentLayer(nn.Module):
    """One layer of a flax cell over a ``[B, T, in]`` sequence.

    Parameters in PyTorch's layout, gates concatenated in PyTorch's order
    (i, f, g, o; r, z, n): ``weight_ih [gates·h, in]``, ``weight_hh
    [gates·h, h]``, and the biases flax has: the LSTM's ``bias_hh``, the
    GRU's ``bias_ih`` and ``bias_hn``, a simple cell's ``bias_ih``.
    """

    def __init__(self, rnn_type: str, ninp: int, nhid: int):
        super().__init__()
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"unknown rnn_type {rnn_type!r}; options: {RNN_TYPES}")
        self.rnn_type, self.nhid = rnn_type, nhid
        gh = _GATES[rnn_type] * nhid
        self.weight_ih = nn.Parameter(torch.empty(gh, ninp))
        self.weight_hh = nn.Parameter(torch.empty(gh, nhid))
        if rnn_type == "LSTM":
            self.bias_hh = nn.Parameter(torch.zeros(gh))
            zeros = gh  # the input side's
        elif rnn_type == "GRU":
            self.bias_ih = nn.Parameter(torch.zeros(gh))
            self.bias_hn = nn.Parameter(torch.zeros(nhid))
            zeros = 2 * nhid  # the hidden side's r and z thirds
        else:
            self.bias_ih = nn.Parameter(torch.zeros(gh))
            zeros = gh  # the hidden side's
        self.register_buffer("zero_bias", torch.zeros(zeros), persistent=False)

    def _biases(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.rnn_type == "LSTM":
            return self.zero_bias, self.bias_hh
        if self.rnn_type == "GRU":
            return self.bias_ih, torch.cat([self.zero_bias, self.bias_hn])
        return self.bias_ih, self.zero_bias

    def zero_carry(self, batch: int, device) -> Carry:
        h = torch.zeros(batch, self.nhid, device=device)
        return (h, h.clone()) if self.rnn_type == "LSTM" else h

    def forward(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        params = [self.weight_ih, self.weight_hh, *self._biases()]
        # (has_biases, num_layers, dropout, train, bidirectional, batch_first)
        opts = (True, 1, 0.0, self.training, False, True)
        if self.rnn_type == "LSTM":
            c, h = carry
            out, h_n, c_n = torch.lstm(x, (h[None], c[None]), params, *opts)
            return out, (c_n[0], h_n[0])
        fn = {"GRU": torch.gru, "RNN_TANH": torch.rnn_tanh, "RNN_RELU": torch.rnn_relu}
        out, h_n = fn[self.rnn_type](x, carry[None], params, *opts)
        return out, h_n[0]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` with the keep
    mask drawn from ``generator`` on ``x``'s device."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training mode draws its masks from a torch.Generator; pass one")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class RNNModel(nn.Module):
    """Encoder → recurrent layers → decoder LM; ``forward(tokens [B, T],
    carry, generator)`` returns ``(logits [B, T, ntoken], new_carry)``, the
    carry a list with one entry per layer (the LSTM's ``(c, h)``, else
    ``h``, each ``[B, nhid]``; zeros when ``carry`` is None)."""

    def __init__(
        self,
        ntoken: int,
        ninp: int = 200,
        nhid: int = 200,
        nlayers: int = 2,
        rnn_type: str = "LSTM",
        dropout: float = 0.5,
        tie_weights: bool = False,
        kfac_embedding: bool = False,
    ):
        super().__init__()
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"unknown rnn_type {rnn_type!r}; options: {RNN_TYPES}")
        if tie_weights and nhid != ninp:
            raise ValueError("tie_weights requires nhid == ninp")
        self.rate = dropout
        self.encoder = (KFACEmbed if kfac_embedding else nn.Embedding)(ntoken, ninp)
        self.rnns = nn.ModuleList(
            RecurrentLayer(rnn_type, ninp if i == 0 else nhid, nhid) for i in range(nlayers)
        )
        self.decoder = None if tie_weights else KFACDense(nhid, ntoken)

    def forward(
        self,
        tokens: torch.Tensor,
        carry: Optional[List[Carry]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, List[Carry]]:
        rate = self.rate if self.training else 0.0
        x = dropout(self.encoder(tokens), rate, generator)
        new_carry = []
        for i, rnn in enumerate(self.rnns):
            c = carry[i] if carry is not None else rnn.zero_carry(tokens.shape[0], tokens.device)
            x, c = rnn(x, c)
            new_carry.append(c)
            if i < len(self.rnns) - 1:
                x = dropout(x, rate, generator)
        x = dropout(x, rate, generator)
        if self.decoder is not None:
            return self.decoder(x), new_carry
        if isinstance(self.encoder, KFACEmbed):
            return self.encoder.attend(x), new_carry
        return F.linear(x, self.encoder.weight), new_carry


@torch.no_grad()
def init_weights(model: RNNModel, generator: torch.Generator) -> None:
    """flax's initializers, drawn from ``generator`` on the CPU: normal(0,
    1/d) embeddings; lecun-normal input kernels and decoder (truncated at
    ±2σ, variance 1/fan_in); orthogonal recurrent kernels, one per gate;
    zero biases."""
    def lecun(w):
        std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    nn.init.normal_(model.encoder.weight, 0.0, model.encoder.embedding_dim ** -0.5,
                    generator=generator)
    for rnn in model.rnns:
        lecun(rnn.weight_ih)
        for gate in rnn.weight_hh.split(rnn.nhid):
            # flax's kernel is [in, out], PyTorch's weight its transpose;
            # both are orthogonal
            nn.init.orthogonal_(gate, generator=generator)
    if model.decoder is not None:
        lecun(model.decoder.weight)
        nn.init.zeros_(model.decoder.bias)


def get_model(
    rnn_type: str,
    ntoken: int,
    ninp: int,
    nhid: int,
    nlayers: int,
    dropout: float = 0.5,
    tied: bool = False,
    kfac_embedding: bool = False,
    generator: Optional[torch.Generator] = None,
) -> RNNModel:
    """Factory with the JAX factory's arguments (the reference's
    ``RNNModel(...)`` signature), built on the CPU from ``generator`` (seed
    0 when none is given)."""
    model = RNNModel(ntoken, ninp=ninp, nhid=nhid, nlayers=nlayers, rnn_type=rnn_type,
                     dropout=dropout, tie_weights=tied, kfac_embedding=kfac_embedding)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model
