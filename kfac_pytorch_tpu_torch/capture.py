"""Per-layer K-FAC statistics through module hooks.

Port of the conv/dense/embedding subset of ``kfac_pytorch_tpu/capture.py``,
with the reduce lens of a tied embedding/decoder head and the shard lenses
of tensor-sharded dense layers and the MoE expert bank.
The JAX package computes statistics inside its layers because JAX has no
hooks; the reference it ports kept ``m_a``/``m_g`` hook dicts, and so does
this module:

* forward hook — on capture steps only, under ``no_grad``, the layer's
  input gives its A-factor contribution (conv layers and embeddings through
  the factor-kernel dispatchers, ``ops/factor_kernels.py``; an embedding's
  A is the ``[vocab]`` diagonal of its token ids' frequencies);
* a hook on the layer's output tensor — the gradient of the loss with
  respect to the output gives the G factor.

Under bfloat16 compute (``--bf16``) the hooks see bfloat16 activations and
output gradients: a conv's input goes to the factor kernels as it is (their
bf16 route; the oracle upcasts it), a dense layer's input and every output
gradient are upcast to float32 first, as the JAX package upcasts them; the
statistics are float32 either way.

Layers are keyed by module path (``"layer1.0.conv1"``); their parameter
gradients by parameter name (``"layer1.0.conv1.weight"``), so every
per-layer artifact shares one key, as in the JAX package.

A grouped conv (``KFACConv(groups=G)``) is G pseudo-layers
``path#g0 … path#g{G-1}`` (the JAX package's naming): its A and G
statistics are computed once per layer as ``[G, ·, ·]`` stacks and stored
per group, its weight gradient is sliced along the OIHW output axis, and
:func:`write_back` reassembles the groups. Everything downstream treats the
groups as ordinary same-shape layers.

An expand-lens dense layer (``KFACDense(lens_splits=S)``, the fused QKV
projection) is S pseudo-layers ``path#s0 … path#s{S-1}`` (JAX
``capture.SPLIT_SEP``): they share the layer's one A statistic, computed
once and stored under each of them, while each takes its G from its
``out/S`` column slice of the output gradient. A split partitions the
OUT side only: rows of the ``[out, in]`` weight here (columns of flax's
``[in, out]`` kernel), and :func:`write_back` stacks the S updates back.

Under ``remat`` the transformer recomputes each block's forward in the
backward pass (``models.layers.recomputing``): the hooks stay inert
there, so each A is computed once per capture step and each G comes from
the hook registered in the first forward, whose outputs stay in the graph.

A shard-lens layer is ONE name whose statistics stay stacked (JAX
``capture.split_shard_name``): ``path#c{T}`` (``KFACShardedDense``,
column-sharded) keeps one ``[a(+1), a(+1)]`` A and a ``[T, m/T, m/T]`` G
stack, ``path#r{T}`` (row-sharded) an A stack ``[T, a/T, a/T]`` and one G,
and ``path#e{E}`` (``KFACMoE``) the pair ``{"S": [E, a, a], "f": [E]}`` as
its A (the unnormalized per-expert sums and the expert fractions, so the
comm plane averages both before the weighted EMA) and ``[E, m, m]`` as its
G, from the gradient of the bank's dense per-expert outputs. The bank's
``[E, a, m]`` weight gradient becomes ``[E, m, a]`` factor-space
matrices, one per expert, and back. A column or row layer split over a
genuine tensor axis (``KFACShardedDense.split_``) keeps the same name and
stacks only its own blocks, ``[T/T_axis, ·, ·]`` (``[1, ·, ·]`` in the LM):
a column rank's G from its own output-gradient slice beside the shared A,
a row rank's A from its own input slice beside the shared G (its output
cotangent is the same on every tensor slot). The tensor slots' stacks,
concatenated in slot order, are the one-process ``[T, ·, ·]`` stack.

A tied head (``KFACEmbed.attend``, the decoder reusing the embedding table)
is a method call, which no forward hook sees: the embedding's attend hook
hands its statistics over explicitly, and the shared table keeps ONE factor
pair over both use sites (the reduce lens, arxiv 2311.00636; JAX
``capture.a_contribs``/``g_factors``). The crossover: the decoder site's
logit-gradient diagonal (``ops/factors.py::compute_g_diag``) adds to the
embedding's ``[vocab]`` A, and its query covariance (``compute_a_dense``
without bias) adds to the embedding's ``[features]`` G, each after the
lookup site's own statistic. Autograd sums the table's gradient over both
sites, and that sum is what is preconditioned.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Collection, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch.models.layers import (
    KFACConv,
    KFACDense,
    KFACEmbed,
    KFACMoE,
    KFACShardedDense,
    in_recompute,
)
from kfac_pytorch_tpu_torch.ops import factor_kernels, factors

KFAC_LAYERS = (KFACConv, KFACDense, KFACEmbed, KFACShardedDense, KFACMoE)

# Grouped-conv pseudo-layer suffix: "path#g3" is group 3 of the grouped conv
# at "path". "#" cannot appear in a module path.
GROUP_SEP = "#g"
# Expand-lens pseudo-layer suffix: "path#s1" is column slice 1 of the
# lens-split dense layer at "path".
SPLIT_SEP = "#s"


# Shard-lens suffixes: ONE name carries the whole stack (never expanded into
# per-index entries). "path#c4": column-sharded, 4 shards; "path#r4":
# row-sharded; "path#e8": an MoE bank of 8 experts.
COL_SEP = "#c"
ROW_SEP = "#r"
MOE_SEP = "#e"
_SHARD_SEPS = {"c": COL_SEP, "r": ROW_SEP, "e": MOE_SEP}


def split_shard_name(name: str) -> Tuple[str, Optional[str], Optional[int]]:
    """``"path#c4" -> ("path", "c", 4)``; unsharded ``-> (name, None, None)``.
    The form is ``"c"`` (column), ``"r"`` (row) or ``"e"`` (MoE bank); the
    count is the shard or expert count."""
    for form, sep in _SHARD_SEPS.items():
        base, s, count = name.rpartition(sep)
        if s and count.isdigit():
            return base, form, int(count)
    return name, None, None


def is_shard_name(name: str) -> bool:
    """Whether ``name`` carries a shard-lens suffix (``#c``/``#r``/``#e``)."""
    return split_shard_name(name)[1] is not None


def _split_name(name: str, sep: str) -> Tuple[str, Optional[int]]:
    base, s, idx = name.rpartition(sep)
    if not s:
        return name, None
    return base, int(idx)


def split_group_name(name: str) -> Tuple[str, Optional[int]]:
    """``"path#g3" -> ("path", 3)``; ungrouped ``"path" -> ("path", None)``."""
    return _split_name(name, GROUP_SEP)


def split_lens_name(name: str) -> Tuple[str, Optional[int]]:
    """``"path#s2" -> ("path", 2)``; unsplit ``"path" -> ("path", None)``."""
    return _split_name(name, SPLIT_SEP)


def layer_base(name: str) -> str:
    """The module path of a layer name, any ``#gK``/``#sK``/``#cT``/``#rT``/
    ``#eE`` suffix stripped."""
    base, form, _ = split_shard_name(name)
    if form is not None:
        return base
    return split_lens_name(split_group_name(name)[0])[0]


def _counts(names: List[str], split) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for n in names:
        base, i = split(n)
        if i is not None:
            counts[base] = max(counts.get(base, 0), i + 1)
    return counts


def group_counts(names: List[str]) -> Dict[str, int]:
    """``{base_path: G}`` for every grouped base present in ``names`` (one
    pass: G is the highest group index + 1)."""
    return _counts(names, split_group_name)


def lens_counts(names: List[str]) -> Dict[str, int]:
    """``{base_path: S}`` for every lens-split base present in ``names``."""
    return _counts(names, split_lens_name)


def pseudo_layers(name: str, module: nn.Module) -> List[str]:
    """The K-FAC layer names of the module at ``name``: a grouped conv's
    ``path#gK``, a lens-split dense layer's ``path#sK``, a sharded dense
    layer's ``path#cT``/``path#rT``, an MoE bank's ``path#eE``, else
    ``[name]``."""
    if isinstance(module, KFACShardedDense):
        sep = COL_SEP if module.sharding == "column" else ROW_SEP
        return [f"{name}{sep}{module.shards}"]
    if isinstance(module, KFACMoE):
        return [f"{name}{MOE_SEP}{module.num_experts}"]
    if isinstance(module, KFACConv) and module.groups > 1:
        return [f"{name}{GROUP_SEP}{k}" for k in range(module.groups)]
    if isinstance(module, KFACDense) and module.lens_splits > 1:
        return [f"{name}{SPLIT_SEP}{k}" for k in range(module.lens_splits)]
    return [name]


def discover_layers(model: nn.Module) -> List[str]:
    """Names of every K-FAC layer of ``model``, in module order; a grouped
    conv contributes its ``G`` pseudo-layers ``path#g0 … path#g{G-1}``, a
    lens-split dense layer its ``S`` pseudo-layers ``path#s0 …``, a
    shard-lens layer its one ``path#cT``/``#rT``/``#eE`` name."""
    return [
        p for n, m in model.named_modules() if isinstance(m, KFAC_LAYERS)
        for p in pseudo_layers(n, m)
    ]


class Capture:
    """Forward/backward hooks that collect A contributions and G factors.

    Inert until :meth:`capturing` opens a capture step; the statistics of
    the last capture step stay in :attr:`a_contribs` / :attr:`g_factor_stats`
    (``{layer: [d, d] tensor}``, one entry per pseudo-layer of a grouped
    conv, stacks under a shard-lens name). :meth:`remove` detaches the
    hooks.
    """

    def __init__(
        self,
        model: nn.Module,
        layers: Optional[List[str]] = None,
        batch_averaged: bool = True,
    ):
        names = list(layers) if layers is not None else discover_layers(model)
        bases = list(dict.fromkeys(layer_base(n) for n in names))
        self.modules = {n: model.get_submodule(n) for n in bases}
        self.groups = group_counts(names)
        self.lenses = lens_counts(names)
        listed = set(names)
        for base, m in self.modules.items():
            if not set(pseudo_layers(base, m)) <= listed:
                raise ValueError(
                    f"K-FAC layer {base!r}: list a grouped conv as all of its "
                    f"pseudo-layers '{base}{GROUP_SEP}K', a lens-split dense "
                    f"layer as all of its '{base}{SPLIT_SEP}K', a shard-lens "
                    f"layer as '{pseudo_layers(base, m)[0]}', any other "
                    "layer by its module path"
                )
        # shard-lens layers: module path → their one stacked name
        self.shards = {
            base: pseudo_layers(base, m)[0] for base, m in self.modules.items()
            if isinstance(m, (KFACShardedDense, KFACMoE))
        }
        self.batch_averaged = batch_averaged
        self.a_contribs: Dict[str, torch.Tensor] = {}
        self.g_factor_stats: Dict[str, torch.Tensor] = {}
        self._kind: Optional[str] = None
        # the tied decoder sites' query covariances, by embedding layer
        self._g_tied: Dict[str, torch.Tensor] = {}
        self._handles = [
            m.register_forward_hook(partial(self._forward_hook, n))
            for n, m in self.modules.items() if not isinstance(m, KFACMoE)
        ] + [
            m.register_attend_hook(partial(self._attend_hook, n))
            for n, m in self.modules.items() if isinstance(m, KFACEmbed)
        ] + [
            m.register_dispatch_hook(partial(self._dispatch_hook, n))
            for n, m in self.modules.items() if isinstance(m, KFACMoE)
        ]

    @contextlib.contextmanager
    def capturing(self, factor_kernel: str = "auto"):
        """Collect statistics for the forward/backward run inside the block."""
        self.a_contribs, self.g_factor_stats, self._g_tied = {}, {}, {}
        self._kind = factor_kernel
        try:
            yield self
        finally:
            self._kind = None

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _forward_hook(self, name, module, inputs, output):
        if self._kind is None or in_recompute():
            return
        with torch.no_grad():
            x = inputs[0].detach()
            if isinstance(module, KFACEmbed):
                a = factor_kernels.dispatch_compute_a_embed(
                    x, module.num_embeddings, kind=self._kind
                )
            elif isinstance(module, KFACConv) and module.groups > 1:
                a = factor_kernels.dispatch_compute_a_conv_grouped(
                    x,
                    module.groups,
                    module.kernel_size,
                    module.stride,
                    module.factor_padding(),
                    module.bias is not None,
                    module.dilation,
                    kind=self._kind,
                )
            elif isinstance(module, KFACConv):
                a = factor_kernels.dispatch_compute_a_conv(
                    x,
                    module.kernel_size,
                    module.stride,
                    module.factor_padding(),
                    module.bias is not None,
                    module.dilation,
                    kind=self._kind,
                )
            elif isinstance(module, KFACShardedDense) and module.sharding == "row":
                a = factors.compute_a_row_sharded(x.float(), module.local_shards)
            else:  # dense, and column-sharded (one A for every shard)
                a = factors.compute_a_dense(x.float(), module.bias is not None)
                if name in self.lenses:  # one A, shared by the S splits
                    a = [a] * self.lenses[name]
        self._store(self.a_contribs, name, a)
        if output.requires_grad:
            output.register_hook(
                partial(self._grad_hook, name, isinstance(module, KFACConv))
            )

    def _dispatch_hook(self, name, module, x, expert_ids, h):
        """An MoE bank's forward: the unnormalized per-expert A sums and the
        expert fractions now, a hook on the per-expert outputs for G."""
        if self._kind is None or in_recompute():
            return
        with torch.no_grad():
            a = {
                "S": factors.compute_a_moe(x.detach().float(), expert_ids, module.num_experts),
                "f": factor_kernels.dispatch_compute_a_moe(
                    expert_ids, module.num_experts, kind=self._kind),
            }
        self._store(self.a_contribs, name, a)
        if h.requires_grad:
            h.register_hook(partial(self._moe_grad_hook, name))

    def _moe_grad_hook(self, name, grad):
        with torch.no_grad():
            stat = factors.compute_g_moe(grad.detach().float(), self.batch_averaged)
        self._store(self.g_factor_stats, name, stat)

    def _attend_hook(self, name, module, query, logits):
        """The tied decoder site of embedding ``name``: its query covariance
        now (for G), a hook on the logits for its A-side diagonal."""
        if self._kind is None:
            return
        with torch.no_grad():
            self._g_tied[name] = factors.compute_a_dense(query.detach().float(), False)
        if logits.requires_grad:
            logits.register_hook(partial(self._tied_grad_hook, name))

    def _tied_grad_hook(self, name, grad):
        """The logit-gradient diagonal joins the lookup site's token
        frequencies (the logits' gradient comes before the lookup output's,
        so the lookup's G is not yet formed here)."""
        if name not in self.a_contribs:
            raise ValueError(
                f"embedding {name!r}: its tied head ran without its lookup in "
                "this capture step; the reduce lens needs both use sites"
            )
        with torch.no_grad():
            diag = factors.compute_g_diag(grad.detach().float(), self.batch_averaged)
            self.a_contribs[name] = self.a_contribs[name] + diag

    def _store(self, stats, name, stat):
        """One entry per layer; a grouped conv's ``[G, d, d]`` stack, and a
        lens-split layer's list of S statistics, are stored per
        pseudo-layer; a shard-lens layer's stack under its one name."""
        n_groups = self.groups.get(name)
        if name in self.shards:
            stats[self.shards[name]] = stat
        elif n_groups is not None:
            for k in range(n_groups):
                stats[f"{name}{GROUP_SEP}{k}"] = stat[k]
        elif name in self.lenses:
            for k, part in enumerate(stat):
                stats[f"{name}{SPLIT_SEP}{k}"] = part
        else:
            stats[name] = stat

    def _grad_hook(self, name, is_conv, grad):
        with torch.no_grad():
            g = grad.detach().float()
            if name in self.groups:
                stat = factors.compute_g_conv_grouped(
                    g, self.groups[name], self.batch_averaged
                )
            elif is_conv:
                stat = factors.compute_g_conv(g, self.batch_averaged)
            elif name in self.shards:  # column: block-diagonal; row: one G
                m = self.modules[name]
                stat = (factors.compute_g_dense_sharded(g, m.local_shards, self.batch_averaged)
                        if m.sharding == "column"
                        else factors.compute_g_dense(g, self.batch_averaged))
            elif name in self.lenses:  # each split's G from its column slice
                stat = [
                    factors.compute_g_dense(part, self.batch_averaged)
                    for part in g.chunk(self.lenses[name], dim=-1)
                ]
            else:
                stat = factors.compute_g_dense(g, self.batch_averaged)
                if name in self._g_tied:  # the tied head's query covariance
                    stat = stat + self._g_tied[name]
        self._store(self.g_factor_stats, name, stat)


def layer_grads(
    grads: Dict[str, torch.Tensor],
    names: List[str],
    embeddings: Collection[str] = (),
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {'weight': ..., 'bias'?: ...}}`` from a by-parameter-name
    gradient dict (``{n: p.grad for n, p in model.named_parameters()}``);
    layers in ``embeddings`` give ``{'embedding': [vocab, d] table grad}``.
    A grouped conv's pseudo-layer ``path#gK`` gets group K's slice of the
    OIHW weight's output axis (dim 0; the input axis is already per group)
    and of the bias; a lens split ``path#sK`` its slice of the ``[out, in]``
    weight's rows and of the bias; a shard-lens layer the whole weight (and
    a column layer's bias): its blocks are cut in factor space
    (``shardwise.precondition``)."""
    counts = {**group_counts(names), **lens_counts(names)}
    out = {}
    for name in names:
        if name in embeddings:
            out[name] = {"embedding": grads[f"{name}.weight"]}
            continue
        sbase, form, _ = split_shard_name(name)
        if form is not None:
            out[name] = {"weight": grads[f"{sbase}.weight"]}
            if f"{sbase}.bias" in grads:
                out[name]["bias"] = grads[f"{sbase}.bias"]
            continue
        base, gi = split_group_name(name)
        if gi is None:
            base, gi = split_lens_name(name)
        weight, bias = grads[f"{base}.weight"], grads.get(f"{base}.bias")
        if gi is not None:
            co_g = weight.shape[0] // counts[base]
            weight = weight[gi * co_g:(gi + 1) * co_g]
            if bias is not None:
                bias = bias[gi * co_g:(gi + 1) * co_g]
        entry = {"weight": weight}
        if bias is not None:
            entry["bias"] = bias
        out[name] = entry
    return out


def grad_mats(
    lgrads: Dict[str, Dict[str, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """Per-layer factor-space gradient matrices ``[out, in(+1)]``; an MoE
    bank's ``[E, a, m]`` weight becomes the ``[E, m, a]`` stack of its
    experts' matrices."""
    return {
        name: (g["weight"].transpose(1, 2) if split_shard_name(name)[1] == "e"
               else factors.grads_to_mat(g))
        for name, g in lgrads.items()
    }


def write_back(
    grads: Dict[str, torch.Tensor],
    updates: Dict[str, torch.Tensor],
    nu: torch.Tensor,
    embeddings: Collection[str] = (),
) -> Dict[str, torch.Tensor]:
    """A new gradient dict with every K-FAC layer's ν-scaled preconditioned
    matrix scattered back (an embedding's ``[d, vocab]`` matrix back to its
    ``[vocab, d]`` table, a grouped conv's per-group matrices, and a lens
    split's per-split ones, stacked back along the weight's output axis);
    other entries (BatchNorm, LayerNorm, position embeddings) pass through
    untouched. A grouped or lens-split layer must bring every one of its
    parts. A shard-lens layer's update is whole: an MoE bank's ``[E, m, a]``
    stack goes back to its ``[E, a, m]`` weight."""
    out = dict(grads)
    grouped: Dict[str, Dict[int, torch.Tensor]] = {}
    seps: Dict[str, str] = {}
    for name, mat in updates.items():
        sbase, form, _ = split_shard_name(name)
        if form == "e":
            weight = grads[f"{sbase}.weight"]
            out[f"{sbase}.weight"] = (mat * nu).transpose(1, 2).contiguous().to(weight.dtype)
            continue
        name = sbase  # a column or row layer writes back as a dense one
        sep = GROUP_SEP if GROUP_SEP in name else SPLIT_SEP
        base, gi = _split_name(name, sep)
        if gi is not None:
            grouped.setdefault(base, {})[gi] = mat
            seps[base] = sep
            continue
        weight = grads[f"{name}.weight"]
        if name in embeddings:
            out[f"{name}.weight"] = (mat * nu).T.contiguous().to(weight.dtype)
            continue
        has_bias = f"{name}.bias" in grads
        new = factors.mat_to_grads(mat * nu, weight.shape, has_bias)
        out[f"{name}.weight"] = new["weight"].to(weight.dtype)
        if has_bias:
            out[f"{name}.bias"] = new["bias"].to(grads[f"{name}.bias"].dtype)
    for base, parts in grouped.items():
        n_groups = max(parts) + 1
        if len(parts) != n_groups:
            kind, what = (("grouped", "groups") if seps[base] == GROUP_SEP
                          else ("lens-split", "splits"))
            raise ValueError(
                f"{kind} layer {base!r}: updates carry {len(parts)} of "
                f"{n_groups} {what}; keep all '{seps[base]}K' entries of a "
                f"{kind} layer together"
            )
        weight = grads[f"{base}.weight"]
        has_bias = f"{base}.bias" in grads
        # [G, out/G, a]: part k's rows are output channels k·out/G … in order
        mats = torch.stack([parts[k] for k in range(n_groups)]) * nu
        if has_bias:
            out[f"{base}.bias"] = mats[..., -1].reshape(-1).contiguous().to(grads[f"{base}.bias"].dtype)
            mats = mats[..., :-1]
        out[f"{base}.weight"] = mats.reshape(weight.shape).contiguous().to(weight.dtype)
    return out


def factor_stat_tree(
    a_contribs: Dict[str, torch.Tensor], g_stats: Dict[str, torch.Tensor]
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The per-layer A and G statistics as ONE tree, the factor comm plane's
    wire format (``parallel/comm.py``): A and G leaves of different layers
    share buckets, and the fixed ``{"a": ..., "g": ...}`` framing keeps the
    flattened leaf order (every A in layer order, then every G) the same on
    every rank."""
    return {"a": a_contribs, "g": g_stats}


def split_factor_stat_tree(
    tree: Dict[str, Dict[str, torch.Tensor]]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Inverse of :func:`factor_stat_tree`."""
    return tree["a"], tree["g"]
