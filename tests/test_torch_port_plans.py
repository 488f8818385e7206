"""The host-side plans of the port's fused SGD (kernel 4) and token-count
(kernel 2) CUDA kernels, in pure Python on the CPU.

The kernels run only on a GPU (``tests/test_torch_port_cuda.py``); what
they are handed is planned in Python, and checked here: the SGD launch
tables (chunk offsets, capacities, the kernel argument's size, the
float4-or-scalar route per leaf) and the token count's vocabulary slices.
The kernels' own index arithmetic is emulated line for line.
"""

import ctypes

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.models import cifar_resnet, transformer_lm
from kfac_pytorch_tpu_torch.ops import apply_kernels as tapply
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk


def _resnet32_sizes():
    model = cifar_resnet.get_model("resnet32", generator=torch.Generator().manual_seed(0))
    return [p.numel() for p in model.parameters()]


def _lm_sizes():
    """The LM path's 54 leaves (d_model 512, 8 heads, 4 layers, T 2048,
    vocab 1000), shapes only."""
    with torch.device("meta"):
        model = transformer_lm.TransformerLM(1000, max_len=2048, d_model=512, n_heads=8,
                                             n_layers=4, kfac_embedding=True)
    return [p.numel() for p in model.parameters()]


# leaf sizes: ResNet-32's 95 leaves, the LM's 54, empty and odd leaves, and
# 2000 leaves (three launches: 896 + 896 + 208)
SGD_LEAF_SETS = {
    "resnet32": _resnet32_sizes,
    "lm": _lm_sizes,
    "empty_and_odd": lambda: [0, 1, 4095, 4096, 4097, 0, 3 * 4096 + 3, 0],
    "all_empty_then_some": lambda: [0] * 900 + [5, 0, 9000],
    "two_thousand": lambda: [(i * 37) % 9000 for i in range(2000)],
}


def _leaf_of_block(first_chunk, count, b):
    """``csrc/fused_sgd.cu``'s binary search: the last leaf whose first chunk
    is at most ``b``."""
    lo, hi = 0, count - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first_chunk[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("leaf_set", sorted(SGD_LEAF_SETS))
def test_sgd_chunk_plan_covers_every_element_once(leaf_set):
    sizes = SGD_LEAF_SETS[leaf_set]()
    hits = [np.zeros(n, dtype=np.int64) for n in sizes]
    leaves_seen = []
    for lo, k, cap, offsets in tapply.plan_sgd_tables(sizes):
        assert k <= cap and len(offsets) == k + 1
        leaves_seen.extend(range(lo, lo + k))
        for b in range(offsets[-1]):  # one block per chunk
            leaf = _leaf_of_block(offsets, k, b)
            n = sizes[lo + leaf]
            start = (b - offsets[leaf]) * tapply.SGD_CHUNK
            length = min(tapply.SGD_CHUNK, n - start)
            assert 0 <= start and 0 < length  # inside its leaf: no chunk crosses one
            # the kernel's float4 body (float4 i covers 4i .. 4i+3, i < nv),
            # then its scalar tail (thread t takes 4·nv + t)
            nv = length >> 2
            hits[lo + leaf][start:start + 4 * nv] += 1
            tail = np.arange(256) + 4 * nv
            hits[lo + leaf][start + tail[tail < length]] += 1
    for n, h in zip(sizes, hits):
        assert (h == 1).all(), f"a leaf of {n} elements is not covered exactly once"
    # every leaf with elements is in a launch; a launch of only empty leaves is dropped
    assert {i for i, n in enumerate(sizes) if n} <= set(leaves_seen)


@pytest.mark.parametrize("leaves,launches,caps", [
    (1, 1, [64]), (54, 1, [64]), (95, 1, [256]), (161, 1, [256]), (256, 1, [256]),
    (257, 1, [896]), (896, 1, [896]), (897, 2, [896, 64]), (2000, 3, [896, 896, 256]),
])
def test_sgd_tables_fit_the_kernel_argument(leaves, launches, caps):
    tables = tapply.plan_sgd_tables([5] * leaves)
    assert len(tables) == launches
    assert [cap for _, _, cap, _ in tables] == caps
    for cap in caps:
        table = tapply._table_type(cap)
        # LeafTable<cap> (8-byte aligned) then the lr pointer, momentum and
        # weight decay
        arg_bytes = (ctypes.sizeof(table) + ctypes.sizeof(ctypes.c_void_p)
                     + 2 * ctypes.sizeof(ctypes.c_float))
        assert arg_bytes <= tapply.SGD_ARG_LIMIT
        # three pointers and a size per leaf, first chunks, count
        assert ctypes.sizeof(table) == 32 * cap + 4 * (cap + 1) + 4


def test_sgd_alignment_is_classified_per_leaf():
    p = [0x1000, 0x1010, 0x1004, 0x2000, 0x3000]
    g = [0x4000, 0x4010, 0x4000, 0x4008, 0x5000]
    m = [0x6000, 0x6020, 0x6000, 0x6000, 0x600C]
    assert tapply.sgd_vector_leaves(p, g, m) == [True, True, False, False, False]


@pytest.mark.parametrize("vocab", [1, 7, 1000, 50257, 98304, 98305, 200000, 250000, 1 << 20])
def test_token_vocab_slicing_covers_the_vocabulary(vocab):
    bins, clusters = tfk.token_count_plan(vocab)
    assert 1 <= bins <= tfk.TOKEN_MAX_BINS  # each block's bins fit its 48 KB
    owner = np.zeros(vocab, dtype=np.int64)
    for c in range(clusters):
        v0 = c * tfk.TOKEN_CLUSTER * bins  # the kernel's cluster base
        for rank in range(tfk.TOKEN_CLUSTER):
            base = v0 + rank * bins
            owner[base:min(base + bins, vocab)] += 1
    assert (owner == 1).all()
    # as few clusters as the shared memory allows, none of them idle
    assert clusters == -(-vocab // (tfk.TOKEN_CLUSTER * tfk.TOKEN_MAX_BINS))
    assert (clusters - 1) * tfk.TOKEN_CLUSTER * bins < vocab


def test_cpu_paths_keep_their_eager_behaviour():
    ids = torch.tensor([[0, 3, 9]])
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 5\)"):
        tfk.compute_a_embed_fused(ids, 5)
    tfk.check_token_ids("cpu")  # nothing is deferred on the CPU
    r = np.random.RandomState(3)
    names = ["a", "b"]
    params = {n: torch.from_numpy(r.randn(4, 3).astype(np.float32)) for n in names}
    grads = {n: torch.from_numpy(r.randn(4, 3).astype(np.float32)) for n in names}
    trace = {n: torch.zeros(4, 3) for n in names}
    want_p = [params[n].clone() for n in names]
    want_m = [trace[n].clone() for n in names]
    tapply.fused_sgd_apply_plain(want_p, [grads[n] for n in names], want_m, 0.1, 0.9, 1e-4)
    plans = {}
    before = tapply.fused_sgd_apply.launches
    assert tapply.dispatch_sgd_apply(params, grads, trace, 0.1, 0.9, 1e-4, kind="auto", plans=plans)
    assert tapply.fused_sgd_apply.launches == before and not plans  # plain version, no plan
    for n, p, m in zip(names, want_p, want_m):
        assert torch.equal(params[n], p) and torch.equal(trace[n], m)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tapply.SGDPlan(list(params.values()), list(trace.values()))
