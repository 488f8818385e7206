"""The port's kernels of the LM slice: plain versions against the JAX package.

* Flash attention (kernels 5, 6 and 7): the port's differentiable
  ``flash_attention`` on CPU tensors runs its plain forward and backward;
  it is held to the JAX package's Pallas kernels run as that package's own
  tests run them (``interpret=True``), forward, saved logsumexp and the
  gradients of q, k and v, causal and not; a ragged length (T = 200, no
  multiple of the 64-row tile) against JAX ``full_attention``, which is
  what the JAX package runs at such a length. The CUDA kernels' numerical
  scheme (3xTF32 products on the tensor cores; in the forward, each key
  tile's P·V added to the rescaled output on the CUDA cores; in dK/dV,
  the tensor cores' truncated sums taken per ``DKV_CHUNK_ROWS`` query
  rows and the chunks added on the CUDA cores) is emulated in float32 and
  held to a float64 reference.
* Token counts (kernel 2): ``compute_a_embed_fused`` on CPU tensors against
  JAX ``compute_a_embed_fused(interpret=True)`` and both packages' oracles,
  BITWISE, at a vocabulary and a token count that are no tile multiples.

Tolerances: the JAX flash tests' own — forward 2e-5, gradients rtol 1e-4 /
atol 1e-5 (float32, other summation orders). Token counts are integers
divided once by N in float32: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops import factor_kernels as jfk
from kfac_pytorch_tpu.ops import factors as jf
from kfac_pytorch_tpu.ops.flash_attention import flash_attention as jflash
from kfac_pytorch_tpu.parallel.context import full_attention as jfull
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk
from kfac_pytorch_tpu_torch.ops import factors as tf
from kfac_pytorch_tpu_torch.ops import flash_attention as tflash
from kfac_pytorch_tpu_torch.parallel import context as tcontext


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(b, t, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _weights(shape, seed):
    """A fixed cotangent for the output, so the loss is Σ out ⊙ w."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_value_and_grads(fn, arrs, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_value_and_grads(fn, arrs, w):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * w)

    args = [jnp.asarray(a) for a in arrs]
    return np.asarray(fn(*args)), [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_interpret(causal):
    arrs = _qkv(1, 256, 2, 32, seed=10)
    w = _weights(arrs[0].shape, seed=11)
    before = [tflash.flash_forward.launches, tflash.flash_backward_dq.launches,
              tflash.flash_backward_dkv.launches]
    got, got_g = _port_value_and_grads(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal), arrs, w
    )
    want, want_g = _jax_value_and_grads(
        lambda q, k, v: jflash(q, k, v, causal=causal, interpret=True), arrs, w
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")
    # the plain route launched nothing
    assert before == [tflash.flash_forward.launches, tflash.flash_backward_dq.launches,
                      tflash.flash_backward_dkv.launches]


def test_flash_forward_lse_matches_pallas():
    """The saved residual: logsumexp of the scaled logits, [B, H, T]."""
    from kfac_pytorch_tpu.ops.flash_attention import _flash_forward

    q, k, v = _qkv(2, 128, 2, 32, seed=12)
    out, lse = tflash.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  True, 128, 128, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=2e-5, atol=2e-5)
    # JAX stores lse per (b·h) row, replicated over 128 lanes
    j_lse = np.asarray(j_lse)[..., 0].reshape(2, 2, 128)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=2e-5, atol=2e-5)


def test_flash_attention_ragged_length_matches_full_attention():
    arrs = _qkv(2, 200, 2, 32, seed=13)
    w = _weights(arrs[0].shape, seed=14)
    got, got_g = _port_value_and_grads(tflash.flash_attention, arrs, w)
    want, want_g = _jax_value_and_grads(lambda q, k, v: jfull(q, k, v, causal=True), arrs, w)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    q, k, v = _qkv(2, 24, 3, 16, seed=15)
    got = tcontext.full_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    want = jfull(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_best_attention_fn_on_cpu_is_exact_attention():
    assert tflash.best_attention_fn("cpu") is tcontext.full_attention


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    # validated before any launch: the shape rules hold on every device
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head dimensions"):
        tflash._check("flash_forward", q, q, q)
    q = torch.zeros(1, 8, 2, 64)
    strided = torch.zeros(1, 8, 64, 2).transpose(2, 3)  # [1, 8, 2, 64], last stride 2
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tflash._check("flash_forward", q, q, strided)
    assert tflash._check("flash_forward", q, q, q) == (1, 8, 2, 64)


def test_flash_wrappers_refuse_misaligned_rows():
    # the backward kernels copy 16-byte rows with cp.async
    q = torch.zeros(1, 8, 2, 64)
    shifted = torch.zeros(1 * 8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)
    odd_stride = torch.zeros(1, 8, 2, 66)[..., :64]
    for bad in (shifted, odd_stride):
        with pytest.raises(ValueError, match="aligned"):
            tflash._check("flash_backward_dq", q, bad, q, q)
    # q, k, v as views of one fused projection at offsets 0, H·D, 2·H·D
    qkv = torch.zeros(1, 8, 3 * 2 * 64)
    views = [x.reshape(1, 8, 2, 64) for x in qkv.split(2 * 64, dim=-1)]
    assert tflash._check("flash_backward_dq", *views, q) == (1, 8, 2, 64)


# --------------------------------------- kernels 6, 7: the 3xTF32 products


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped
    bits' range to the magnitude bits, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    """``a_small·b_big + a_big·b_small + a_big·b_big`` with ``big = tf32(x)``
    and ``small`` the remainder ``x − big`` truncated to TF32, as the CUDA
    kernels split (CUTLASS's OpMultiplyAddFastF32): products of TF32 values
    are exact in float32, the sums are float32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _backward(q, k, v, do, lse, delta, mm):
    """``flash_backward_plain``'s formulas, causal, with every product taken
    by ``mm`` on ``[B, H, T, D]`` matrices."""
    qh, kh, vh, dh = (x.transpose(1, 2) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(qh, kh.transpose(-1, -2)) * scale
    keep = torch.ones(q.shape[1], q.shape[1], dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros((), dtype=s.dtype))
    ds = p * (mm(dh, vh.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), dh)
    return [x.transpose(1, 2) for x in (dq, dk, dv)]


def test_flash_backward_3xtf32_keeps_float32_accuracy():
    """The backward kernels' numerical scheme, emulated: with every product
    in 3xTF32 the gradients stay within 1e-5 of the largest float64 entry,
    10x inside the card's 1e-4 tolerance, as IEEE float32 products do;
    with one TF32 product (big·big alone) they are at least 10x worse and
    break that tolerance. The emulation rounds its float32 sums; the
    tensor cores truncate theirs, an error that grows with the sum's length
    (``chip_smoke.py`` measures the kernels on the card at the LM's T)."""
    r = np.random.RandomState(18)
    q, k, v, do = (torch.from_numpy(r.randn(1, 256, 2, 64).astype(np.float32)) for _ in range(4))
    # float64 forward residuals, rounded to float32 as the kernels get them
    s = torch.einsum("bthd,bshd->bhts", q.double() / 8.0, k.double())
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(), -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v.double())
    delta = (do.double() * out).sum(dim=-1).transpose(1, 2)
    ref = _backward(*(x.double() for x in (q, k, v, do)), lse, delta, lambda a, b: a @ b)

    def err(grads):
        return max(float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(grads, ref))

    lse32, delta32 = lse.float(), delta.float()
    plain = err(tflash.flash_backward_plain(q, k, v, do, lse32, delta32, True))
    three = err(_backward(q, k, v, do, lse32, delta32, _mm_3xtf32))
    one = err(_backward(q, k, v, do, lse32, delta32, _mm_1xtf32))
    assert plain <= 1e-5
    assert three <= 1e-5
    assert one >= 10 * three and one > 1e-4


def _truncated_add(acc, part):
    """``acc + part`` (float32 plus a float64 partial sum) rounded toward
    zero to float32, as the tensor cores accumulate."""
    s = acc.double() + part
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _dkv_sum(p, do, chunk=None):
    """``pᵀ·dO`` over ``[T, ·]`` query rows as ``flash_dkv`` sums it: 8
    rows a tensor-core step, each of 3xTF32's three products (exact in
    float64) added to the float32 fragment with truncation; with ``chunk``,
    each chunk of that many rows summed so from zero, and the chunks' sums
    added in order in float32 (rounded), as each later chunk's launch adds
    its sums to the earlier ones'."""
    pb, db = _tf32(p), _tf32(do)
    ps, ds = _tf32_truncated(p - pb), _tf32_truncated(do - db)
    total = None
    for lo in range(0, p.shape[0], chunk or p.shape[0]):
        acc = torch.zeros(p.shape[1], do.shape[1])
        for r in range(lo, min(lo + (chunk or p.shape[0]), p.shape[0]), 8):
            rows = slice(r, r + 8)
            for a, b in ((ps, db), (pb, ds), (pb, db)):
                acc = _truncated_add(acc, a[rows].double().T @ b[rows].double())
        total = acc if total is None else total + acc
    return total


def test_flash_dkv_chunked_sums_keep_their_error_flat_in_t():
    """Kernel 7's sums over the queries, emulated for the 64 keys of the
    first tile (every query attends them, with weights ~1/(q+1)): carried
    on the tensor cores alone, the truncation drifts with T (past 1e-4 of
    the largest float64 entry at T = 8192; an NVIDIA H100 80GB HBM3 at
    700 W measured 1.6e-4 at T = 16384); summed in chunks of ``DKV_CHUNK_ROWS`` rows added on the CUDA
    cores, the error at T = 8192 stays within 1.5x of one chunk's (T =
    2048, where the chunked sum is the whole sum) and under 5e-5."""
    r = np.random.RandomState(5)
    chunk = tflash.DKV_CHUNK_ROWS
    errs = {}
    for t in (chunk, 4 * chunk):
        p = torch.from_numpy((r.uniform(0, 2, size=(t, 64)) / np.arange(1, t + 1)[:, None])
                             .astype(np.float32))
        do = torch.from_numpy(r.randn(t, 64).astype(np.float32))
        ref = p.double().T @ do.double()
        errs[t] = {c: float((_dkv_sum(p, do, c).double() - ref).abs().max() / ref.abs().max())
                   for c in (None, chunk)}
    assert errs[chunk][None] == errs[chunk][chunk]
    assert errs[4 * chunk][None] > 1e-4
    assert errs[4 * chunk][chunk] <= min(5e-5, 1.5 * errs[chunk][chunk])


def _forward_online(q, k, v, mm, tile=64):
    """Kernel 5's scheme on ``[T, D]`` matrices, causal: key tiles of
    ``tile`` rows, ``s`` and ``P·V`` taken by ``mm``, the running max and
    sum, and each tile's ``P·V`` added to the rescaled accumulator."""
    t = q.shape[0]
    scale = 1.0 / np.sqrt(q.shape[-1])
    rows = torch.arange(t)[:, None]
    m = torch.full((t, 1), -1e30, dtype=q.dtype)
    l = torch.zeros((t, 1), dtype=q.dtype)
    acc = torch.zeros_like(q)
    for k0 in range(0, t, tile):
        s = mm(q, k[k0:k0 + tile].T) * scale
        s = torch.where(torch.arange(k0, k0 + tile)[None, :] <= rows, s,
                        torch.tensor(-1e30, dtype=q.dtype))
        mx = torch.maximum(m, s.amax(dim=1, keepdim=True))
        corr, p = torch.exp(m - mx), torch.exp(s - mx)
        l, m = l * corr + p.sum(dim=1, keepdim=True), mx
        acc = acc * corr + mm(p, v[k0:k0 + tile])
    return acc / l, (m + torch.log(l)).squeeze(1)


def test_flash_forward_3xtf32_keeps_float32_accuracy():
    """The forward kernel's numerical scheme, emulated at the LM's length
    (T = 2048, D = 64, causal): with ``s`` and ``P·V`` in 3xTF32 and each
    key tile's ``P·V`` added to the rescaled float32 accumulator, out and
    lse stay within 2e-6 of the largest float64 entry, 10x inside the
    card's 2e-5 tolerance; one TF32 product is at least 10x worse and
    breaks it. The emulation rounds its float32 sums; the kernel's sum
    over keys is taken on the CUDA cores, rounded, one tile at a time."""
    r = np.random.RandomState(19)
    q, k, v = (torch.from_numpy(r.randn(2048, 64).astype(np.float32)) for _ in range(3))
    ref = _forward_online(q.double(), k.double(), v.double(), lambda a, b: a @ b)
    # the online scheme itself is exact attention
    plain = tflash.flash_forward_plain(*(x[None, :, None] for x in (q, k, v)), True)
    for got, want in zip((plain[0][0, :, 0], plain[1][0, 0]), ref):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 2e-6

    def err(fn):
        return max(float((g.double() - w).abs().max() / w.abs().max())
                   for g, w in zip(_forward_online(q, k, v, fn), ref))

    three, one = err(_mm_3xtf32), err(_mm_1xtf32)
    assert three <= 2e-6
    assert one >= 10 * three and one > 2e-5


# ------------------------------------------------------ kernel 2: token counts


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_token_count_plain_matches_pallas_bitwise(dtype):
    vocab = 1000
    ids = np.random.RandomState(16).randint(0, vocab, size=(3, 700)).astype(dtype)
    pallas = np.asarray(jfk.compute_a_embed_fused(jnp.asarray(ids.astype(np.int32)), vocab,
                                                  interpret=True))
    j_oracle = np.asarray(jf.compute_a_embed(jnp.asarray(ids.astype(np.int32)), vocab))
    t_ids = torch.from_numpy(ids)
    before = tfk.compute_a_embed_fused.launches
    got = tfk.compute_a_embed_fused(t_ids, vocab)
    assert tfk.compute_a_embed_fused.launches == before  # plain path: no launch
    assert got.dtype == torch.float32 and got.shape == (vocab,)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), j_oracle)
    np.testing.assert_array_equal(tf.compute_a_embed(t_ids, vocab).numpy(), j_oracle)
    np.testing.assert_array_equal(tfk.compute_a_embed_fused_plain(t_ids, vocab).numpy(), pallas)


def test_token_count_dispatch_routes_and_refusals():
    ids = torch.from_numpy(np.random.RandomState(17).randint(0, 50, size=(4, 9)))
    dense = tfk.dispatch_compute_a_embed(ids, 50, kind="dense")
    np.testing.assert_array_equal(dense.numpy(), tf.compute_a_embed(ids, 50).numpy())
    auto = tfk.dispatch_compute_a_embed(ids, 50, kind="auto")
    np.testing.assert_array_equal(auto.numpy(), dense.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dispatch_compute_a_embed(ids, 50, kind="kernel")
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 40\)"):
        tfk.compute_a_embed_fused(ids, 40)
    negative = ids.clone()
    negative[1, 2] = -1
    with pytest.raises(ValueError, match=r"ids must lie in"):
        tfk.compute_a_embed_fused(negative, 50)
    with pytest.raises(ValueError, match="int32 or int64"):
        tfk.compute_a_embed_fused(ids.float(), 50)
