// Flash attention forward, dQ and dK/dV, float32, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of kfac_pytorch_tpu/ops/flash_attention.py:
//   kfac_flash_fwd  <- _flash_forward  (body _fwd_kernel)
//   kfac_flash_dq   <- _flash_backward (body _bwd_dq_kernel)
//   kfac_flash_dkv  <- _flash_backward (body _bwd_dkv_kernel)
// For q, k, v of shape [B, T, H, D] (read through their strides, the last
// dimension contiguous) and s = (q·scale)·kᵀ, scale = 1/sqrt(D):
//   forward:  o = softmax(s) · v, lse = logsumexp(s)       o [B, T, H, D],
//                                                          lse [B, H, T]
//   dQ:       p = exp(s − lse), dS = p ⊙ (dO·vᵀ − Δ), dq = dS·k·scale
//   dK, dV:   dk = dSᵀ·(q·scale), dv = pᵀ·dO
// with Δ = rowsum(dO ⊙ o) [B, H, T] computed by the caller, as the JAX
// version computes it outside its kernels. Masked logits (causal, or a key
// past the end of a ragged last tile) take the same -1e30 the Pallas
// kernels use, not -inf, so a row whose first tile is all masked cannot
// produce NaN; in the backward their p is exactly 0.
//
// What bounds it on this card: operations. Causal attention does about
// 2·B·H·T²·D FLOPs forward and 7·B·H·T²·D backward (3 for dQ, 4 for dK/dV;
// half of each under the mask) against O(B·T·H·D) bytes: ~17 and ~60 GFLOP
// for ~34 and ~67 MB at B=4, H=8, T=2048, D=64 — far above the ridge.
//
// Every product (s = q·kᵀ and P·V forward; s and dP = dO·vᵀ in both
// backward kernels, dS·k in dQ, pᵀ·dO and dSᵀ·q in dK/dV) runs on the
// tensor cores as 3xTF32 (csrc/tf32_mma.cuh): mma.sync m16n8k8 TF32 on
// operands split in registers as x = big + small, summed in float32 —
// about float32 accuracy (tests/test_torch_port_flash.py emulates it
// against float64) at three TF32 products per product. The bound is
// therefore 3 × FLOPs over the 495 TFLOP/s TF32 rate: 0.104 ms forward,
// 0.156 ms for dQ and 0.208 ms for dK/dV at the shape above (the CUDA
// cores' float32 bound: 0.256, 0.385 and 0.513 ms). A single TF32 product
// would miss the tolerances.
//
// The Pallas grid carries the online-softmax state (forward) or the
// gradient sums (backward) across its sequential innermost axis; here that
// axis becomes a loop inside one block:
//   forward, dQ: one block per (b·h, 64-row query tile), looping over key
//                tiles (only those at or left of the diagonal when causal);
//   dK/dV:       one block per (b·h, 64-row key tile), looping over query
//                tiles.
// Each block owns its output rows (no atomics: deterministic), 4 warps of
// 16 rows each. A warp keeps its s (and dP) fragments, its row statistics
// and its output accumulators in registers; p and dS go on to the next
// product without a trip through shared memory, because the sum over keys
// (queries) may run in any order: the B operand reads its rows in the
// order that matches the C fragment's columns (mma_scores_times_rows).
// The owned tiles load once; the walked tiles (K, V for the forward and
// dQ; Q, dO, lse, Δ for dK/dV) stream through a two-stage ring of cp.async
// copies, so the next tile's loads overlap this tile's products. Rows are
// padded to D + 4 floats, which makes every fragment load conflict-free.
// q·scale moves to s's and dk's epilogues (cp.async cannot scale). Under
// the causal mask the grid's slow axis puts the longest tiles first. D =
// 128 streams 32-row tiles (the dk, dv accumulators take 128 registers a
// thread). cp.async needs 16-byte-aligned rows: the wrappers refuse other
// views.
//
// Accuracy over long sums. The tensor cores truncate (round toward zero)
// the float32 sums they accumulate, so a sum of N products carried there
// has an error that grows with N against its own size. In the forward,
// each key tile's P·V goes into a fresh fragment that is added on the CUDA
// cores (rounded) to the float32 output accumulator, o = o·exp(m_old −
// m_new) + P·V, which the online softmax rescales anyway: its error does
// not grow with T. dQ sums a row's keys, whose weights p sum to 1: ~7e-6
// of the largest entry up to T = 16384 (NVIDIA H100 80GB HBM3, 700 W). dK
// and dV sum every query at or past a key: carried over all of them on the
// tensor cores they drifted to 4.4e-5 of the largest entry at T = 4096
// and 1.6e-4 at T = 16384 on that card, past the 1e-4 tolerance. So
// flash_dkv's sum over the queries is split into chunks of chunk_rows
// query rows (2048, ops/flash_attention.py DKV_CHUNK_ROWS), one launch a
// chunk in order: launch z sums its chunk's query tiles on the tensor
// cores and adds that partial dk, dv to what launches 0..z−1 wrote, one
// float32 read-add-write on the CUDA cores (rounded) after the loop. The
// drift is that of one chunk at every T, no workspace is needed, and a
// sequence of one chunk (the LM's T = 2048) runs as before, bit for bit,
// in one launch. Folding the accumulators into a float32 sum inside the
// loop instead (in registers or in global memory) made ptxas spill at D =
// 64 and spill more at D = 128; the chunk split leaves the loop's
// registers as they were.
//
// Every sequence length runs the kernels: the last tile's rows past T load
// as zeros and are masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns, 16 per warp
constexpr float kNegInf = -1e30f;

struct View {  // strides, in floats, of a [B, T, H, D] tensor
  long long b, t, h;
};

template <int D>
struct Tiles {
  static constexpr int kLd = D + 4;                  // padded row stride
  static constexpr int kStream = D <= 64 ? 64 : 32;  // rows of a streamed tile
  static constexpr int kOwn = kRows * kLd;           // floats of an owned tile
  static constexpr int kTile = kStream * kLd;        // floats of a streamed tile
  static_assert(D % 8 == 0, "head dimension must be a multiple of 8");
  static_assert((kStream * D / 4) % kThreads == 0, "whole copies per thread");
};

// s = X·Yᵀ for the warp's 16 rows of X and N rows of Y (row-major, stride
// D + 4), as N/8 C fragments: s[j] holds columns 8j + 2t, 8j + 2t + 1
template <int D, int N>
__device__ __forceinline__ void mma_rows_dot_rows(const float* __restrict__ X,
                                                  const float* __restrict__ Y,
                                                  float s[N / 8][4]) {
  constexpr int L = D + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    uint32_t ab[4], as[4];
    split4(X[g * L + d + t], X[(g + 8) * L + d + t], X[g * L + d + t + 4],
           X[(g + 8) * L + d + t + 4], ab, as);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float* y = Y + (8 * j + g) * L + d + t;
      mma_3xtf32(s[j], ab, as, y[0], y[4]);
    }
  }
}

// acc += P·Y for P (16 x N) in the C fragments of mma_rows_dot_rows and Y
// (N rows x D, stride D + 4). A C fragment holds columns 2t, 2t + 1 where an
// A fragment wants t, t + 4: inside each 8-wide step the sum over N runs in
// the order 2t → t, 2t + 1 → t + 4, so P's registers serve as A as they are
// and the B fragment reads Y's rows 2t and 2t + 1.
template <int D, int N>
__device__ __forceinline__ void mma_scores_times_rows(
    const float p[N / 8][4], const float* __restrict__ Y, float acc[D / 8][4]) {
  constexpr int L = D + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ab[4], as[4];
    split4(p[j][0], p[j][2], p[j][1], p[j][3], ab, as);
    const float* y = Y + (8 * j + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) mma_3xtf32(acc[n], ab, as, y[8 * n], y[L + 8 * n]);
  }
}

// rows [r0, r0 + R) of one (b, h) slice into an R x D tile at stride D + 4,
// in 16-byte copies; rows past T are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile_async(float* __restrict__ dst,
                                                const float* __restrict__ src,
                                                long long row_stride, int r0,
                                                int T) {
  constexpr int C = D / 4, L = D + 4;
#pragma unroll
  for (int i = 0; i < R * C / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / C, c = e % C, t = r0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * L + 4 * c, src + (long long)(ok ? t : r0) * row_stride + 4 * c,
               ok ? 16 : 0);
  }
}

// entries [r0, r0 + R) of a length-T row (lse or Δ); past T zero-filled
template <int R>
__device__ __forceinline__ void load_stats_async(float* __restrict__ dst,
                                                 const float* __restrict__ src,
                                                 int r0, int T) {
  for (int e = threadIdx.x; e < R; e += kThreads) {
    const int t = r0 + e;
    cp_async4(dst + e, src + (t < T ? t : r0), t < T);
  }
}

__device__ __forceinline__ bool live(int qi, int kj, int T, int causal) {
  return qi < T && kj < T && (!causal || kj <= qi);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, View vq, View vk, View vv,
          float* __restrict__ o, float* __restrict__ lse, int H, int T,
          int causal, float scale) {
  using S = Tiles<D>;
  constexpr int L = S::kLd, BN = S::kStream;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + S::kOwn;  // stage i: K at ring + 2i·kTile, then V
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // longest first: under the causal mask the last query tile walks the
  // most key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * vk.b + h * vk.h;
  const float* vb = v + b * vv.b + h * vv.h;
  load_tile_async<D, kRows>(Qs, q + b * vq.b + h * vq.h, vq.t, q0, T);
  load_tile_async<D, BN>(ring, kb, vk.t, 0, T);
  load_tile_async<D, BN>(ring + S::kTile, vb, vv.t, 0, T);
  cp_async_commit();

  const int r0 = q0 + 16 * warp + g;  // this lane's rows: r0 and r0 + 8
  // row max and, per lane, its share of the row sum (one quad of lanes
  // holds a row; the shares are added at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int tiles = (T + BN - 1) / BN;
  const int nk = causal ? min(tiles, (q0 + kRows) / BN) : tiles;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile's copies overlap this tile's products
      float* next = ring + ((kt + 1) & 1) * 2 * S::kTile;
      load_tile_async<D, BN>(next, kb, vk.t, (kt + 1) * BN, T);
      load_tile_async<D, BN>(next + S::kTile, vb, vv.t, (kt + 1) * BN, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (kt & 1) * 2 * S::kTile;
    const float* Vs = Ks + S::kTile;
    float s[BN / 8][4];
    mma_rows_dot_rows<D, BN>(Qs + 16 * warp * L, Ks, s);
    const int k0 = kt * BN;
    const bool edge = k0 + BN > T || (causal && k0 + BN - 1 > q0 + 16 * warp);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (edge && (kj >= T || (causal && kj > r0 + 8 * i))) x = kNegInf;
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    // this tile's P·V in a fresh fragment, added to the rescaled output
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
    mma_scores_times_rows<D, BN>(s, Vs, pv);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * corr[e >> 1] + pv[n][e];
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = r0 + 8 * i;
    if (qi >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* row = o + (((long long)b * T + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    if (t == 0) lse[(long long)bh * T + qi] = m[i] + logf(den);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dq, int H,
         int T, int causal, float scale) {
  using S = Tiles<D>;
  constexpr int L = S::kLd, BN = S::kStream;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::kOwn;
  float* ring = dOs + S::kOwn;  // stage i: K at ring + 2i·kTile, then V
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // longest first: under the causal mask the last query tile walks the
  // most key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * vk.b + h * vk.h;
  const float* vb = v + b * vv.b + h * vv.h;
  load_tile_async<D, kRows>(Qs, q + b * vq.b + h * vq.h, vq.t, q0, T);
  load_tile_async<D, kRows>(dOs, dout + b * vdo.b + h * vdo.h, vdo.t, q0, T);
  load_tile_async<D, BN>(ring, kb, vk.t, 0, T);
  load_tile_async<D, BN>(ring + S::kTile, vb, vv.t, 0, T);
  cp_async_commit();

  const int r0 = q0 + 16 * warp + g;  // this lane's rows: r0 and r0 + 8
  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    row_lse[i] = qi < T ? lse[(long long)bh * T + qi] : 0.f;
    row_delta[i] = qi < T ? delta[(long long)bh * T + qi] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int tiles = (T + BN - 1) / BN;
  const int nk = causal ? min(tiles, (q0 + kRows) / BN) : tiles;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile's copies overlap this tile's products
      float* next = ring + ((kt + 1) & 1) * 2 * S::kTile;
      load_tile_async<D, BN>(next, kb, vk.t, (kt + 1) * BN, T);
      load_tile_async<D, BN>(next + S::kTile, vb, vv.t, (kt + 1) * BN, T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (kt & 1) * 2 * S::kTile;
    const float* Vs = Ks + S::kTile;
    float s[BN / 8][4], dp[BN / 8][4];
    mma_rows_dot_rows<D, BN>(Qs + 16 * warp * L, Ks, s);
    mma_rows_dot_rows<D, BN>(dOs + 16 * warp * L, Vs, dp);
    const int k0 = kt * BN;
    const bool edge = k0 + BN > T || (causal && k0 + BN - 1 > q0 + 16 * warp);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = k0 + 8 * j + 2 * t + (e & 1);
        const float p = !edge || live(r0 + 8 * i, kj, T, causal)
                            ? expf(s[j][e] * scale - row_lse[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - row_delta[i]);  // dS
      }
    mma_scores_times_rows<D, BN>(dp, Ks, acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= T) continue;
    float* row = dq + (((long long)b * T + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// Block (b·h, key tile) of launch `chunk` sums the query tiles [chunk·
// chunk_tiles, (chunk + 1)·chunk_tiles) of its key tile: chunk 0 writes its
// dk, dv rows, a later chunk adds its sums to them (see "Accuracy over
// long sums").
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dk,
          float* __restrict__ dv, int H, int T, int causal, float scale,
          int chunk, int chunk_tiles) {
  using S = Tiles<D>;
  constexpr int L = S::kLd, BN = S::kStream;
  constexpr int kStage = 2 * S::kTile + 2 * BN;  // Q, dO, lse, Δ
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::kOwn;
  float* ring = Vs + S::kOwn;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // longest first: under the causal mask the first key tile walks the most
  // query tiles
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + b * vq.b + h * vq.h;
  const float* db = dout + b * vdo.b + h * vdo.h;
  const float* lb = lse + (long long)bh * T;
  const float* deb = delta + (long long)bh * T;
  const auto load_stage = [&](int qt, float* st) {
    load_tile_async<D, BN>(st, qb, vq.t, qt * BN, T);
    load_tile_async<D, BN>(st + S::kTile, db, vdo.t, qt * BN, T);
    load_stats_async<BN>(st + 2 * S::kTile, lb, qt * BN, T);
    load_stats_async<BN>(st + 2 * S::kTile + BN, deb, qt * BN, T);
  };
  const int tiles = min((T + BN - 1) / BN, (chunk + 1) * chunk_tiles);
  const int first = max(causal ? k0 / BN : 0, chunk * chunk_tiles);
  if (first < tiles) {  // else no query of this chunk sees the key tile: zeros
    load_tile_async<D, kRows>(Ks, k + b * vk.b + h * vk.h, vk.t, k0, T);
    load_tile_async<D, kRows>(Vs, v + b * vv.b + h * vv.h, vv.t, k0, T);
    load_stage(first, ring);
  }
  cp_async_commit();

  const int r0 = k0 + 16 * warp + g;  // this lane's key rows: r0 and r0 + 8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  for (int qt = first; qt < tiles; ++qt) {
    const int i = qt - first;
    if (qt + 1 < tiles) load_stage(qt + 1, ring + ((i + 1) & 1) * kStage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qs = ring + (i & 1) * kStage;
    const float* dOs = Qs + S::kTile;
    const float* col_lse = dOs + S::kTile;
    const float* col_delta = col_lse + BN;
    float st[BN / 8][4], dpt[BN / 8][4];  // sᵀ, dPᵀ: key rows x query columns
    mma_rows_dot_rows<D, BN>(Ks + 16 * warp * L, Qs, st);
    mma_rows_dot_rows<D, BN>(Vs + 16 * warp * L, dOs, dpt);
    const int q0 = qt * BN;
    const bool edge = q0 + BN > T || (causal && q0 < k0 + 16 * warp + 15);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(col_lse + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(col_delta + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1, qi = q0 + 8 * j + 2 * t + c;
        const float p = !edge || live(qi, r0 + 8 * (e >> 1), T, causal)
                            ? expf(st[j][e] * scale - (c ? l2.y : l2.x)) : 0.f;
        st[j][e] = p;                                     // pᵀ
        dpt[j][e] = p * (dpt[j][e] - (c ? d2.y : d2.x));  // dSᵀ
      }
    }
    mma_scores_times_rows<D, BN>(st, dOs, dv_acc);
    mma_scores_times_rows<D, BN>(dpt, Qs, dk_acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = r0 + 8 * i;
    if (kj >= T) continue;
    const long long off = (((long long)b * T + kj) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2* pk = reinterpret_cast<float2*>(dk + off + 8 * n);
      float2* pv = reinterpret_cast<float2*>(dv + off + 8 * n);
      float2 sk = make_float2(__fmul_rn(dk_acc[n][2 * i], scale),
                              __fmul_rn(dk_acc[n][2 * i + 1], scale));
      float2 sv = make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      if (chunk > 0) {  // the earlier chunks' sum plus this one's, rounded
        const float2 ok = *pk, ov = *pv;
        sk = make_float2(__fadd_rn(ok.x, sk.x), __fadd_rn(ok.y, sk.y));
        sv = make_float2(__fadd_rn(ov.x, sv.x), __fadd_rn(ov.y, sv.y));
      }
      *pk = sk;
      *pv = sv;
    }
  }
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

// every kernel here takes more than the 48 KB of shared memory a launch
// gets without asking
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int fwd(const float* q, const float* k, const float* v, const long long* st,
        float* o, float* lse, int B, int T, int H, int causal, float scale,
        cudaStream_t s) {
  using S = Tiles<D>;
  const size_t smem = sizeof(float) * (S::kOwn + 4 * S::kTile);
  cudaError_t err = allow_smem(flash_fwd<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_fwd<D><<<grid, kThreads, smem, s>>>(q, k, v, view(st), view(st + 3),
                                            view(st + 6), o, lse, H, T,
                                            causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const float* q, const float* k, const float* v, const float* dout,
       const long long* st, const float* lse, const float* delta, float* dqp,
       int B, int T, int H, int causal, float scale, cudaStream_t s) {
  using S = Tiles<D>;
  const size_t smem = sizeof(float) * (2 * S::kOwn + 4 * S::kTile);
  cudaError_t err = allow_smem(flash_dq<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_dq<D><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, view(st), view(st + 3), view(st + 6), view(st + 9), lse,
      delta, dqp, H, T, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const long long* st, const float* lse, const float* delta, float* dk,
        float* dv, int chunk_rows, int B, int T, int H, int causal, float scale,
        cudaStream_t s) {
  using S = Tiles<D>;
  const size_t smem =
      sizeof(float) * (2 * S::kOwn + 2 * (2 * S::kTile + 2 * S::kStream));
  cudaError_t err = allow_smem(flash_dkv<D>, smem);
  if (err != cudaSuccess) return (int)err;
  if (chunk_rows <= 0 || chunk_rows % S::kStream) return (int)cudaErrorInvalidValue;
  const int chunks = (T + chunk_rows - 1) / chunk_rows, tiles = (T + kRows - 1) / kRows;
  for (int z = 0; z < chunks; ++z) {
    // chunk 0 writes every key tile (zeros where none of its queries sees
    // the key); under the causal mask a later chunk's queries see only the
    // key tiles before its end
    const int keys = causal && z > 0 ? min(tiles, ((z + 1) * chunk_rows + kRows - 1) / kRows)
                                     : tiles;
    flash_dkv<D><<<dim3(B * H, keys), kThreads, smem, s>>>(
        q, k, v, dout, view(st), view(st + 3), view(st + 6), view(st + 9), lse,
        delta, dk, dv, H, T, causal, scale, z, chunk_rows / S::kStream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// strides: host array of [B, T, H] strides in floats, 3 per tensor, in
// argument order (q, k, v; then dO for the backward entries). Head
// dimensions 32, 64 and 128 are instantiated.
extern "C" int kfac_flash_fwd(const void* q, const void* k, const void* v,
                              const void* strides, void* o, void* lse, int B,
                              int T, int H, int D, int causal, float scale,
                              void* stream) {
  const float *Q = static_cast<const float*>(q), *K = static_cast<const float*>(k),
              *V = static_cast<const float*>(v);
  const long long* st = static_cast<const long long*>(strides);
  float *O = static_cast<float*>(o), *L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return fwd<32>(Q, K, V, st, O, L, B, T, H, causal, scale, s);
    case 64: return fwd<64>(Q, K, V, st, O, L, B, T, H, causal, scale, s);
    case 128: return fwd<128>(Q, K, V, st, O, L, B, T, H, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int kfac_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* strides,
                             const void* lse, const void* delta, void* dq_out,
                             int B, int T, int H, int D, int causal,
                             float scale, void* stream) {
  const float *Q = static_cast<const float*>(q), *K = static_cast<const float*>(k),
              *V = static_cast<const float*>(v),
              *dO = static_cast<const float*>(dout),
              *L = static_cast<const float*>(lse),
              *Dl = static_cast<const float*>(delta);
  const long long* st = static_cast<const long long*>(strides);
  float* dQ = static_cast<float*>(dq_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dq<32>(Q, K, V, dO, st, L, Dl, dQ, B, T, H, causal, scale, s);
    case 64: return dq<64>(Q, K, V, dO, st, L, Dl, dQ, B, T, H, causal, scale, s);
    case 128: return dq<128>(Q, K, V, dO, st, L, Dl, dQ, B, T, H, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// chunk_rows: query rows a launch sums, a multiple of the streamed tile
// (64 rows, 32 at D = 128); ceil(T / chunk_rows) launches in order
extern "C" int kfac_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* strides,
                              const void* lse, const void* delta, void* dk_out,
                              void* dv_out, int chunk_rows, int B, int T,
                              int H, int D, int causal, float scale,
                              void* stream) {
  const float *Q = static_cast<const float*>(q), *K = static_cast<const float*>(k),
              *V = static_cast<const float*>(v),
              *dO = static_cast<const float*>(dout),
              *L = static_cast<const float*>(lse),
              *Dl = static_cast<const float*>(delta);
  const long long* st = static_cast<const long long*>(strides);
  float *dK = static_cast<float*>(dk_out), *dV = static_cast<float*>(dv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dkv<32>(Q, K, V, dO, st, L, Dl, dK, dV, chunk_rows, B, T, H, causal, scale, s);
    case 64: return dkv<64>(Q, K, V, dO, st, L, Dl, dK, dV, chunk_rows, B, T, H, causal, scale, s);
    case 128: return dkv<128>(Q, K, V, dO, st, L, Dl, dK, dV, chunk_rows, B, T, H, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
