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
// Forward. The CUDA cores in IEEE float32 (no TF32, no tensor cores), so
// the float32 peak of 67 TFLOP/s is its ceiling. The Pallas grid carries
// the online-softmax state in VMEM scratch across its sequential innermost
// axis; here that axis becomes a loop inside one block: one block per
// (b·h, 64-row query tile), looping over key tiles (only those at or left
// of the diagonal when causal). 256 threads form a 16x16 grid; each owns 4
// rows (ty + 16r) and, of a 64-wide tile, 4 columns (tx + 16c), or D/16
// columns of a D-wide one. Tiles sit row-major in shared memory with rows
// padded to D + 4 floats: the row products read float4s along D, and with
// that pad the 8 threads of a float4 phase hit 8 disjoint bank groups. Row
// statistics (max, sum) live in registers, reduced across the 16 threads
// of a row with warp shuffles.
//
// Backward. Every product (s = q·kᵀ and dP = dO·vᵀ in both kernels, dS·k in
// dQ, pᵀ·dO and dSᵀ·q in dK/dV) runs on the tensor cores as 3xTF32, as
// CUTLASS's OpMultiplyAddFastF32 does: mma.sync m16n8k8 TF32 on operands
// split in registers as x = big + small (big = x rounded to TF32, small =
// the remainder truncated to TF32), a·b ≈ a_small·b_big + a_big·b_small +
// a_big·b_big, summed in float32 — about float32 accuracy
// (tests/test_torch_port_flash.py emulates it against float64) at three
// TF32 products per product. The bound is therefore 3 × FLOPs over the
// 495 TFLOP/s TF32 rate: 0.156 ms for dQ and 0.208 ms for dK/dV at the
// shape above (the CUDA cores' float32 bound: 0.385 and 0.513 ms). A single
// TF32 product would miss the backward's 1e-4 tolerance. The tensor cores
// truncate (round toward zero) the float32 sums they accumulate, so the
// long sums over keys (queries) of dq, dk, dv drift with their length: at
// T = 2048 the kernels sit ~3e-5 of the largest entry from the float32
// plain version, inside the tolerance. Adding each step's products on the
// CUDA cores instead (rounded) removes the drift, but the temporaries it
// needs spill registers in dK/dV at D = 64.
//   dQ:    one block per (b·h, 64-row query tile), looping over key tiles;
//   dK/dV: one block per (b·h, 64-row key tile), looping over query tiles.
// Each block owns its output rows (no atomics: deterministic), 4 warps of
// 16 rows each. A warp keeps its s, dP (sᵀ, dPᵀ in dK/dV) fragments and
// its dq or dk, dv accumulators in registers; p and dS go on to the next
// product without a trip through shared memory, because the sum over keys
// (queries) may run in any order: the B operand reads its rows in the
// order that matches the C fragment's columns (mma_scores_times_rows).
// The owned tiles load once; the walked tiles (K, V for dQ; Q, dO, lse, Δ
// for dK/dV) stream through a two-stage ring of cp.async copies, so the
// next tile's loads overlap this tile's products. Rows are padded to D + 4
// floats, which makes every fragment load conflict-free. q·scale moves to
// s's and dk's epilogues (cp.async cannot scale). Under the causal mask
// the grid's slow axis puts the longest tiles first. D = 128 streams
// 32-row tiles (its dk, dv accumulators take 128 registers a thread).
// cp.async needs 16-byte-aligned rows: the wrappers refuse other views.
//
// Every sequence length runs the kernels: the last tile's rows past T load
// as zeros and are masked.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;      // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kR = kBlock / 16; // rows (and tile columns) per thread
constexpr int kPLd = kBlock + 4;  // row stride of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

struct View {  // strides, in floats, of a [B, T, H, D] tensor
  long long b, t, h;
};

template <int D>
struct Shape {
  static constexpr int kLd = D + 4;        // row stride of a 64 x D tile
  static constexpr int kTile = kBlock * kLd;
  static constexpr int kC = D / 16;        // D columns per thread
  static_assert(D % 16 == 0, "head dimension must be a multiple of 16");
};

// rows [r0, r0 + 64) of one (b, h) slice into a 64 x D tile, times mul;
// rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int r0, int T,
                                          float mul) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, c = e % D, t = r0 + r;
    dst[r * Shape<D>::kLd + c] =
        t < T ? src[(long long)t * row_stride + c] * mul : 0.f;
  }
}

// out[r][c] = Σ_d A[ty + 16r][d] · B[tx + 16c][d] over two 64 x D tiles
template <int D>
__device__ __forceinline__ void rows_dot_rows(const float* __restrict__ A,
                                              const float* __restrict__ B,
                                              float out[kR][kR]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  constexpr int L = Shape<D>::kLd;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c) out[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[kR], b[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      a[r] = *reinterpret_cast<const float4*>(&A[(ty + 16 * r) * L + d]);
#pragma unroll
    for (int c = 0; c < kR; ++c)
      b[c] = *reinterpret_cast<const float4*>(&B[(tx + 16 * c) * L + d]);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        float s = out[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        s = fmaf(a[r].w, b[c].w, s);
        out[r][c] = s;
      }
  }
}

// acc[r][c] += Σ_j P[ty + 16r][j] · V[j][tx + 16c], P a 64 x 64 score tile,
// V a 64 x D tile
template <int D>
__device__ __forceinline__ void scores_times_rows(
    const float* __restrict__ P, const float* __restrict__ V,
    float acc[kR][Shape<D>::kC]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  constexpr int L = Shape<D>::kLd, C = Shape<D>::kC;
#pragma unroll 2
  for (int j = 0; j < kBlock; j += 4) {
    float4 p[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      p[r] = *reinterpret_cast<const float4*>(&P[(ty + 16 * r) * kPLd + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = V[(j + jj) * L + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y
                       : jj == 2 ? p[r].z : p[r].w;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pr, v[c], acc[r][c]);
      }
    }
  }
}

// reductions over the 16 threads of one row (lanes tx = 0..15 of a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + S::kTile;
  float* Vs = Ks + S::kTile;
  float* Ps = Vs + S::kTile;  // 64 x 64, stride kPLd
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlock;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + b * vq.b + h * vq.h;
  const float* kb = k + b * vk.b + h * vk.h;
  const float* vb = v + b * vv.b + h * vv.h;
  load_tile<D>(Qs, qb, vq.t, q0, T, scale);

  float m[kR], l[kR], acc[kR][S::kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < S::kC; ++c) acc[r][c] = 0.f;
  }
  const int tiles = (T + kBlock - 1) / kBlock;
  const int nk = causal ? min(tiles, (int)blockIdx.x + 1) : tiles;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, kb, vk.t, k0, T, 1.f);
    load_tile<D>(Vs, vb, vv.t, k0, T, 1.f);
    __syncthreads();
    float s[kR][kR];
    rows_dot_rows<D>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const int kj = k0 + tx + 16 * c;
        if (kj >= T || (causal && kj > qi)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float corr = expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const float p = expf(s[r][c] - mx);
        Ps[(ty + 16 * r) * kPLd + tx + 16 * c] = p;
        sum += p;
      }
      l[r] = l[r] * corr + row_sum(sum);
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < S::kC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();
    scores_times_rows<D>(Ps, Vs, acc);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= T) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = o + (((long long)b * T + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < S::kC; ++c) orow[tx + 16 * c] = acc[r][c] / den;
    if (tx == 0) lse[(long long)bh * T + qi] = m[r] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// Backward (dQ, dK/dV): 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;  // rows a block owns, 16 per warp

template <int D>
struct Bwd {
  static constexpr int kLd = D + 4;                  // padded row stride
  static constexpr int kStream = D <= 64 ? 64 : 32;  // rows of a streamed tile
  static constexpr int kOwn = kBwdRows * kLd;        // floats of an owned tile
  static constexpr int kTile = kStream * kLd;        // floats of a streamed tile
  static_assert(D % 8 == 0, "head dimension must be a multiple of 8");
  static_assert((kStream * D / 4) % kBwdThreads == 0, "whole copies per thread");
};

// The 3xTF32 split, as CUTLASS's OpMultiplyAddFastF32 makes it: x = big +
// small + O(2^-21 |x|). big is x rounded to TF32 (10 mantissa bits) to
// nearest, ties away from zero: half a TF32 ulp added to the magnitude
// bits, the 13 low bits cleared — what cvt.rna.tf32.f32 computes for finite
// x, in 2 integer operations where sm_90a's cvt takes 4. small is the
// remainder x − big, exact in float32, truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// c += a·b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32 (as CUTLASS's OpMultiplyAddFastF32): the two cross
// terms first, then big·big; small·small is dropped. a is split by the
// caller (it serves a row of tiles), b = (b0, b1) here.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16x8: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8:  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C 16x8: c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

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
    split(X[g * L + d + t], ab[0], as[0]);
    split(X[(g + 8) * L + d + t], ab[1], as[1]);
    split(X[g * L + d + t + 4], ab[2], as[2]);
    split(X[(g + 8) * L + d + t + 4], ab[3], as[3]);
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
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const float* y = Y + (8 * j + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) mma_3xtf32(acc[n], ab, as, y[8 * n], y[L + 8 * n]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group of copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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
  for (int i = 0; i < R * C / kBwdThreads; ++i) {
    const int e = threadIdx.x + i * kBwdThreads;
    const int r = e / C, c = e % C, t = r0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * L + 4 * c, src + (long long)(ok ? t : r0) * row_stride + 4 * c, ok);
  }
}

// entries [r0, r0 + R) of a length-T row (lse or Δ); past T zero-filled
template <int R>
__device__ __forceinline__ void load_stats_async(float* __restrict__ dst,
                                                 const float* __restrict__ src,
                                                 int r0, int T) {
  for (int e = threadIdx.x; e < R; e += kBwdThreads) {
    const int t = r0 + e;
    cp_async4(dst + e, src + (t < T ? t : r0), t < T);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dq, int H,
         int T, int causal, float scale) {
  using S = Bwd<D>;
  constexpr int L = S::kLd, BN = S::kStream;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::kOwn;
  float* ring = dOs + S::kOwn;  // stage i: K at ring + 2i·kTile, then V
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // longest first: under the causal mask the last query tile walks the
  // most key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * vk.b + h * vk.h;
  const float* vb = v + b * vv.b + h * vv.h;
  load_tile_async<D, kBwdRows>(Qs, q + b * vq.b + h * vq.h, vq.t, q0, T);
  load_tile_async<D, kBwdRows>(dOs, dout + b * vdo.b + h * vdo.h, vdo.t, q0, T);
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
  const int nk = causal ? min(tiles, (q0 + kBwdRows) / BN) : tiles;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile's copies overlap this tile's products
      float* next = ring + ((kt + 1) & 1) * 2 * S::kTile;
      load_tile_async<D, BN>(next, kb, vk.t, (kt + 1) * BN, T);
      load_tile_async<D, BN>(next + S::kTile, vb, vv.t, (kt + 1) * BN, T);
    }
    cp_async_commit();
    cp_async_wait_one();
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

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dk,
          float* __restrict__ dv, int H, int T, int causal, float scale) {
  using S = Bwd<D>;
  constexpr int L = S::kLd, BN = S::kStream;
  constexpr int kStage = 2 * S::kTile + 2 * BN;  // Q, dO, lse, Δ
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::kOwn;
  float* ring = Vs + S::kOwn;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // longest first: under the causal mask the first key tile walks the most
  // query tiles
  const int k0 = blockIdx.y * kBwdRows;
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
  load_tile_async<D, kBwdRows>(Ks, k + b * vk.b + h * vk.h, vk.t, k0, T);
  load_tile_async<D, kBwdRows>(Vs, v + b * vv.b + h * vv.h, vv.t, k0, T);
  const int tiles = (T + BN - 1) / BN;
  const int first = causal ? k0 / BN : 0;
  load_stage(first, ring);
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
    cp_async_wait_one();
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
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
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
  const size_t smem = sizeof(float) * (3 * Shape<D>::kTile + kBlock * kPLd);
  cudaError_t err = allow_smem(flash_fwd<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBlock - 1) / kBlock, B * H);
  flash_fwd<D><<<grid, kThreads, smem, s>>>(q, k, v, view(st), view(st + 3),
                                            view(st + 6), o, lse, H, T,
                                            causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const float* q, const float* k, const float* v, const float* dout,
       const long long* st, const float* lse, const float* delta, float* dqp,
       int B, int T, int H, int causal, float scale, cudaStream_t s) {
  using S = Bwd<D>;
  const size_t smem = sizeof(float) * (2 * S::kOwn + 4 * S::kTile);
  cudaError_t err = allow_smem(flash_dq<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kBwdRows - 1) / kBwdRows);
  flash_dq<D><<<grid, kBwdThreads, smem, s>>>(
      q, k, v, dout, view(st), view(st + 3), view(st + 6), view(st + 9), lse,
      delta, dqp, H, T, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const long long* st, const float* lse, const float* delta, float* dk,
        float* dv, int B, int T, int H, int causal, float scale,
        cudaStream_t s) {
  using S = Bwd<D>;
  const size_t smem =
      sizeof(float) * (2 * S::kOwn + 2 * (2 * S::kTile + 2 * S::kStream));
  cudaError_t err = allow_smem(flash_dkv<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kBwdRows - 1) / kBwdRows);
  flash_dkv<D><<<grid, kBwdThreads, smem, s>>>(
      q, k, v, dout, view(st), view(st + 3), view(st + 6), view(st + 9), lse,
      delta, dk, dv, H, T, causal, scale);
  return (int)cudaGetLastError();
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

extern "C" int kfac_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* strides,
                              const void* lse, const void* delta, void* dk_out,
                              void* dv_out, int B, int T, int H, int D,
                              int causal, float scale, void* stream) {
  const float *Q = static_cast<const float*>(q), *K = static_cast<const float*>(k),
              *V = static_cast<const float*>(v),
              *dO = static_cast<const float*>(dout),
              *L = static_cast<const float*>(lse),
              *Dl = static_cast<const float*>(delta);
  const long long* st = static_cast<const long long*>(strides);
  float *dK = static_cast<float*>(dk_out), *dV = static_cast<float*>(dv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dkv<32>(Q, K, V, dO, st, L, Dl, dK, dV, B, T, H, causal, scale, s);
    case 64: return dkv<64>(Q, K, V, dO, st, L, Dl, dK, dV, B, T, H, causal, scale, s);
    case 128: return dkv<128>(Q, K, V, dO, st, L, Dl, dK, dV, B, T, H, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
