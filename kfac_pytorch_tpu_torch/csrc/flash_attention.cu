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
// 2·B·H·T²·D FLOPs forward and 7·B·H·T²·D backward (half of each under the
// mask) against O(B·T·H·D) bytes: ~17 and ~60 GFLOP for ~34 and ~67 MB at
// B=4, H=8, T=2048, D=64 — far above the float32 ridge of 20 FLOP/byte.
// These kernels use the CUDA cores in IEEE float32 (no TF32, no tensor
// cores), so the float32 peak of 67 TFLOP/s is their ceiling.
//
// Design. The Pallas grid carries the online-softmax state (or the dQ, dK,
// dV accumulators) in VMEM scratch across its sequential innermost grid
// axis. Here that axis becomes a loop inside one block:
//   forward, dQ: one block per (b·h, 64-row query tile), looping over key
//                tiles (only those at or left of the diagonal when causal);
//   dK/dV:       one block per (b·h, 64-row key tile), looping over query
//                tiles (only those at or below the diagonal). Each block
//                owns its dK/dV rows: no atomics, deterministic.
// 256 threads form a 16x16 grid; each owns 4 rows (ty + 16r) and, of a
// 64-wide tile, 4 columns (tx + 16c), or D/16 columns of a D-wide one.
// Tiles sit row-major in shared memory with rows padded to D + 4 floats:
// the row products read float4s along D, and with that pad the 8 threads
// of a float4 phase hit 8 disjoint bank groups; the column-strided thread
// mapping makes every other read either conflict-free or a broadcast. The
// transposed products of dK/dV are computed as K·Qᵀ and V·dOᵀ directly, so
// no tile is ever transposed in shared memory. Row statistics (max, sum)
// live in registers and are reduced across the 16 threads of a row with
// warp shuffles. Every sequence length runs the kernels: the last tile's
// rows past T load as zeros and are masked.
#include <cuda_runtime.h>
#include <math.h>

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dq, int H,
         int T, int causal, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::kTile;
  float* Ks = dOs + S::kTile;
  float* Vs = Ks + S::kTile;
  float* dSs = Vs + S::kTile;  // 64 x 64, stride kPLd
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlock;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kb = k + b * vk.b + h * vk.h;
  const float* vb = v + b * vv.b + h * vv.h;
  load_tile<D>(Qs, q + b * vq.b + h * vq.h, vq.t, q0, T, scale);
  load_tile<D>(dOs, dout + b * vdo.b + h * vdo.h, vdo.t, q0, T, 1.f);
  float row_lse[kR], row_delta[kR], acc[kR][S::kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + ty + 16 * r;
    row_lse[r] = qi < T ? lse[(long long)bh * T + qi] : 0.f;
    row_delta[r] = qi < T ? delta[(long long)bh * T + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < S::kC; ++c) acc[r][c] = 0.f;
  }
  const int tiles = (T + kBlock - 1) / kBlock;
  const int nk = causal ? min(tiles, (int)blockIdx.x + 1) : tiles;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    load_tile<D>(Ks, kb, vk.t, k0, T, 1.f);
    load_tile<D>(Vs, vb, vv.t, k0, T, 1.f);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    rows_dot_rows<D>(Qs, Ks, s);
    rows_dot_rows<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        const float p = live(qi, k0 + tx + 16 * c, T, causal)
                            ? expf(s[r][c] - row_lse[r]) : 0.f;
        dSs[(ty + 16 * r) * kPLd + tx + 16 * c] = p * (dp[r][c] - row_delta[r]);
      }
    }
    __syncthreads();
    scores_times_rows<D>(dSs, Ks, acc);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= T) continue;
    float* row = dq + (((long long)b * T + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < S::kC; ++c) row[tx + 16 * c] = acc[r][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          View vq, View vk, View vv, View vdo, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dk,
          float* __restrict__ dv, int H, int T, int causal, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::kTile;
  float* Qs = Vs + S::kTile;
  float* dOs = Qs + S::kTile;
  float* Pt = dOs + S::kTile;  // pᵀ, 64 key rows x 64 query columns
  float* dSt = Pt + kBlock * kPLd;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBlock;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + b * vq.b + h * vq.h;
  const float* db = dout + b * vdo.b + h * vdo.h;
  load_tile<D>(Ks, k + b * vk.b + h * vk.h, vk.t, k0, T, 1.f);
  load_tile<D>(Vs, v + b * vv.b + h * vv.h, vv.t, k0, T, 1.f);
  float dk_acc[kR][S::kC], dv_acc[kR][S::kC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < S::kC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const int tiles = (T + kBlock - 1) / kBlock;
  for (int qt = causal ? (int)blockIdx.x : 0; qt < tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();
    load_tile<D>(Qs, qb, vq.t, q0, T, scale);
    load_tile<D>(dOs, db, vdo.t, q0, T, 1.f);
    __syncthreads();
    float st[kR][kR], dpt[kR][kR];
    rows_dot_rows<D>(Ks, Qs, st);   // sᵀ: key rows x query columns
    rows_dot_rows<D>(Vs, dOs, dpt);
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const int qi = q0 + tx + 16 * c;
      const float col_lse = qi < T ? lse[(long long)bh * T + qi] : 0.f;
      const float col_delta = qi < T ? delta[(long long)bh * T + qi] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float p = live(qi, k0 + ty + 16 * r, T, causal)
                            ? expf(st[r][c] - col_lse) : 0.f;
        Pt[(ty + 16 * r) * kPLd + tx + 16 * c] = p;
        dSt[(ty + 16 * r) * kPLd + tx + 16 * c] = p * (dpt[r][c] - col_delta);
      }
    }
    __syncthreads();
    scores_times_rows<D>(Pt, dOs, dv_acc);
    scores_times_rows<D>(dSt, Qs, dk_acc);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= T) continue;
    const long long off = (((long long)b * T + kj) * H + h) * D;
#pragma unroll
    for (int c = 0; c < S::kC; ++c) {
      dk[off + tx + 16 * c] = dk_acc[r][c];
      dv[off + tx + 16 * c] = dv_acc[r][c];
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
  const size_t smem = sizeof(float) * (4 * Shape<D>::kTile + kBlock * kPLd);
  cudaError_t err = allow_smem(flash_dq<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBlock - 1) / kBlock, B * H);
  flash_dq<D><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, view(st), view(st + 3), view(st + 6), view(st + 9), lse,
      delta, dqp, H, T, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const long long* st, const float* lse, const float* delta, float* dk,
        float* dv, int B, int T, int H, int causal, float scale,
        cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (4 * Shape<D>::kTile + 2 * kBlock * kPLd);
  cudaError_t err = allow_smem(flash_dkv<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBlock - 1) / kBlock, B * H);
  flash_dkv<D><<<grid, kThreads, smem, s>>>(
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
