// Fused eigenbasis apply for one shape group of layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/apply_kernels.py::
// fused_precondition_stack (body _fused_apply_kernel). For every layer z of
// a stacked [k, g, a] group it computes
//
//     v[z]  = QG · [(QGᵀ · G · QA) / (dG dAᵀ + λ)] · QAᵀ
//     vg[z] = Σ v[z] ⊙ G[z]          (the layer's KL-clip partial)
//
// with λ read from a device scalar, so the damping schedule never costs a
// host sync.
//
// What bounds it on this card: operations for the wide groups, bytes for
// the narrow ones. A layer costs 4·g·a·(g + a) FLOPs against
// ~4·(a² + g² + 2·g·a) bytes: ~58 FLOP per byte at ResNet-32's widest
// group (g = 64, a = 576), ~500 at the LM's (2048, 513). Every product runs
// on the tensor cores as 3xTF32 (csrc/tf32_mma.cuh: mma.sync m16n8k8 TF32
// on operands split big + small in registers, about float32 accuracy), so
// the bound is 3 × FLOPs over the 495 TFLOP/s TF32 rate (the CUDA cores'
// IEEE float32 rate is 67 TFLOP/s).
//
// Design. The Pallas body loads a layer's whole G, QA and QG at once; at
// a = 2049 QA alone is 16.8 MB, far over the 227 KB of shared memory. Here
// the chain runs as four launches of one tiled batched-GEMM kernel over
// blockIdx.z = layer:
//   1. T1 = QGᵀ · G                     A = QG read k-major (m contiguous)
//   2. T2 = (T1 · QA) / (dG dAᵀ + λ)    damped divide in the epilogue
//   3. T1 = QG · T2
//   4. v = T1 · QAᵀ, vg = Σ v ⊙ G       B = QA read k-contiguous; KL partial
//                                       reduced in the epilogue
// The two [k, g, a] intermediates live in scratch the wrapper allocates,
// with rows padded to a multiple of 4 floats; at these sizes they stay in
// L2. The block tile is a template chosen per group (plan below): 32x32
// (4 warps of 16x16) for G sides of at most 32; else 128x128 (8 warps of
// 32x64, one block per SM) where the group's blocks fill at least 90% of
// the waves they need, and 64x64 (4 warps of 32x32, two or three blocks
// per SM) where the last wave of 128x128 blocks would leave SMs idle (the
// LM's groups: at a = 513 a fifth 128-wide column holds one live column).
// The K dimension streams 32 deep through a three-stage ring of cp.async
// copies. Shared-memory rows are padded by 4 floats where k is contiguous
// and by 8 where m or n is, which makes every fragment load conflict-free.
//
// Rows that are not 16-byte aligned (a or g no multiple of 4: the LM's
// a = 513, 2049, ResNet-32's 27 and 65) are copied with 4-byte cp.async,
// chosen per operand by template; the padded intermediates always take
// 16-byte copies. Either way the copy zero-fills past the matrix edge.
//
// Accuracy. The tensor cores truncate the float32 sums they accumulate, so
// a sum over K = 2049 taken on them alone drifts with K. Each 32-deep step
// therefore starts a fresh fragment, and the step's sum is added to a
// float32 accumulator on the CUDA cores (rounded): the error then does not
// grow with K.
//
// vg is deterministic: each block of step 4 writes its tile's partial to
// scratch; the last block of a layer to finish (counted with an atomic
// after a fence) sums the partials in tile order. Two launches give
// bitwise-equal v and vg.
//
// The bf16-Q route (eigen_dtype = bfloat16). QA and QG may be stored in
// bfloat16, the element type of each Q operand a template parameter (kept
// as raw 16-bit patterns, type Bf16): Q's tiles are copied to shared
// memory as they lie, at half the bytes (16-byte cp.async copies of 8
// values where a row is 16-byte aligned, else 2-byte loads, which
// cp.async does not have; shared rows padded by 8 values), and each value
// becomes a TF32 operand by a shift: a bf16 value has 8 significand bits,
// TF32 10, so it is exact in TF32 and its 3xTF32 split has a zero small
// part. The route therefore drops the MMA on that zero part: every
// product of the chain (each has one Q operand) takes two TF32 MMAs, not
// three, at the 3xTF32 route's accuracy. The other operand (G or an
// intermediate) stays float32, split as before; v and vg are float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;

constexpr int kDepth = 32;  // K per pipeline stage
constexpr int kStages = 3;

enum Epilogue { kStore = 0, kDampedDivide = 1, kStoreAndDot = 2 };

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kWarps = (BM / WM) * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
};
using Large = Tile<128, 128, 32, 64>;
using Medium = Tile<64, 64, 32, 32>;
using Small = Tile<32, 32, 16, 16>;
constexpr int kMinTile = 32;  // the smallest BM and BN: bounds the partials

// A bfloat16 value as its 16-bit pattern (the high half of the float32
// with the same value)
using Bf16 = uint16_t;
template <class E>
constexpr bool kIsBf16 = std::is_same<E, Bf16>::value;

// One operand's tile in shared memory: R rows of it (BM of A, BN of B) by
// kDepth, stored k-contiguous ([R][kDepth + pad]) or R-contiguous
// ([kDepth][R + 8]) as it lies in global memory, in elements of type E
// (float32: pad 4; bfloat16: pad 8, which keeps each row 16-byte aligned).
template <int R, bool KCONTIG, class E>
struct Operand {
  static constexpr int kRows = KCONTIG ? R : kDepth;
  static constexpr int kCols = KCONTIG ? kDepth : R;
  static constexpr int kLd = kCols + (KCONTIG && !kIsBf16<E> ? 4 : 8);
  static constexpr int kSize = kRows * kLd;
  static constexpr int kBytes = kSize * (int)sizeof(E);
};

// ROWS x COLS elements of type E at src (row stride ld) into dst (row
// stride LD), as 16-byte cp.async copies (VEC) or, else, one element at a
// time (4-byte cp.async for float32, plain 2-byte loads for bfloat16);
// entries past rows_left or cols_left are zero-filled. src is in bounds
// and, for VEC, 16-byte aligned with ld a multiple of 16 bytes.
template <int ROWS, int COLS, int LD, int THREADS, bool VEC, class E>
__device__ __forceinline__ void load_async(E* __restrict__ dst,
                                           const E* __restrict__ src,
                                           int ld, int rows_left,
                                           int cols_left) {
  constexpr int W = 16 / (int)sizeof(E);  // elements per 16-byte copy
  constexpr int CW = COLS / W;
  static_assert((ROWS * CW) % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CW / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CW, c = W * (e % CW);
    const int n = r < rows_left ? max(0, min(W, cols_left - c)) : 0;
    const E* s = n ? src + (long long)r * ld + c : src;
    E* d = dst + r * LD + c;
    if (VEC) {
      cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(s),
                 (int)sizeof(E) * n);
    } else if constexpr (kIsBf16<E>) {
#pragma unroll
      for (int j = 0; j < W; ++j) d[j] = j < n ? s[j] : Bf16(0);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) cp_async4(d + j, j < n ? s + j : src, j < n);
    }
  }
}

// A bfloat16 value as a TF32 operand: exact (its bits shifted up), so its
// 3xTF32 split has no small part
__device__ __forceinline__ uint32_t exact_tf32(Bf16 x) { return (uint32_t)x << 16; }

// One product of the chain, batched over layers: C[z] = opA(A[z]) ·
// opB(B[z]) with opA(m, k) = TA ? A[k, m] : A[m, k], opB(k, n) = TB ?
// B[n, k] : B[k, n], all row-major with the given leading dimensions and
// per-layer strides (in elements of A's and B's types), then the epilogue.
struct Gemm {
  const void* A;
  const void* B;
  float* C;
  int M, N, K, lda, ldb, ldc;
  long long sA, sB, sC;
  const float* dG;  // kDampedDivide: [k, M], [k, N] and λ
  const float* dA;
  const float* lam;
  const float* G;   // kStoreAndDot: laid out as C; partials and counters
  float* partial;
  unsigned* done;
  float* vg;
};

// EA, EB: the element types of A and B (float, or Bf16 for a Q operand)
template <class TL, bool TA, bool TB, int EPI, bool VA, bool VB, class EA, class EB>
__device__ __forceinline__ void chain_mma_body(const Gemm& p) {
  using OA = Operand<TL::BM, !TA, EA>;
  using OB = Operand<TL::BN, TB, EB>;
  // a stage's A then B tile, counted in floats (both are whole 16 bytes)
  constexpr int kOffB = OA::kBytes / 4, kStage = kOffB + OB::kBytes / 4;
  constexpr int MT = TL::MT, NT = TL::NT, BM = TL::BM, BN = TL::BN;
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z;
  const EA* A = static_cast<const EA*>(p.A) + z * p.sA;
  const EB* B = static_cast<const EB*>(p.B) + z * p.sB;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K, lda = p.lda, ldb = p.ldb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / TL::kWarpsN) * TL::WM, wn = (warp % TL::kWarpsN) * TL::WN;

  const auto load_stage = [&](int kt, float* st) {
    const int k0 = kt * kDepth;
    constexpr int T = TL::kThreads;
    EA* sa = reinterpret_cast<EA*>(st);
    if constexpr (TA)
      load_async<kDepth, BM, OA::kLd, T, VA>(sa, A + (long long)k0 * lda + m0, lda, K - k0, M - m0);
    else
      load_async<BM, kDepth, OA::kLd, T, VA>(sa, A + (long long)m0 * lda + k0, lda, M - m0, K - k0);
    EB* sb = reinterpret_cast<EB*>(st + kOffB);
    if constexpr (TB)
      load_async<BN, kDepth, OB::kLd, T, VB>(sb, B + (long long)n0 * ldb + k0, ldb, N - n0, K - k0);
    else
      load_async<kDepth, BN, OB::kLd, T, VB>(sb, B + (long long)k0 * ldb + n0, ldb, K - k0, N - n0);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, smem + s * kStage);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next, smem + (next % kStages) * kStage);
    cp_async_commit();
    const float* st = smem + (kt % kStages) * kStage;
    const EA* As = reinterpret_cast<const EA*>(st);
    const EB* Bs = reinterpret_cast<const EB*>(st + kOffB);
    float c[MT][NT][4];  // this step's sums, on the tensor cores
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      // a bf16 operand's small part is zero: not kept, its MMA not issued
      uint32_t ab[MT][4], as[MT][kIsBf16<EA> ? 1 : 4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + 16 * i + g;
        constexpr int L = OA::kLd;
        if constexpr (kIsBf16<EA>) {
          if constexpr (TA) {
            ab[i][0] = exact_tf32(As[(kk + t) * L + r]);
            ab[i][1] = exact_tf32(As[(kk + t) * L + r + 8]);
            ab[i][2] = exact_tf32(As[(kk + t + 4) * L + r]);
            ab[i][3] = exact_tf32(As[(kk + t + 4) * L + r + 8]);
          } else {
            ab[i][0] = exact_tf32(As[r * L + kk + t]);
            ab[i][1] = exact_tf32(As[(r + 8) * L + kk + t]);
            ab[i][2] = exact_tf32(As[r * L + kk + t + 4]);
            ab[i][3] = exact_tf32(As[(r + 8) * L + kk + t + 4]);
          }
        } else if constexpr (TA) {
          split4(As[(kk + t) * L + r], As[(kk + t) * L + r + 8],
                 As[(kk + t + 4) * L + r], As[(kk + t + 4) * L + r + 8], ab[i], as[i]);
        } else {
          split4(As[r * L + kk + t], As[(r + 8) * L + kk + t],
                 As[r * L + kk + t + 4], As[(r + 8) * L + kk + t + 4], ab[i], as[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + 8 * j + g;
        constexpr int L = OB::kLd;
        uint32_t bb0, bs0 = 0, bb1, bs1 = 0;
        if constexpr (kIsBf16<EB>) {
          bb0 = exact_tf32(TB ? Bs[n * L + kk + t] : Bs[(kk + t) * L + n]);
          bb1 = exact_tf32(TB ? Bs[n * L + kk + t + 4] : Bs[(kk + t + 4) * L + n]);
        } else {
          const float b0 = TB ? Bs[n * L + kk + t] : Bs[(kk + t) * L + n];
          const float b1 = TB ? Bs[n * L + kk + t + 4] : Bs[(kk + t + 4) * L + n];
          split(b0, bb0, bs0);
          split(b1, bb1, bs1);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (!kIsBf16<EA>) mma_tf32(c[i][j], as[i], bb0, bb1);
          if constexpr (!kIsBf16<EB>) mma_tf32(c[i][j], ab[i], bs0, bs1);
          mma_tf32(c[i][j], ab[i], bb0, bb1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
  }

  float* C = p.C + z * p.sC;
  float dot = 0.f;
  const float l = EPI == kDampedDivide ? *p.lam : 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + 8 * (e >> 1);
        const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        float x = acc[i][j][e];
        if (EPI == kDampedDivide)
          x = x / (p.dG[(long long)z * M + m] * p.dA[(long long)z * N + n] + l);
        const long long at = (long long)m * p.ldc + n;
        C[at] = x;
        if (EPI == kStoreAndDot) dot = fmaf(x, p.G[z * p.sC + at], dot);
      }
  if (EPI == kStoreAndDot) {
    __shared__ float warp_sums[TL::kWarps];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) warp_sums[warp] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < TL::kWarps; ++w) s += warp_sums[w];
      const unsigned tiles = gridDim.x * gridDim.y;
      float* part = p.partial + (long long)z * tiles;
      part[blockIdx.y * gridDim.x + blockIdx.x] = s;
      __threadfence();  // the partial is visible before the count
      if (atomicAdd(p.done + z, 1u) == tiles - 1) {
        __threadfence();  // the last block sees every partial
        float sum = 0.f;
        for (unsigned i = 0; i < tiles; ++i) sum += __ldcg(part + i);
        p.vg[z] = sum;
      }
    }
  }
}

// The float32 route's kernel.
template <class TL, bool TA, bool TB, int EPI, bool VA, bool VB, class EA, class EB>
__global__ void __launch_bounds__(TL::kThreads) chain_mma(const Gemm p) {
  chain_mma_body<TL, TA, TB, EPI, VA, VB, EA, EB>(p);
}

// The bf16-Q route's kernel: the same body, one block per SM asked at least
// (without it, ptxas held the 64x64 tile's bf16 instances to 128 registers
// and spilled)
template <class TL, bool TA, bool TB, int EPI, bool VA, bool VB, class EA, class EB>
__global__ void __launch_bounds__(TL::kThreads, 1) chain_mma_bf16q(const Gemm p) {
  chain_mma_body<TL, TA, TB, EPI, VA, VB, EA, EB>(p);
}

template <class TL, bool TA, bool TB, int EPI, bool VA, bool VB, class EA, class EB>
cudaError_t run(const Gemm& p, int k, cudaStream_t s) {
  constexpr size_t smem = (size_t)kStages * (Operand<TL::BM, !TA, EA>::kBytes +
                                             Operand<TL::BN, TB, EB>::kBytes);
  void (*kernel)(const Gemm);
  if constexpr (kIsBf16<EA> || kIsBf16<EB>)
    kernel = chain_mma_bf16q<TL, TA, TB, EPI, VA, VB, EA, EB>;
  else
    kernel = chain_mma<TL, TA, TB, EPI, VA, VB, EA, EB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.N + TL::BN - 1) / TL::BN, (p.M + TL::BM - 1) / TL::BM, k);
  kernel<<<grid, TL::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// B's copy width chosen at run time, A's fixed
template <class TL, bool TA, bool TB, int EPI, bool VA, class EA, class EB>
cudaError_t run_vb(bool vb, const Gemm& p, int k, cudaStream_t s) {
  return vb ? run<TL, TA, TB, EPI, VA, true, EA, EB>(p, k, s)
            : run<TL, TA, TB, EPI, VA, false, EA, EB>(p, k, s);
}

// rows of ld elements of elem bytes at ptr take 16-byte copies
bool aligned(const void* ptr, int ld, int elem) {
  return (ld * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The tile and copy widths of one group, as kfac_fused_apply_route reports
// them: 16-byte copies for G (step 1's B), QA (steps 2 and 4's B) and QG
// (steps 1 and 3's A) where their rows are aligned (Q's rows in its own
// element type).
struct Plan {
  int tile;  // 0 Small, 1 Medium, 2 Large
  bool vgm, vqa, vqg;
};

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

Plan plan(int k, int g, int a, const void* gm, const void* qa, const void* qg, bool q_bf16) {
  Plan pl;
  const int q = q_bf16 ? 2 : 4;  // bytes per Q element
  pl.vgm = aligned(gm, a, 4);
  pl.vqa = aligned(qa, a, q);
  pl.vqg = aligned(qg, g, q);
  // one 128x128 block fills an SM: take it only where the group's blocks
  // fill at least 90% of the waves they need (wave-quantization loss);
  // its k-major element-wise copies of QG would spill registers
  const long long large = (long long)((g + 127) / 128) * ((a + 127) / 128) * k;
  const long long waves = (large + sm_count() - 1) / sm_count();
  const bool fills = 10 * large >= 9 * waves * sm_count();
  pl.tile = g <= 32 ? 0 : fills && pl.vqg ? 2 : 1;
  return pl;
}

// the four launches of one group; QG4: whether QG's rows may take
// element-wise copies (the plan gives the 128x128 tile aligned QG rows
// only); Q: QA's and QG's element type (float, or Bf16 on the bf16-Q route)
template <class TL, bool QG4, class Q>
cudaError_t chain(const Plan& pl, const Gemm& base, const float* G,
                  const Q* QA, const Q* QG, float* T1, float* T2,
                  float* V, int k, int g, int a, int ldt, cudaStream_t s) {
  using F = float;
  const long long sGA = (long long)g * a, sAA = (long long)a * a,
                  sGG = (long long)g * g, sT = (long long)g * ldt;
  Gemm p = base;
  cudaError_t err;
  // 1. T1 = QGᵀ · G                        [g, g]ᵀ x [g, a]
  p.A = QG; p.B = G; p.C = T1; p.M = g; p.N = a; p.K = g;
  p.lda = g; p.ldb = a; p.ldc = ldt; p.sA = sGG; p.sB = sGA; p.sC = sT;
  if constexpr (QG4)
    err = pl.vqg ? run_vb<TL, true, false, kStore, true, Q, F>(pl.vgm, p, k, s)
                 : run_vb<TL, true, false, kStore, false, Q, F>(pl.vgm, p, k, s);
  else
    err = run_vb<TL, true, false, kStore, true, Q, F>(pl.vgm, p, k, s);
  if (err != cudaSuccess) return err;
  // 2. T2 = (T1 · QA) / (dG dAᵀ + λ)        [g, a] x [a, a]
  p.A = T1; p.B = QA; p.C = T2; p.K = a;
  p.lda = ldt; p.ldb = a; p.ldc = ldt; p.sA = sT; p.sB = sAA; p.sC = sT;
  err = run_vb<TL, false, false, kDampedDivide, true, F, Q>(pl.vqa, p, k, s);
  if (err != cudaSuccess) return err;
  // 3. T1 = QG · T2                        [g, g] x [g, a]
  p.A = QG; p.B = T2; p.C = T1; p.K = g;
  p.lda = g; p.ldb = ldt; p.ldc = ldt; p.sA = sGG; p.sB = sT; p.sC = sT;
  if constexpr (QG4)
    err = pl.vqg ? run<TL, false, false, kStore, true, true, Q, F>(p, k, s)
                 : run<TL, false, false, kStore, false, true, Q, F>(p, k, s);
  else
    err = run<TL, false, false, kStore, true, true, Q, F>(p, k, s);
  if (err != cudaSuccess) return err;
  // 4. v = T1 · QAᵀ, vg = Σ v ⊙ G           [g, a] x [a, a]ᵀ
  p.A = T1; p.B = QA; p.C = V; p.K = a;
  p.lda = ldt; p.ldb = a; p.ldc = a; p.sA = sT; p.sB = sAA; p.sC = sGA;
  return run_vb<TL, false, true, kStoreAndDot, true, F, Q>(pl.vqa, p, k, s);
}

template <class Q>
cudaError_t chain_tile(const Plan& pl, const Gemm& base, const float* G, const void* qa,
                       const void* qg, float* T1, float* T2, float* V, int k, int g,
                       int a, int ldt, cudaStream_t s) {
  const Q *QA = static_cast<const Q*>(qa), *QG = static_cast<const Q*>(qg);
  switch (pl.tile) {
    case 2: return chain<Large, false>(pl, base, G, QA, QG, T1, T2, V, k, g, a, ldt, s);
    case 1: return chain<Medium, true>(pl, base, G, QA, QG, T1, T2, V, k, g, a, ldt, s);
    default: return chain<Small, true>(pl, base, G, QA, QG, T1, T2, V, k, g, a, ldt, s);
  }
}

}  // namespace

// scratch1: [k, g, ldt] floats, ldt = a rounded up to a multiple of 4.
// scratch2: [k, g, ldt] floats, then k·⌈g/32⌉·⌈a/32⌉ floats of KL
// partials, then k 32-bit counters (zeroed here on the stream). vg needs
// no initial value. q_bf16: qa and qg are bfloat16 (else float32).
extern "C" int kfac_fused_precondition(const void* gm, const void* qa,
                                       const void* da, const void* qg,
                                       const void* dg, const void* lam,
                                       void* scratch1, void* scratch2,
                                       void* out, void* vg, int k, int g,
                                       int a, int q_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ldt = (a + 3) / 4 * 4;
  float* T2 = static_cast<float*>(scratch2);
  float* partial = T2 + (long long)k * g * ldt;
  unsigned* done = reinterpret_cast<unsigned*>(
      partial + (long long)k * ((g + kMinTile - 1) / kMinTile) * ((a + kMinTile - 1) / kMinTile));
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned) * k, s);
  if (err != cudaSuccess) return (int)err;
  Gemm base{};
  base.dG = static_cast<const float*>(dg);
  base.dA = static_cast<const float*>(da);
  base.lam = static_cast<const float*>(lam);
  base.G = static_cast<const float*>(gm);
  base.partial = partial;
  base.done = done;
  base.vg = static_cast<float*>(vg);
  const Plan pl = plan(k, g, a, gm, qa, qg, q_bf16);
  const float* G = static_cast<const float*>(gm);
  float *T1 = static_cast<float*>(scratch1), *V = static_cast<float*>(out);
  err = q_bf16 ? chain_tile<Bf16>(pl, base, G, qa, qg, T1, T2, V, k, g, a, ldt, s)
               : chain_tile<float>(pl, base, G, qa, qg, T1, T2, V, k, g, a, ldt, s);
  return (int)err;
}

// The plan kfac_fused_precondition takes for these inputs: bits 0-1 the
// tile (0: 32x32, 1: 64x64, 2: 128x128); bit 2 set where G's rows take
// 16-byte copies, bit 3 QA's, bit 4 QG's (else element-wise copies).
extern "C" int kfac_fused_apply_route(int k, int g, int a, const void* gm,
                                      const void* qa, const void* qg, int q_bf16) {
  const Plan pl = plan(k, g, a, gm, qa, qg, q_bf16);
  return pl.tile | (pl.vgm << 2) | (pl.vqa << 3) | (pl.vqg << 4);
}
