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
// group (g = 64, a = 576), ~14 at (16, 144), against a float32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B. The wide groups dominate the step.
//
// Design. The Pallas body loads a layer's whole G, QA and QG at once; at
// a = 576 QA alone is 1.3 MB, far over the 227 KB of shared memory. Here
// the chain runs as four launches of one tiled batched-GEMM kernel over
// blockIdx.z = layer (64x64 output tiles, 16-deep shared-memory stages, a
// 4x4 register block per thread):
//   1. T = QGᵀ · G
//   2. T = (T · QA) / (dG dAᵀ + λ)     damped divide in the epilogue
//   3. T = QG · T
//   4. v = T · QAᵀ, vg += Σ v ⊙ G      KL partial reduced in the epilogue
// The two [k, g, a] intermediates live in scratch the wrapper allocates;
// at these sizes they stay in L2. Each block adds its tile's share of vg
// with one float atomic, so vg's last bits vary from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kPad = 4;  // shared-memory row padding (bank conflicts)
constexpr int kThreads = 256;

enum Epilogue { kStore = 0, kDampedDivide = 1, kStoreAndDot = 2 };

// C[z] = opA(A[z]) · opB(B[z]); opA(m, k) = TA ? A[k, m] : A[m, k],
// opB(k, n) = TB ? B[n, k] : B[k, n]; all row-major with the given leading
// dimensions and per-layer strides.
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads)
chain_gemm(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ Cm, int M, int N, int K, long long sA,
           long long sB, long long sC, int lda, int ldb, int ldc,
           const float* __restrict__ dG, const float* __restrict__ dA,
           const float* __restrict__ lam, const float* __restrict__ G,
           float* __restrict__ vg) {
  const int z = blockIdx.z;
  A += z * sA;
  B += z * sB;
  Cm += z * sC;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  __shared__ __align__(16) float As[kDepth][kTile + kPad];
  __shared__ __align__(16) float Bs[kDepth][kTile + kPad];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * kThreads;
      // A tile: coalesced along whichever index is contiguous in memory
      int m, k;
      if (TA) { k = e >> 6; m = e & 63; } else { m = e >> 4; k = e & 15; }
      float va = 0.f;
      if (m0 + m < M && k0 + k < K)
        va = TA ? A[(long long)(k0 + k) * lda + m0 + m]
                : A[(long long)(m0 + m) * lda + k0 + k];
      As[k][m] = va;
      int n;
      if (TB) { n = e >> 4; k = e & 15; } else { k = e >> 6; n = e & 63; }
      float vb = 0.f;
      if (n0 + n < N && k0 + k < K)
        vb = TB ? B[(long long)(n0 + n) * ldb + k0 + k]
                : B[(long long)(k0 + k) * ldb + n0 + n];
      Bs[k][n] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float dot = 0.f;
  const float l = (EPI == kDampedDivide) ? *lam : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float c = acc[i][j];
      if (EPI == kDampedDivide)
        c = c / (dG[(long long)z * M + m] * dA[(long long)z * N + n] + l);
      Cm[(long long)m * ldc + n] = c;
      if (EPI == kStoreAndDot)
        dot = fmaf(c, G[(long long)z * M * N + (long long)m * N + n], dot);
    }
  }
  if (EPI == kStoreAndDot) {
    __shared__ float warp_sums[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
      atomicAdd(vg + z, s);
    }
  }
}

}  // namespace

extern "C" int kfac_fused_precondition(const void* gm, const void* qa,
                                       const void* da, const void* qg,
                                       const void* dg, const void* lam,
                                       void* scratch1, void* scratch2,
                                       void* out, void* vg, int k, int g,
                                       int a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* G = static_cast<const float*>(gm);
  const float* QA = static_cast<const float*>(qa);
  const float* QG = static_cast<const float*>(qg);
  const float* DA = static_cast<const float*>(da);
  const float* DG = static_cast<const float*>(dg);
  const float* L = static_cast<const float*>(lam);
  float* T1 = static_cast<float*>(scratch1);
  float* T2 = static_cast<float*>(scratch2);
  float* V = static_cast<float*>(out);
  float* VG = static_cast<float*>(vg);
  const long long sGA = (long long)g * a, sAA = (long long)a * a,
                  sGG = (long long)g * g;
  const dim3 grid((a + kTile - 1) / kTile, (g + kTile - 1) / kTile, k);
  // 1. T1 = QGᵀ · G                        [g, g] x [g, a]
  chain_gemm<true, false, kStore><<<grid, kThreads, 0, s>>>(
      QG, G, T1, g, a, g, sGG, sGA, sGA, g, a, a, nullptr, nullptr, nullptr,
      nullptr, nullptr);
  // 2. T2 = (T1 · QA) / (dG dAᵀ + λ)        [g, a] x [a, a]
  chain_gemm<false, false, kDampedDivide><<<grid, kThreads, 0, s>>>(
      T1, QA, T2, g, a, a, sGA, sAA, sGA, a, a, a, DG, DA, L, nullptr,
      nullptr);
  // 3. T1 = QG · T2                        [g, g] x [g, a]
  chain_gemm<false, false, kStore><<<grid, kThreads, 0, s>>>(
      QG, T2, T1, g, a, g, sGG, sGA, sGA, g, a, a, nullptr, nullptr, nullptr,
      nullptr, nullptr);
  // 4. v = T1 · QAᵀ, vg += Σ v ⊙ G          [g, a] x [a, a]ᵀ
  chain_gemm<false, true, kStoreAndDot><<<grid, kThreads, 0, s>>>(
      T1, QA, V, g, a, a, sGA, sAA, sGA, a, a, a, nullptr, nullptr, nullptr,
      G, VG);
  return (int)cudaGetLastError();
}
