// Conv A-factor patch covariance without im2col, for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/factor_kernels.py::
// compute_a_conv_fused (body _patch_cov_kernel, launched from
// _patch_cov_pallas). It computes, from an NCHW float32 activation x,
//
//     A = P'^T P' * scale,      scale = 1 / (OH*OW)^2 / B,
//
// where P' is the [B*OH*OW, F'] patch matrix of the conv (F = C*kh*kw
// channel-major (c, kh, kw) features, plus one constant-1 feature when the
// layer has a bias, so F' = F + 1). The bias row/column then come out as
// the 1/spatial-scaled column sums and the corner as 1/spatial, the
// oracle's values (ops/factors.py::compute_a_conv).
//
// What bounds it on this card: operations. At ResNet-32 widths (F = 144,
// 288, 576 against 131072, 32768, 8192 rows at batch 128) each conv needs
// ~F^2*rows ~ 2.7 GFLOP of float32 multiply-adds on a few MB of input, far
// right of the ridge point; this first version runs them on the CUDA cores
// (67 TFLOP/s float32 peak), not the tensor cores.
//
// Design. The Pallas kernel keeps a (kh*kw*TC)^2 accumulator of up to 4 MB
// in VMEM and sums sequentially over its batch/offset grid axes; neither
// carries over (227 KB of shared memory, blocks in no order). Here it is an
// implicit GEMM:
//   * each block owns one 64x64 output tile of A, indexed directly in
//     channel-major feature order (no offset-major permutation afterwards),
//     and only tiles on or above the diagonal are computed (A is symmetric);
//   * the block builds its patch values on the fly from x — each thread
//     decodes its feature (c, i, j) once and walks rows (b, oh, ow) with
//     incremental counters — with bounds checks in place of padding, so the
//     patch tensor never exists;
//   * products accumulate in registers (4x4 per thread) over 16-row stages
//     staged in shared memory;
//   * ResNet widths give few tiles (1..45), so the rows are split across
//     blocks too (blockIdx.y) and each split writes its own partial tile;
//     a second pass sums the partials in a fixed order, applies the scale
//     and mirrors the upper triangle. The result is deterministic; it
//     differs from the oracle only by float32 summation order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output tile side (features)
constexpr int kDepth = 16;    // patch rows per shared-memory stage
constexpr int kThreads = 256;

struct Geometry {
  int C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW;
  int F, Fp, nT;
  long long rows, rows_per_split, chw;
};

// One feature column of P': a pixel offset (kind 0), the bias ones
// (kind 1), or past the end of the matrix (kind 2, reads as zero).
struct Feat {
  int coff, di, dj, kind;
};

// One patch row (b, oh, ow), walked forward kDepth rows per stage.
struct Row {
  long long boff;
  int oh, ow;
};

__device__ __forceinline__ Feat decode_feature(const Geometry& g, int f) {
  Feat r{0, 0, 0, 2};
  if (f < g.F) {
    const int kk = g.kh * g.kw;
    const int c = f / kk;
    const int o = f - c * kk;
    const int i = o / g.kw;
    const int j = o - i * g.kw;
    r.coff = c * g.H * g.W;
    r.di = i * g.dh - g.ph;
    r.dj = j * g.dw - g.pw;
    r.kind = 0;
  } else if (f < g.Fp) {
    r.kind = 1;
  }
  return r;
}

__device__ __forceinline__ Row row_at(const Geometry& g, long long r) {
  const long long per_image = (long long)g.OH * g.OW;
  const long long b = r / per_image;
  const int rem = (int)(r - b * per_image);
  Row row;
  row.boff = b * g.chw;
  row.oh = rem / g.OW;
  row.ow = rem - row.oh * g.OW;
  return row;
}

__device__ __forceinline__ void advance(const Geometry& g, Row& row) {
  row.ow += kDepth;
  while (row.ow >= g.OW) {
    row.ow -= g.OW;
    if (++row.oh == g.OH) {
      row.oh = 0;
      row.boff += g.chw;
    }
  }
}

__device__ __forceinline__ float patch_value(const float* __restrict__ x,
                                             const Geometry& g, const Feat& f,
                                             const Row& row, bool valid) {
  if (!valid || f.kind == 2) return 0.f;
  if (f.kind == 1) return 1.f;
  const int ih = row.oh * g.sh + f.di;
  const int iw = row.ow * g.sw + f.dj;
  if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return 0.f;
  return __ldg(x + row.boff + f.coff + (long long)ih * g.W + iw);
}

__global__ void __launch_bounds__(kThreads)
patch_cov_partial(const float* __restrict__ x, float* __restrict__ part,
                  Geometry g) {
  // linear block index -> upper-triangle tile (ti <= tj)
  int t = blockIdx.x, ti = 0;
  while (t >= g.nT - ti) {
    t -= g.nT - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;

  const long long r_begin = (long long)blockIdx.y * g.rows_per_split;
  long long r_end = r_begin + g.rows_per_split;
  if (r_end > g.rows) r_end = g.rows;

  __shared__ __align__(16) float As[kDepth][kTile];
  __shared__ __align__(16) float Bs[kDepth][kTile];

  // loader role: feature column m of both tiles, rows k0, k0+4, k0+8, k0+12
  const int tid = threadIdx.x;
  const int m = tid & (kTile - 1);
  const int k0 = tid >> 6;
  const Feat fa = decode_feature(g, ti * kTile + m);
  const Feat fb = decode_feature(g, tj * kTile + m);
  Row rows[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) rows[q] = row_at(g, r_begin + k0 + 4 * q);

  // compute role: a 4x4 block of the output tile
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kDepth) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * q;
      const bool valid = r0 + k < r_end;
      As[k][m] = patch_value(x, g, fa, rows[q], valid);
      if (!diag) Bs[k][m] = patch_value(x, g, fb, rows[q], valid);
      advance(g, rows[q]);
    }
    __syncthreads();
    const float(*Bt)[kTile] = diag ? As : Bs;
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bt[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // partial tile of this row split, [nT*64, nT*64] per split
  const long long P = (long long)g.nT * kTile;
  float* out = part + (long long)blockIdx.y * P * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = (long long)ti * kTile + ty * 4 + i;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + r * P + tj * kTile + tx * 4) = v;
  }
}

// Sum the row-split partials in a fixed order, scale, and mirror the upper
// triangle into the full symmetric [Fp, Fp] output.
__global__ void patch_cov_reduce(const float* __restrict__ part,
                                 float* __restrict__ out, int Fp, int P,
                                 int splits, float scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= Fp) return;
  const int lo = i < j ? i : j;
  const int hi = i < j ? j : i;
  const long long plane = (long long)P * P;
  const float* src = part + (long long)lo * P + hi;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += src[p * plane];
  out[(long long)i * Fp + j] = s * scale;
}

}  // namespace

extern "C" int kfac_patch_cov(const void* x, void* part, void* out, int B,
                              int C, int H, int W, int kh, int kw, int sh,
                              int sw, int ph, int pw, int dh, int dw, int OH,
                              int OW, int has_bias, int splits,
                              long long rows_per_split, float scale,
                              void* stream) {
  Geometry g;
  g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw; g.sh = sh; g.sw = sw;
  g.ph = ph; g.pw = pw; g.dh = dh; g.dw = dw; g.OH = OH; g.OW = OW;
  g.F = C * kh * kw;
  g.Fp = g.F + (has_bias ? 1 : 0);
  g.nT = (g.Fp + kTile - 1) / kTile;
  g.rows = (long long)B * OH * OW;
  g.rows_per_split = rows_per_split;
  g.chw = (long long)C * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = g.nT * (g.nT + 1) / 2;
  patch_cov_partial<<<dim3(tiles, splits), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(part), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  patch_cov_reduce<<<dim3((g.Fp + 127) / 128, g.Fp), 128, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), g.Fp,
      g.nT * kTile, splits, scale);
  return (int)cudaGetLastError();
}
