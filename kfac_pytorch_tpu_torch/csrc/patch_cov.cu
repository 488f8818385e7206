// Conv A-factor patch covariance without im2col, for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/factor_kernels.py::
// compute_a_conv_fused (body _patch_cov_kernel, launched from
// _patch_cov_pallas), and its grouped entry compute_a_conv_grouped_fused,
// which calls it once per channel group. It computes, from an NCHW float32
// activation x, for every group g of a conv with G groups (G = 1 for an
// ordinary conv),
//
//     A[g] = P'_g^T P'_g * scale,      scale = 1 / (OH*OW)^2 / B,
//
// where P'_g is the [B*OH*OW, F'] patch matrix of group g's C/G input
// channels (F = (C/G)*kh*kw channel-major (c, kh, kw) features, plus one
// constant-1 feature when the layer has a bias, so F' = F + 1). The bias
// row/column then come out as the 1/spatial-scaled column sums and the
// corner as 1/spatial, the oracle's values (ops/factors.py::compute_a_conv
// and compute_a_conv_grouped). Cross-group blocks are never computed.
//
// What bounds it on this card: operations. The GEMM is M = N = F' and
// K = B*OH*OW patch rows: at ResNet-32 widths (F = 144, 288, 576 against
// 131072, 32768, 8192 rows at batch 128) ~F^2*rows ~ 2.7 GFLOP per conv on
// a few MB of input, far right of the ridge point. Every product runs on
// the tensor cores as 3xTF32 (csrc/tf32_mma.cuh: mma.sync m16n8k8 TF32 on
// operands split big + small in registers, about float32 accuracy), so the
// bound is 3 x FLOPs over the 495 TFLOP/s TF32 rate.
//
// Design. The Pallas kernel keeps a (kh*kw*TC)^2 accumulator of up to 4 MB
// in VMEM and sums sequentially over its batch/offset grid axes; neither
// carries over (227 KB of shared memory, blocks in no order). Here it is an
// implicit GEMM over a triangle of output tiles:
//   * each block owns one output tile of A (ti <= tj: A is symmetric) of
//     one group, for one split of the patch rows. The tile is chosen per
//     geometry (plan below, from measurements on the card): 128 x 128 (8
//     warps of 64 x 32) for wide 1x1 convs; 48 x 48, one warp's worth of
//     mma tiles whose 4 warps split the K steps, for narrow groups (F' <=
//     48, whole) and where 48 divides F' far better than 64 (F' = 144,
//     288); else 64 x 64 (4 warps of 32 x 32). The inner loop runs every
//     mma tile of a warp without branches (sums past F' or under the
//     diagonal are computed and never stored), except that a diagonal
//     48 x 48 block skips the mma tiles under its diagonal, known at
//     compile time there (12 of its 18 mma tiles run);
//   * the K dimension streams as stages of R whole output rows of one
//     image (R*OW positions, R a divisor of OH; up to 256, 128 or 64
//     positions by tile), or, where one row's window does not fit in
//     shared memory, of one output row in column tiles (multiples of 8
//     columns, the last one ragged), or else the same with a narrower tile
//     (plan below): any image width fits. Per stage the block copies the
//     INPUT window those rows need -- for the channels its tiles' features
//     cover, (R-1)*sh + (kh-1)*dh + 1 input rows (one output row: only the
//     kh rows its taps read), each from the column of the left padding
//     rounded down to the copy width -- into shared memory with cp.async,
//     in a two-stage ring. The copies are 16, 8 or 4 bytes
//     (the widest that divides the image rows), zero-filled outside the
//     image; for a 1x1 stride-1 conv each channel's R*W values are
//     contiguous and copied as one row, and where a stage is a whole
//     image the tile's channels are one slab (Mode below). Each input
//     value crosses to the SM once per block, not once per filter tap.
//     Copy instructions, not the tensor cores, were the larger cost of a
//     first version with 4-byte copies (ablations on the card: dropping
//     the copies saved far more time than dropping the mma instructions);
//   * fragments are read from that window at feature offset + position
//     offset: a feature's (c, i*dh, j*dw) offset is decoded once per
//     thread, the stage's position offsets once per block into a table;
//     the bias feature reads a plane of ones, positions past the stage's
//     last one read as zero through the B operand;
//   * accuracy: each stage's tensor-core sums go into a fresh fragment,
//     added on the CUDA cores to a float32 accumulator, so the rounding of
//     the tensor cores' own accumulation does not grow with K (131072 rows
//     at ResNet-32's first stage, 401408 at ResNeXt's stem);
//   * the rows are split across blocks too (blockIdx.y) and each split
//     writes its own partial tile; a second pass sums the partials in a
//     fixed order, applies the scale and mirrors the upper triangle. Two
//     launches are bitwise equal;
//   * a grouped conv adds a group axis to the grid (blockIdx.z = g): the
//     block offsets its channels to group g's and writes its partial into
//     a [splits, G, P, P] buffer; the reduce pass scales and mirrors each
//     group's [F', F'] into out[g]. One launch covers all G groups, where
//     the TPU version runs G kernel calls.
//
// The bf16 route (bfloat16 activations, under --bf16 compute). The JAX
// package upcasts bf16 activations to float32 before its kernel; the
// product of two bf16 values (8 significand bits each) is exact in float32
// and the tensor cores accumulate it in float32, so one
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per product computes what
// that float32 product computes, up to summation order, at a third of the
// 3xTF32 route's MMAs. The route stages the input windows in bf16 (half
// the bytes: 16-byte copies of 8 values where the rows allow, 2-byte loads
// where an odd row length or address allows no cp.async), reads each
// fragment register as two 16-bit values of the window (feature offset +
// position offset, as the float32 route reads them; the positions of a
// 16-deep step are not contiguous in general, so ldmatrix does not apply),
// and takes the K dimension 16 positions at a time: a stage's positions
// are padded to a multiple of 16, the padding read as zero through B. The
// tile plans are the float32 route's, with the shared memory of a stage
// counted in 2-byte elements.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using namespace tf32x3;

constexpr int kStages = 2;
// output positions per stage aimed at, by tile (KSplit, Medium, Wide)
constexpr int kStagePositions[3] = {256, 128, 64};
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use

template <int BT_, int WM_, int WN_, int KSPLIT_, int MINB_>
struct Tile {
  static constexpr int BT = BT_, WM = WM_, WN = WN_, KSPLIT = KSPLIT_;
  static constexpr int kMinBlocks = MINB_;  // blocks an SM holds (registers)
  static constexpr int kWarpsN = BT / WN;
  static constexpr int kWarpsTile = (BT / WM) * kWarpsN;
  static constexpr int kWarps = kWarpsTile * KSPLIT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
};
using Wide = Tile<128, 64, 32, 1, 1>;
using Medium = Tile<64, 32, 32, 1, 3>;
using KSplit = Tile<48, 48, 48, 4, 2>;

struct Geometry {
  int C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW;  // C: one group's channels
  int F, Fp, groups;
  int esize;         // bytes per element of x (4: float32, 2: bfloat16)
  int R, SW, nC;     // output rows per stage, columns per stage row, stages per row
  int L, Lp;         // positions per stage (R * SW), padded to the MMA depth (8 or 16)
  int HR, Wp;        // window rows and columns per channel (flat: 1, L)
  int rstep, fr;     // input rows per window row; window rows per filter tap
  int col0;          // input column of the window's first column (a multiple of V)
  int plane;         // elements per channel plane in shared memory
  int ct;            // channel planes per sub-window
  int ones, sub;     // the ones plane's offset in a sub-window; its elements
  int nT;            // tiles per side
  int units, units_per_split;  // stages in all (B * OH / R), per split
  long long chw;     // one image, all groups
  long long total;   // elements in x
};

// A bfloat16 value as its 16-bit pattern (the high half of the float32
// with the same value)
using Bf16 = uint16_t;
template <class T>
constexpr bool kIsBf16 = std::is_same<T, Bf16>::value;
// MMA depth: positions per K step
template <class T>
constexpr int kDepthOf = kIsBf16<T> ? 16 : 8;

// How a stage's input is laid out in shared memory: a window of input rows
// per channel (any conv); each channel's R*W contiguous values (a 1x1
// stride-1 conv without padding); or, where such a stage is a whole image,
// the tile's channels as one contiguous slab, copied 16 bytes at a time
// from the 16-byte boundary below it (its offset folded into the feature
// offsets), which serves images of an odd number of pixels (7 x 7).
enum Mode { kRows = 0, kFlat = 1, kSlab = 2 };

// V elements of type T (V * sizeof(T) = 16, 8 or 4 bytes: cp.async; a
// single bf16: a plain 2-byte load) from global to shared memory, zero
// where !ok
template <int V, class T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok) {
  constexpr int bytes = V * (int)sizeof(T);
  float* d = reinterpret_cast<float*>(dst);
  const float* s = reinterpret_cast<const float*>(src);
  if constexpr (bytes == 16) cp_async16(d, s, ok ? 16 : 0);
  else if constexpr (bytes == 8) cp_async8(d, s, ok ? 8 : 0);
  else if constexpr (bytes == 4) cp_async4(d, s, ok);
  else *dst = ok ? *src : T(0);
}

// c += a·b on one m16n8k16 bf16 tile (float32 accumulate). Fragments (g =
// lane / 4, t = lane % 4; two 16-bit values a register, the lower index in
// the low half): A 16x16 a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
// a3 (g+8, 2t+8..); B 16x8 b0 (k = 2t..2t+1, n = g) b1 (k = 2t+8..);
// C as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values in one register, lo in the low half
__device__ __forceinline__ uint32_t pack2(Bf16 lo, Bf16 hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// MODE: the stage's layout (Mode); V: elements per copy; T: the element
// type of x and of the staged window (float, or Bf16 on the bf16 route).
template <class TL, int MODE, int V, class T>
__global__ void __launch_bounds__(TL::kThreads, TL::kMinBlocks)
patch_cov_mma(const T* __restrict__ x, float* __restrict__ part, const Geometry g) {
  constexpr int BT = TL::BT, MT = TL::MT, NT = TL::NT;
  constexpr int W16 = 16 / (int)sizeof(T);  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // linear block index -> upper-triangle tile (ti <= tj)
  int t = blockIdx.x, ti = 0;
  while (t >= g.nT - ti) {
    t -= g.nT - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int grp = blockIdx.z;
  const int f0a = ti * BT, f0b = tj * BT;

  constexpr bool FLAT = MODE != kRows;
  const int sub = g.sub;  // one tile's window: channels, then ones
  const int stage_elems = 2 * sub;
  int* poff = reinterpret_cast<int*>(smem + kStages * stage_elems);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wt = warp % TL::kWarpsTile, ks = warp / TL::kWarpsTile;
  const int wm = (wt / TL::kWarpsN) * TL::WM, wn = (wt % TL::kWarpsN) * TL::WN;
  const int kk = g.kh * g.kw;

  // a feature's offset in its tile's window
  const auto feature_offset = [&](int f, int f0) -> int {
    if (f >= g.Fp) return 0;              // past the matrix: discarded
    if (f >= g.F) return g.ones;          // the bias: the ones plane
    const int c = f / kk, o = f - c * kk, i = o / g.kw, j = o - i * g.kw;
    const int off = (c - f0 / kk) * g.plane;
    if (MODE == kSlab) return off + (int)(((long long)(grp * g.C + f0) * g.plane) & (W16 - 1));
    return FLAT ? off : off + i * g.fr * g.Wp + j * g.dw - g.pw - g.col0;
  };
  int offa[MT][2], offb[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) offa[i][h] = feature_offset(f0a + wm + 16 * i + 8 * h + gq, f0a);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    offb[j] = feature_offset(f0b + wn + 8 * j + gq, f0b) + (diag ? 0 : sub);
  // whether mma tile (i, j) of this warp holds an entry of the upper triangle
  const auto live = [&](int i, int j) {
    const int m = f0a + wm + 16 * i, n = f0b + wn + 8 * j;
    return m < g.Fp && n < g.Fp && n + 7 >= m;
  };

  // the stage's position offsets, and the ones planes (never copied over)
  for (int p = threadIdx.x; p < g.Lp; p += TL::kThreads) {
    const int r = p / g.SW, ow = p - r * g.SW;
    poff[p] = p >= g.L ? 0 : FLAT ? p : r * g.sh * g.Wp + ow * g.sw;
  }
  const T one = kIsBf16<T> ? T(0x3f80) : T(1);
  for (int e = threadIdx.x; e < kStages * 2 * g.plane; e += TL::kThreads) {
    const int w = e / g.plane;  // stage * 2 + sub-window
    smem[w * sub + g.ones + (e - w * g.plane)] = one;
  }

  const int upi = g.OH / g.R * g.nC;  // stages per image
  const long long u_begin = (long long)blockIdx.y * g.units_per_split;
  const int nst = (int)min((long long)g.units_per_split, (long long)g.units - u_begin);

  const int chunks = g.Wp / V;
  const float inv_chunks = 1.f / chunks, inv_hr = 1.f / g.HR;
  const auto load_stage = [&](long long u, T* st) {
    const long long b = u / upi;
    const int in_image = (int)(u - b * upi);
    const int oh0 = in_image / g.nC * g.R, ow0 = in_image % g.nC * g.SW;
    for (int s = 0; s < (diag ? 1 : 2); ++s) {
      const int f0 = s ? f0b : f0a;
      if (f0 >= g.F) continue;  // the bias alone: no channel
      const int cb = f0 / kk;
      const int cn = (min(f0 + BT, g.F) - 1) / kk + 1 - cb;
      const T* src = x + b * g.chw + (long long)(grp * g.C + cb) * g.H * g.W;
      T* dst = st + s * sub;
      if (MODE == kSlab) {
        // channels cb .. cb+cn-1 of image b: one contiguous run, from the
        // 16-byte boundary at or below it (chw a multiple of 16 bytes: the
        // same offset for every image); chunks past the end of x read as
        // zero
        const long long first = src - x;
        const long long from = first & ~(long long)(W16 - 1);
        const int n16 = (int)((first - from + (long long)cn * g.plane + W16 - 1) / W16);
        for (int k = threadIdx.x; k < n16; k += TL::kThreads)
          copy_chunk<W16>(dst + W16 * k, x + from + W16 * k, from + W16 * k < g.total);
        continue;
      }
      // V-float chunks of each window row (c, hr): input row
      // oh0*sh - ph + hr*rstep from column ow0*sw + col0, zero outside the
      // image (flat: channel c's R*W values from row oh0)
      const int rows = cn * g.HR;
      for (int e = threadIdx.x; e < rows * chunks; e += TL::kThreads) {
        // e / chunks and r / HR through float reciprocals: exact at these
        // counts (below 2^20), and a few instructions where an integer
        // division takes some twenty
        const int r = __float2int_rz((e + 0.5f) * inv_chunks), q = e - r * chunks;
        const int c = FLAT ? r : __float2int_rz((r + 0.5f) * inv_hr), hr = r - c * g.HR;
        const T* chan = src + (long long)c * g.H * g.W;
        T* d = dst + c * g.plane + hr * g.Wp + q * V;
        if (FLAT) {
          copy_chunk<V>(d, chan + (long long)oh0 * g.W + q * V, true);
        } else {
          const int ih = oh0 * g.sh - g.ph + hr * g.rstep, iw = ow0 * g.sw + g.col0 + q * V;
          const bool ok = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
          copy_chunk<V>(d, ok ? chan + (long long)ih * g.W + iw : x, ok);
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(u_begin + s, smem + s * stage_elems);
    cp_async_commit();
  }
  const int ksteps = g.Lp / kDepthOf<T>;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st has landed; every warp is done with st - 1
    const int next = st + kStages - 1;
    if (next < nst) load_stage(u_begin + next, smem + (next % kStages) * stage_elems);
    cp_async_commit();
    const T* win = smem + (st % kStages) * stage_elems;
    // the stage's valid positions: fewer in a row's last column tile
    int valid = g.L;
    if (g.nC > 1) {
      const int col = (int)((u_begin + st) % upi) % g.nC;
      if (col == g.nC - 1) valid = g.OW - col * g.SW;
    }
    float c[MT][NT][4];  // this stage's sums, on the tensor cores
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
    // the stage's K steps; UNDER: skip the mma tiles under the diagonal,
    // known at compile time where a diagonal block's warps each hold the
    // whole tile (the 48 x 48 tile); every other mma tile of the warp runs,
    // also those past F' or under the diagonal of a wider tile (their sums
    // are never stored): no branch in this loop
    const auto steps = [&](auto under) {
      constexpr bool UNDER = decltype(under)::value;
      if constexpr (kIsBf16<T>) {
        // 16 positions a step: this thread's 2t, 2t+1, 2t+8, 2t+9
        for (int k16 = ks; k16 < ksteps; k16 += TL::KSPLIT) {
          const int p0 = 16 * k16 + 2 * tq;
          const int q[4] = {poff[p0], poff[p0 + 1], poff[p0 + 8], poff[p0 + 9]};
          const bool v[4] = {p0 < valid, p0 + 1 < valid, p0 + 8 < valid, p0 + 9 < valid};
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const T* r0 = win + offa[i][0];
            const T* r1 = win + offa[i][1];
            a[i][0] = pack2(r0[q[0]], r0[q[1]]);
            a[i][1] = pack2(r1[q[0]], r1[q[1]]);
            a[i][2] = pack2(r0[q[2]], r0[q[3]]);
            a[i][3] = pack2(r1[q[2]], r1[q[3]]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            // positions past the stage's last read as zero here, on B
            const T* col = win + offb[j];
            const uint32_t b0 = pack2(v[0] ? col[q[0]] : T(0), v[1] ? col[q[1]] : T(0));
            const uint32_t b1 = pack2(v[2] ? col[q[2]] : T(0), v[3] ? col[q[3]] : T(0));
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (UNDER && 8 * j + 7 < 16 * i) continue;
              mma_bf16(c[i][j], a[i], b0, b1);
            }
          }
        }
      } else {
        for (int k8 = ks; k8 < ksteps; k8 += TL::KSPLIT) {
          const int p0 = 8 * k8 + tq, p1 = p0 + 4;
          const int q0 = poff[p0], q1 = poff[p1];
          const bool v0 = p0 < valid, v1 = p1 < valid;
          uint32_t ab[MT][4], as[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            split4(win[offa[i][0] + q0], win[offa[i][1] + q0], win[offa[i][0] + q1],
                   win[offa[i][1] + q1], ab[i], as[i]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            // positions past the stage's last read as zero here, on B
            const float b0 = v0 ? win[offb[j] + q0] : 0.f;
            const float b1 = v1 ? win[offb[j] + q1] : 0.f;
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (UNDER && 8 * j + 7 < 16 * i) continue;
              mma_tf32(c[i][j], as[i], bb0, bb1);
              mma_tf32(c[i][j], ab[i], bs0, bs1);
              mma_tf32(c[i][j], ab[i], bb0, bb1);
            }
          }
        }
      }
    };
    if constexpr (TL::kWarpsTile == 1) {
      if (diag)
        steps(std::true_type{});
      else
        steps(std::false_type{});
    } else {
      steps(std::false_type{});
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
  }

  // this split's partial tile, [P, P] per (split, group), P = nT * BT;
  // entries under the diagonal or past F' are left unwritten (never read)
  const long long P = (long long)g.nT * BT;
  float* out = part + ((long long)blockIdx.y * g.groups + grp) * P * P;
  if (TL::KSPLIT == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!live(i, j)) continue;
        const long long m = f0a + wm + 16 * i + gq, n = f0b + wn + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(out + m * P + n) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(out + (m + 8) * P + n) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
  } else {
    // the K-split warps' sums, added in warp order through shared memory
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);  // [KSPLIT][BT][BT]
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!live(i, j)) continue;
        const int m = wm + 16 * i + gq, n = wn + 8 * j + 2 * tq;
        float* r = red + ks * BT * BT;
        r[m * BT + n] = acc[i][j][0];
        r[m * BT + n + 1] = acc[i][j][1];
        r[(m + 8) * BT + n] = acc[i][j][2];
        r[(m + 8) * BT + n + 1] = acc[i][j][3];
      }
    __syncthreads();
    for (int e = threadIdx.x; e < BT * BT; e += TL::kThreads) {
      const int m = f0a + e / BT, n = f0b + e % BT;
      if (m >= g.Fp || n >= g.Fp || n < m) continue;
      float s = red[e];
#pragma unroll
      for (int k = 1; k < TL::KSPLIT; ++k) s += red[k * BT * BT + e];
      out[m * P + n] = s;
    }
  }
}

// Sum the row-split partials of group blockIdx.z in a fixed order, scale,
// and mirror the upper triangle into that group's symmetric [Fp, Fp] output.
__global__ void patch_cov_reduce(const float* __restrict__ part,
                                 float* __restrict__ out, int Fp, int P,
                                 int splits, int groups, float scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int grp = blockIdx.z;
  if (j >= Fp) return;
  const int lo = i < j ? i : j;
  const int hi = i < j ? j : i;
  const long long plane = (long long)P * P;
  const long long split_stride = plane * groups;
  const float* src = part + grp * plane + (long long)lo * P + hi;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += src[p * split_stride];
  out[((long long)grp * Fp + i) * Fp + j] = s * scale;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// The tile, copy route, stage and splits of one geometry, as
// kfac_patch_cov_plan reports them.
struct Plan {
  int tile;  // 0 KSplit (48), 1 Medium (64), 2 Wide (128)
  int mode;  // Mode
  int vec;   // elements per copy: 1, 2 or 4 floats, or 1, 2, 4 or 8 bf16 values
  int splits;
  size_t smem;
};

int tile_side(int tile) { return tile == 2 ? Wide::BT : tile == 1 ? Medium::BT : KSplit::BT; }

// The copy route of a stage of g.R output rows of g.SW columns: the widest
// copy (16 bytes down to one element) whose chunks start aligned (a window
// row's chunks at multiples of V from an image row's start, W % V == 0,
// column tiles being multiples of 8 columns; a flat stage's at multiples of
// V from a channel's start, H*W and R*W % V == 0), and the layout.
void choose_copy(const Geometry& g, Plan& pl, uintptr_t addr) {
  const bool flat = g.kh == 1 && g.kw == 1 && g.sh == 1 && g.sw == 1 && g.ph == 0 &&
                    g.pw == 0 && g.SW == g.OW;
  const int n = flat ? g.H * g.W : g.W, w16 = 16 / g.esize;
  pl.vec = w16;
  while (pl.vec > 1 && (n % pl.vec || addr % (pl.vec * g.esize))) pl.vec /= 2;
  pl.mode = flat ? kFlat : kRows;
  while (flat && g.R * g.SW % pl.vec) pl.vec /= 2;
  if (flat && pl.vec < w16 && g.R == g.OH && g.chw * g.esize % 16 == 0 && addr % 16 == 0) {
    pl.mode = kSlab;
    pl.vec = w16;
  }
}

// Fill g's stage fields for pl's tile and copy route and a stage of g.R
// output rows of g.SW columns; pl.smem: the shared memory a block takes.
void fill(Geometry& g, Plan& pl, int B) {
  const int bt = tile_side(pl.tile), kk = g.kh * g.kw;
  g.nT = (g.Fp + bt - 1) / bt;
  g.ct = min(g.C, (bt - 2) / kk + 2);  // channels bt consecutive features span
  g.nC = (g.OW + g.SW - 1) / g.SW;
  g.L = g.R * g.SW;
  const int depth = g.esize == 2 ? 16 : 8;  // the MMA's K
  g.Lp = (g.L + depth - 1) / depth * depth;
  // one output row's window holds only the kh input rows its taps read
  g.rstep = g.R == 1 ? g.dh : 1;
  g.fr = g.R == 1 ? 1 : g.dh;
  if (pl.mode != kRows) {
    g.HR = 1;
    g.Wp = g.L;
    g.col0 = 0;
  } else {
    // columns -pw .. (SW-1)*sw + (kw-1)*dw - pw of the stage's first, from
    // col0 down to a multiple of V, in whole chunks
    g.HR = g.R == 1 ? g.kh : (g.R - 1) * g.sh + (g.kh - 1) * g.dh + 1;
    g.col0 = -((g.pw + pl.vec - 1) / pl.vec) * pl.vec;
    const int last = (g.SW - 1) * g.sw + (g.kw - 1) * g.dw - g.pw;
    g.Wp = (last - g.col0 + pl.vec) / pl.vec * pl.vec;
  }
  // rows padded to 16 mod 128 bytes (4 mod 32 floats, 8 mod 64 bf16
  // values): 16-byte aligned, and a warp's 8 channels x 4 positions of a
  // 1x1 conv fall in 32 distinct banks; a slab's channels lie unpadded, as
  // in x
  const int w16 = 16 / g.esize;  // elements per 16 bytes
  g.plane = pl.mode == kSlab ? g.H * g.W : (g.HR * g.Wp + 8 * w16 - 1) / (8 * w16) * (8 * w16) + w16;
  // the ones plane past the channels (a slab's copies end less than 16
  // bytes past ct planes)
  g.ones = g.ct * g.plane + (pl.mode == kSlab ? 2 * w16 : 0);
  g.sub = (g.ones + g.plane + w16 - 1) / w16 * w16;
  const size_t ring = (size_t)g.esize * kStages * 2 * g.sub + sizeof(int) * g.Lp;
  const size_t red = pl.tile == 0 ? sizeof(float) * KSplit::KSPLIT * KSplit::BT * KSplit::BT : 0;
  pl.smem = ring > red ? ring : red;
  g.total = (long long)B * g.chw;
  g.units = B * (g.OH / g.R) * g.nC;
}

// The row splits of g's stages: the fewest waves x stages per block over
// the card's block slots, with at least 4 stages per split and at most 16M
// floats of partials.
void choose_splits(Geometry& g, Plan& pl) {
  const int by_regs = pl.tile == 2 ? Wide::kMinBlocks : pl.tile == 1 ? Medium::kMinBlocks : KSplit::kMinBlocks;
  const long long blocks = (long long)g.nT * (g.nT + 1) / 2 * g.groups;
  const long long per_sm = min(by_regs, (int)(kMaxSmem / pl.smem));
  const long long slots = sm_count() * (per_sm < 1 ? 1 : per_sm);
  const long long side = (long long)g.nT * tile_side(pl.tile);
  long long max_splits = min((long long)(g.units + 3) / 4, (16ll << 20) / (side * side * g.groups));
  if (max_splits < 1) max_splits = 1;
  long long best = 1, best_cost = -1;
  for (long long s = 1; s <= max_splits; ++s) {
    const long long cost = (blocks * s + slots - 1) / slots * ((g.units + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  g.units_per_split = (int)((g.units + best - 1) / best);
  pl.splits = (g.units + g.units_per_split - 1) / g.units_per_split;
}

// Fill g and choose the plan; false where no stage fits in shared memory.
bool plan(Geometry& g, int B, uintptr_t addr, Plan& pl) {
  // The tile, as measured on an H100 over ResNet-32's and ResNeXt-50's
  // convs: a narrow group whole; for a conv with a filter wider than 1x1,
  // 48-wide tiles where their triangle covers at most 4/5 of the 64-wide
  // tiles' (F' = 144, 288, which 64-wide tiles pad to 192, 320); 128-wide
  // tiles for a 1x1 conv that fills them (F' >= 512, or a multiple of
  // 128); else 64-wide.
  const int kk = g.kh * g.kw;
  const auto area = [&](int bt) {
    const long long n = (g.Fp + bt - 1) / bt;
    return n * (n + 1) / 2 * bt * bt;
  };
  const int preferred = g.Fp <= KSplit::BT || (kk > 1 && 5 * area(KSplit::BT) <= 4 * area(Medium::BT)) ? 0
                      : kk == 1 && g.Fp > 64 && (g.Fp >= 512 || g.Fp % 128 == 0) ? 2 : 1;
  const auto fits = [&](int R, int SW) {
    g.R = R;
    g.SW = SW;
    choose_copy(g, pl, addr);
    fill(g, pl, B);
    return pl.smem <= (size_t)kMaxSmem;
  };
  // The stage: the largest divisor R of OH with R*OW <= the tile's stage
  // positions (or R = 1) whose window fits; else one output row in the
  // widest column tiles (multiples of 8 columns) that fit; else the same
  // with the next narrower tile, whose window spans fewer channels. Wide
  // images take these (ResNet-50's 1x1 convs on 256 channels at 112 x 112,
  // a 7 x 7 stem at 512 x 512).
  for (pl.tile = preferred; pl.tile >= 0; --pl.tile) {
    for (int R = g.OH; R >= 1; --R) {
      if (g.OH % R == 0 && (R == 1 || R * g.OW <= kStagePositions[pl.tile]) && fits(R, g.OW)) {
        choose_splits(g, pl);
        return true;
      }
    }
    for (int SW = ((g.OW + 1) / 2 + 7) / 8 * 8; SW >= 8; SW -= 8) {
      if (SW < g.OW && fits(1, SW)) {
        choose_splits(g, pl);
        return true;
      }
    }
  }
  return false;
}

// Take the plan kfac_patch_cov_plan made (tile, splits, R, SW: no search
// again); false where it does not fit this geometry.
bool adopt(Geometry& g, int B, uintptr_t addr, const int* in, Plan& pl) {
  pl.tile = in[0];
  pl.splits = in[3];
  g.R = in[4];
  g.SW = in[5];
  if (pl.tile < 0 || pl.tile > 2 || pl.splits < 1 || g.R < 1 || g.OH % g.R || g.SW < 1 ||
      g.SW > g.OW || (g.SW < g.OW && g.R != 1))
    return false;
  choose_copy(g, pl, addr);
  fill(g, pl, B);
  g.units_per_split = (g.units + pl.splits - 1) / pl.splits;
  return pl.smem <= (size_t)kMaxSmem && in[6] == g.nT * tile_side(pl.tile) &&
         (g.units + g.units_per_split - 1) / g.units_per_split == pl.splits;
}

template <class TL, int MODE, int V, class T>
cudaError_t run(const T* x, float* part, const Geometry& g, const Plan& pl, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_cov_mma<TL, MODE, V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(g.nT * (g.nT + 1) / 2, pl.splits, g.groups);
  patch_cov_mma<TL, MODE, V, T><<<grid, TL::kThreads, pl.smem, s>>>(x, part, g);
  return cudaGetLastError();
}

template <class TL, int MODE, class T>
cudaError_t run_vec(const T* x, float* part, const Geometry& g, const Plan& pl, cudaStream_t s) {
  if constexpr (kIsBf16<T>)
    if (pl.vec == 8) return run<TL, MODE, 8>(x, part, g, pl, s);
  return pl.vec == 4 ? run<TL, MODE, 4>(x, part, g, pl, s)
       : pl.vec == 2 ? run<TL, MODE, 2>(x, part, g, pl, s)
                     : run<TL, MODE, 1>(x, part, g, pl, s);
}

template <class TL, class T>
cudaError_t run_copy(const T* x, float* part, const Geometry& g, const Plan& pl, cudaStream_t s) {
  return pl.mode == kSlab ? run<TL, kSlab, 16 / (int)sizeof(T)>(x, part, g, pl, s)
       : pl.mode == kFlat ? run_vec<TL, kFlat>(x, part, g, pl, s)
                          : run_vec<TL, kRows>(x, part, g, pl, s);
}

template <class T>
cudaError_t run_tile(const void* x, float* part, const Geometry& g, const Plan& pl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  switch (pl.tile) {
    case 2: return run_copy<Wide>(xt, part, g, pl, s);
    case 1: return run_copy<Medium>(xt, part, g, pl, s);
    default: return run_copy<KSplit>(xt, part, g, pl, s);
  }
}

Geometry geometry(int C, int H, int W, int kh, int kw, int sh, int sw, int ph,
                  int pw, int dh, int dw, int OH, int OW, int has_bias, int groups,
                  int bf16) {
  Geometry g{};
  g.esize = bf16 ? 2 : 4;
  g.C = C / groups; g.H = H; g.W = W; g.kh = kh; g.kw = kw; g.sh = sh;
  g.sw = sw; g.ph = ph; g.pw = pw; g.dh = dh; g.dw = dw; g.OH = OH;
  g.OW = OW;
  g.F = g.C * kh * kw;
  g.Fp = g.F + (has_bias ? 1 : 0);
  g.groups = groups;
  g.chw = (long long)C * H * W;
  return g;
}

}  // namespace

// The plan kfac_patch_cov takes for these inputs, into out[0..6]: the tile
// (0: 48 x 48, or one block per narrow group; 1: 64 x 64; 2: 128 x 128),
// the copy width in bytes (2, 4, 8 or 16), the stage's layout (Mode: 0 a
// window of input rows, 1 each channel's contiguous rows, 2 one slab), the
// splits, the output rows and columns per stage, and the side P of each
// partial tile (the scratch kfac_patch_cov takes is [splits, groups, P, P]
// floats). bf16: x is bfloat16 (else float32).
extern "C" int kfac_patch_cov_plan(const void* x, int B, int C, int H, int W,
                                   int kh, int kw, int sh, int sw, int ph,
                                   int pw, int dh, int dw, int OH, int OW,
                                   int has_bias, int groups, int bf16, int* out) {
  Geometry g = geometry(C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, has_bias, groups, bf16);
  Plan pl;
  if (!plan(g, B, reinterpret_cast<uintptr_t>(x), pl)) return (int)cudaErrorInvalidValue;
  out[0] = pl.tile;
  out[1] = g.esize * pl.vec;
  out[2] = pl.mode;
  out[3] = pl.splits;
  out[4] = g.R;
  out[5] = g.SW;
  out[6] = g.nT * tile_side(pl.tile);
  return 0;
}

// x: [B, C, H, W], float32 or (bf16) bfloat16; C counts every group's
// channels. plan: what kfac_patch_cov_plan returned for this geometry, x's
// type and its alignment; part: the scratch it sizes; out: [groups, Fp,
// Fp] float32.
extern "C" int kfac_patch_cov(const void* x, void* part, void* out, int B,
                              int C, int H, int W, int kh, int kw, int sh,
                              int sw, int ph, int pw, int dh, int dw, int OH,
                              int OW, int has_bias, int groups, int bf16,
                              const int* plan, float scale, void* stream) {
  Geometry g = geometry(C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, has_bias, groups, bf16);
  Plan pl;
  if (!adopt(g, B, reinterpret_cast<uintptr_t>(x), plan, pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  const cudaError_t err = bf16 ? run_tile<Bf16>(x, pf, g, pl, s) : run_tile<float>(x, pf, g, pl, s);
  if (err != cudaSuccess) return (int)err;
  const int side = g.nT * tile_side(pl.tile);
  patch_cov_reduce<<<dim3((g.Fp + 127) / 128, g.Fp, groups), 128, 0, s>>>(
      pf, static_cast<float*>(out), g.Fp, side, pl.splits, groups, scale);
  return (int)cudaGetLastError();
}
