// Multi-tensor momentum + weight-decay SGD, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/apply_kernels.py::
// fused_sgd_apply (body _fused_sgd_kernel). Per element of every parameter
// leaf (BatchNorm scales and biases included):
//
//     m' = μ·m + (g + wd·p)        (weight decay folded in before momentum)
//     p' = p − lr·m'
//
// lr is read from device memory (a float32 scalar, read once per block),
// so a launch captured in a CUDA graph takes each replay's learning rate;
// μ and the weight decay, constant for a run, are arguments.
//
// the composition training/step.py::make_sgd builds (torch.optim.SGD with
// dampening 0). Each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no fused multiply-add), in that order, which is
// what the plain version's separate PyTorch ops do element by element: the
// kernel is bitwise equal to ops/apply_kernels.py::fused_sgd_apply_plain.
//
// What bounds it on this card: bytes. Each element reads p, g, m and
// writes p, m: 20 bytes for 4 FLOPs. At the paths' sizes (0.5 M to 25 M
// parameters) the launch and the host work around it matter as much.
//
// Design. The TPU version concatenates and pads every leaf into one
// [rows, 128] stream and unpacks it afterwards. Here one launch walks a
// table of (param, grad, momentum, size, first chunk) entries passed BY
// VALUE as the kernel argument (__grid_constant__: read from the constant
// bank, never copied), and updates params and momentum IN PLACE: no
// packing, no copies, one read and one write of each state buffer. Since
// CUDA 12.1 an sm_90 kernel takes up to 32,764 bytes of arguments, so one
// table holds up to 896 leaves (36 bytes each); a longer leaf set takes one
// launch per 896 leaves. The table comes in three capacities (64, 256 and
// 896 leaves) so that a short leaf set passes a short argument.
// ops/apply_kernels.py plans the tables (chunk offsets, capacities) once
// per leaf set and rewrites only the grad pointers per call.
//
// Each leaf is cut into 4096-element chunks, one block each; a block finds
// its leaf by binary search over the chunk offsets (uniform across the
// block: constant-bank broadcasts). A leaf whose p, g and m all start
// 16-byte aligned moves float4s: each of the 256 threads loads 4 float4s of
// p, g and m before it computes (192 bytes in flight per thread, 48 KB per
// block), then stores, and a scalar tail takes the last numel % 4 elements.
// Chunks start at multiples of 4096 elements, so a leaf's alignment holds
// in every chunk. Any other leaf takes the scalar path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kVec = kChunk / (4 * kThreads);  // float4s per thread: 4

// Mirrored by ops/apply_kernels.py::_table_type (ctypes); the entry
// kfac_fused_sgd_table_bytes lets the wrapper check the two agree.
template <int Cap>
struct LeafTable {
  float* p[Cap];
  const float* g[Cap];
  float* m[Cap];
  long long n[Cap];
  int first_chunk[Cap + 1];
  int count;
};

__device__ __forceinline__ void sgd1(float& p, float g, float& m, float lr,
                                     float mu, float wd) {
  const float m2 = __fadd_rn(__fmul_rn(mu, m), __fadd_rn(g, __fmul_rn(wd, p)));
  m = m2;
  p = __fsub_rn(p, __fmul_rn(lr, m2));
}

template <int Cap>
__global__ void __launch_bounds__(kThreads)
fused_sgd(const __grid_constant__ LeafTable<Cap> t, const float* __restrict__ lr_ptr,
          float mu, float wd) {
  const float lr = __ldg(lr_ptr);
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {  // the last leaf whose first chunk is <= b (skips empty leaves)
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const long long start = (long long)(b - t.first_chunk[lo]) * kChunk;
  const int len = (int)min((long long)kChunk, t.n[lo] - start);
  float* __restrict__ p = t.p[lo] + start;
  const float* __restrict__ g = t.g[lo] + start;
  float* __restrict__ m = t.m[lo] + start;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  if (vec) {
    const int nv = len >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4 pv[kVec], gv[kVec], mv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        pv[k] = p4[i];
        gv[k] = __ldg(g4 + i);
        mv[k] = m4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        sgd1(pv[k].x, gv[k].x, mv[k].x, lr, mu, wd);
        sgd1(pv[k].y, gv[k].y, mv[k].y, lr, mu, wd);
        sgd1(pv[k].z, gv[k].z, mv[k].z, lr, mu, wd);
        sgd1(pv[k].w, gv[k].w, mv[k].w, lr, mu, wd);
        m4[i] = mv[k];
        p4[i] = pv[k];
      }
    }
    const int i = 4 * nv + threadIdx.x;  // scalar tail: len % 4 < kThreads
    if (i < len) {
      float pe = p[i], me = m[i];
      sgd1(pe, g[i], me, lr, mu, wd);
      m[i] = me;
      p[i] = pe;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float pe = p[i], me = m[i];
      sgd1(pe, g[i], me, lr, mu, wd);
      m[i] = me;
      p[i] = pe;
    }
  }
}

template <int Cap>
int launch(const void* table, int blocks, const float* lr, float mu, float wd,
           cudaStream_t s) {
  fused_sgd<Cap><<<blocks, kThreads, 0, s>>>(
      *static_cast<const LeafTable<Cap>*>(table), lr, mu, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// sizeof(LeafTable<cap>), or -1 for a capacity the library was not built
// with.
extern "C" int kfac_fused_sgd_table_bytes(int cap) {
  switch (cap) {
    case 64: return (int)sizeof(LeafTable<64>);
    case 256: return (int)sizeof(LeafTable<256>);
    case 896: return (int)sizeof(LeafTable<896>);
    default: return -1;
  }
}

// One launch of `blocks` blocks over the host table `table` of capacity
// `cap` (a LeafTable<cap> laid out by the wrapper); `lr` points at the
// float32 learning rate in device memory.
extern "C" int kfac_fused_sgd(const void* table, int cap, int blocks,
                              const float* lr, float mu, float wd,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cap) {
    case 64: return launch<64>(table, blocks, lr, mu, wd, s);
    case 256: return launch<256>(table, blocks, lr, mu, wd, s);
    case 896: return launch<896>(table, blocks, lr, mu, wd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
