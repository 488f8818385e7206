// Multi-tensor momentum + weight-decay SGD, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/apply_kernels.py::
// fused_sgd_apply (body _fused_sgd_kernel). Per element of every parameter
// leaf (BatchNorm scales and biases included):
//
//     m' = μ·m + (g + wd·p)        (weight decay folded in before momentum)
//     p' = p − lr·m'
//
// the composition training/step.py::make_sgd builds (torch.optim.SGD with
// dampening 0). Each product and sum is rounded on its own (no fused
// multiply-add), in that order.
//
// What bounds it on this card: bytes. Each element reads p, g, m and
// writes p, m: 20 bytes for 4 FLOPs.
//
// Design. The TPU version concatenates and pads every leaf into one
// [rows, 128] stream and unpacks it afterwards. Here one launch walks a
// table of (param, grad, momentum, size) pointers passed by value as the
// kernel argument, and updates params and momentum IN PLACE: no packing,
// no copies, one read and one write of each state buffer. Each leaf is cut
// into 4096-element chunks; a block finds its leaf by binary search over
// the chunk offsets. Tables longer than kMaxLeaves take one launch per
// kMaxLeaves leaves (the argument must stay under 4 KB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 100;
constexpr int kChunk = 4096;
constexpr int kThreads = 256;

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];
  int count;
};

__global__ void __launch_bounds__(kThreads)
fused_sgd(LeafTable t, float lr, float mu, float wd) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const long long start = (long long)(b - t.first_chunk[lo]) * kChunk;
  long long end = start + kChunk;
  if (end > t.n[lo]) end = t.n[lo];
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float pv = p[i];
    const float m2 =
        __fadd_rn(__fmul_rn(mu, m[i]), __fadd_rn(g[i], __fmul_rn(wd, pv)));
    m[i] = m2;
    p[i] = __fsub_rn(pv, __fmul_rn(lr, m2));
  }
}

}  // namespace

extern "C" int kfac_fused_sgd(void* params, void* grads, void* trace,
                              void* sizes, int count, float lr, float mu,
                              float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float** P = static_cast<float**>(params);
  const float** G = static_cast<const float**>(grads);
  float** M = static_cast<float**>(trace);
  const long long* N = static_cast<const long long*>(sizes);
  for (int base = 0; base < count; base += kMaxLeaves) {
    LeafTable t;
    t.count = count - base < kMaxLeaves ? count - base : kMaxLeaves;
    int chunks = 0;
    for (int l = 0; l < t.count; ++l) {
      t.p[l] = P[base + l];
      t.g[l] = G[base + l];
      t.m[l] = M[base + l];
      t.n[l] = N[base + l];
      t.first_chunk[l] = chunks;
      chunks += (int)((N[base + l] + kChunk - 1) / kChunk);
    }
    t.first_chunk[t.count] = chunks;
    if (chunks == 0) continue;
    fused_sgd<<<chunks, kThreads, 0, s>>>(t, lr, mu, wd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
