// Embedding token counts (the diagonal A factor), for Hopper (sm_90a).
//
// Replaces the TPU kernel kfac_pytorch_tpu/ops/factor_kernels.py::
// compute_a_embed_fused (body _token_count_kernel). For N token ids and a
// vocabulary of V it computes
//
//     a[v] = #{n : ids[n] = v} / N
//
// the input covariance of an embedding lookup, which is exactly diagonal
// (a lookup is a dense layer over one-hot rows).
//
// What bounds it on this card: bytes, and at the sizes of a training step
// the launch. One compare and one add per id; N ids read (4 or 8 bytes
// each), V floats written. At N = 8192, V = 1000 that is ~37 KB, a few
// hundred nanoseconds of HBM time.
//
// Design. The Pallas kernel compares each [1024]-id block with a
// [512]-vocab tile's iota (a one-hot compare tile that lives only in VMEM)
// and accumulates each vocab tile sequentially over the token grid. Blocks
// here run in no order, so the grid is (token splits, vocab tiles): each
// block builds a shared-memory histogram of its ids over its vocab tile
// with integer atomics, then adds every nonzero bin to a global integer
// count with one atomic. Integer sums are exact and commutative, so the
// counts do not depend on the order blocks run in. A second launch divides
// each count by N as one correctly rounded float32 division (__fdiv_rn):
// the same single operation as the plain version, so the result equals
// ops/factors.py::compute_a_embed bit for bit while counts stay below 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVocabTile = 4096;  // bins per block: 16 KB of shared memory

template <typename Id>
__global__ void __launch_bounds__(kThreads)
token_hist(const Id* __restrict__ ids, long long n, long long per_split,
           int vocab, unsigned int* __restrict__ counts) {
  __shared__ unsigned int hist[kVocabTile];
  const int v0 = blockIdx.y * kVocabTile;
  const int width = min(kVocabTile, vocab - v0);
  for (int i = threadIdx.x; i < width; i += kThreads) hist[i] = 0u;
  __syncthreads();
  const long long start = (long long)blockIdx.x * per_split;
  const long long end = min(start + per_split, n);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const long long v = (long long)ids[i] - v0;
    if (v >= 0 && v < width) atomicAdd(&hist[v], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const unsigned int c = hist[i];
    if (c) atomicAdd(&counts[v0 + i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
counts_to_freq(const unsigned int* __restrict__ counts, float* __restrict__ out,
               int vocab, float n) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < vocab) out[v] = __fdiv_rn(__uint2float_rn(counts[v]), n);
}

}  // namespace

extern "C" int kfac_token_count(const void* ids, int ids_int64, long long n,
                                int vocab, int splits, long long per_split,
                                void* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* C = static_cast<unsigned int*>(counts);
  cudaError_t err = cudaMemsetAsync(C, 0, sizeof(unsigned int) * vocab, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, (vocab + kVocabTile - 1) / kVocabTile);
  if (ids_int64)
    token_hist<long long><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(ids), n, per_split, vocab, C);
  else
    token_hist<int><<<grid, kThreads, 0, s>>>(static_cast<const int*>(ids), n,
                                              per_split, vocab, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  counts_to_freq<<<(vocab + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      C, static_cast<float*>(out), vocab, (float)n);
  return (int)cudaGetLastError();
}
