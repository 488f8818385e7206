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
// What bounds it on this card: at the sizes of a training step, the
// launch. One compare and one add per id; N ids read (4 or 8 bytes each),
// V floats written. At N = 8192, V = 1000 that is ~70 KB, about 20 ns of
// HBM time: far below one launch, which is the practical floor.
//
// Design: ONE launch, no memset, no second kernel, no scratch in device
// memory and nothing for the host to wait on. The Pallas kernel compares
// each [1024]-id block with a [512]-vocab tile's iota and accumulates each
// vocab tile sequentially over the token grid. Here a thread block cluster
// of 8 blocks owns a slice of the vocabulary as uint32 bins in its blocks'
// shared memory (at most 12,288 bins a block: 48 KB, so one cluster covers
// 98,304 ids of vocabulary; a larger V takes more clusters along the vocab
// axis, each scanning all ids). Each block zeroes its bins, the cluster
// syncs, each block scans one eighth of the ids and adds each id into the
// owning block's bin through distributed shared memory
// (cluster.map_shared_rank + atomicAdd), the cluster syncs again, and each
// block divides its own bins by N (__fdiv_rn) and writes them. Integer
// counts are exact and do not depend on the order of the adds, and the one
// correctly rounded division is the plain version's single operation: the
// result equals ops/factors.py::compute_a_embed bit for bit while counts
// and N stay below 2^24.
//
// An id outside [0, V) is binned nowhere, as the Pallas kernel's iota
// compare bins it nowhere. The first cluster also counts such ids into a
// tally in device memory, int64[4] = {count, V, least, greatest}, that the
// wrapper keeps per device and factor_kernels.check_token_ids reads (one
// host sync, at a point the caller chooses) and resets.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kMaxBins = 12288;  // 48 KB of uint32 bins a block

template <typename Id>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
token_count(const Id* __restrict__ ids, long long n, int vocab, int bins,
            float count_n, float* __restrict__ out,
            long long* __restrict__ tally) {
  __shared__ unsigned int hist[kMaxBins];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long v0 = (long long)(blockIdx.x / kCluster) * kCluster * bins;
  const long long span = (long long)kCluster * bins;
  for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0u;
  cluster.sync();  // every block's bins are zero before any block adds

  const long long per = (n + kCluster - 1) / kCluster;
  const long long start = rank * per;
  const long long end = min(start + per, n);
  const bool first_cluster = blockIdx.x < kCluster;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const long long v = (long long)ids[i];
    if (v < 0 || v >= vocab) {
      if (first_cluster) {
        atomicAdd(reinterpret_cast<unsigned long long*>(tally), 1ull);
        tally[1] = vocab;
        atomicMin(tally + 2, v);
        atomicMax(tally + 3, v);
      }
      continue;
    }
    const long long local = v - v0;
    if (local >= 0 && local < span) {
      const int owner = (int)(local / bins);
      atomicAdd(cluster.map_shared_rank(hist, owner) + (local - (long long)owner * bins), 1u);
    }
  }
  cluster.sync();  // every add has landed; no block reads another's bins after this

  const long long base = v0 + (long long)rank * bins;
  for (int i = threadIdx.x; i < bins && base + i < vocab; i += kThreads)
    out[base + i] = __fdiv_rn(__uint2float_rn(hist[i]), count_n);
}

}  // namespace

// a[v] for v in [0, vocab) into out, in clusters * 8 blocks of `bins` bins
// each (ops/factor_kernels.py::token_count_plan); out-of-range ids into
// tally.
extern "C" int kfac_token_count(const void* ids, int ids_int64, long long n,
                                int vocab, int bins, int clusters, void* out,
                                void* tally, void* stream) {
  if (bins < 1 || bins > kMaxBins || clusters < 1 ||
      (long long)clusters * kCluster * bins < vocab)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(clusters * kCluster);
  float* o = static_cast<float*>(out);
  long long* t = static_cast<long long*>(tally);
  if (ids_int64)
    token_count<long long><<<grid, kThreads, 0, s>>>(
        static_cast<const long long*>(ids), n, vocab, bins, (float)n, o, t);
  else
    token_count<int><<<grid, kThreads, 0, s>>>(static_cast<const int*>(ids), n,
                                               vocab, bins, (float)n, o, t);
  return (int)cudaGetLastError();
}
