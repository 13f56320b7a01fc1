// K3, the seed-statistics kernel: a batch of 2-bit packed reads -> three
// counters (valid k-mer positions, verified MPHF hits, MPHF false
// positives).
//
// Replaces pseudoaligner_tpu/ops/stats.py::_stats_impl (with unpack_reads,
// all_kmers, mphf_probe and the stored-key verify).
//
// One thread per (read, position p).  A position is valid when
// p <= len - k.  For a valid position the thread cuts the k-mer's words
// from the packed read (common.cuh kmer_words, for the W the launch
// picks), runs the MPHF level probe (common.cuh mphf_slot, one 8-byte
// (bit word, rank word) load per level tried) and compares the key of the
// slot's record (common.cuh record_verify, one load of key words, node and
// offset): a hit when it equals, a false positive when a slot came back
// but the key differs.  Each block sums its threads' three flags (warp
// shuffles, then one warp over the per-warp sums) and adds them to the
// int64 counters with one atomicAdd each; the wrapper zeroes the counters
// before the launch.
//
// Bound on the H100: memory bytes, but what limits it is the rate of
// random reads: per valid position a pair per level tried (aliens try
// several) and, where a level's bit is set, the slot's record, from a
// record array far larger than the 50 MB L2.  The record reads go under an
// L2 evict-first policy (common.cuh load_words_evict_first), so they do
// not evict the pair array, and 1024-thread blocks make one set of
// atomics per 1024 positions; both measured on the card (PERF.md §6), as
// were two losers, loading two levels' pairs at once and an L2 persisting
// window over the pairs.

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

template <int W>
__global__ void stats_kernel(pa::Params p, const __grid_constant__ pa::Levels lv,
                             const uint32_t* __restrict__ packed,
                             const int32_t* __restrict__ lens, pa::Index ix,
                             unsigned long long* __restrict__ counts) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned valid = 0, hit = 0, fp = 0;
  if (t < (int64_t)p.B * p.P) {
    const int b = (int)(t / p.P);
    const int pos = (int)(t % p.P);
    if (pos <= lens[b] - p.k) {
      valid = 1;
      uint32_t w[W];
      pa::kmer_words<W>(pa::window_words(packed + (size_t)b * p.nw, p.nw),
                        pos, p.k, w);
      const int slot = pa::mphf_slot<W>(p.n_levels, lv, ix.pairs, w);
      int node, off;
      if (slot >= 0) {
        if (pa::record_verify<W>(ix.records, slot, w, &node, &off))
          hit = 1;
        else
          fp = 1;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    valid += __shfl_down_sync(0xFFFFFFFFu, valid, d);
    hit += __shfl_down_sync(0xFFFFFFFFu, hit, d);
    fp += __shfl_down_sync(0xFFFFFFFFu, fp, d);
  }
  __shared__ unsigned part[3][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = valid;
    part[1][warp] = hit;
    part[2][warp] = fp;
  }
  __syncthreads();
  if (warp == 0) {
    valid = lane < THREADS / 32 ? part[0][lane] : 0;
    hit = lane < THREADS / 32 ? part[1][lane] : 0;
    fp = lane < THREADS / 32 ? part[2][lane] : 0;
    for (int d = 16; d > 0; d >>= 1) {
      valid += __shfl_down_sync(0xFFFFFFFFu, valid, d);
      hit += __shfl_down_sync(0xFFFFFFFFu, hit, d);
      fp += __shfl_down_sync(0xFFFFFFFFu, fp, d);
    }
    if (lane == 0) {
      if (valid) atomicAdd(&counts[0], (unsigned long long)valid);
      if (hit) atomicAdd(&counts[1], (unsigned long long)hit);
      if (fp) atomicAdd(&counts[2], (unsigned long long)fp);
    }
  }
}

}  // namespace

extern "C" int pa_stats(const int64_t* params, const int64_t* index,
                        int device, const uint32_t* packed,
                        const int32_t* lens, unsigned long long* counts,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const pa::Levels lv = pa::levels_from(params);
  const pa::Index ix = pa::index_from(index);
  const int64_t n = (int64_t)p.B * p.P;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)pa::with_w(p.W, [&](auto w) {
    stats_kernel<decltype(w)::value><<<blocks, THREADS, 0, st>>>(
        p, lv, packed, lens, ix, counts);
    return cudaGetLastError();
  });
}
