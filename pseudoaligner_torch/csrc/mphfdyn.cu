// K8, the shard-local MPHF probe of the k-mer-partitioned step: received
// queries [N, W] uint32 -> (node, offset) [N, 2] int32, -1 where the query
// is not a key of this shard.
//
// Replaces pseudoaligner_tpu/ops/mphf_lookup.py::mphf_probe_dynamic (:58)
// with the stored-key verify and the value gather that follow it in
// parallel/sharded_index.py::_routed_seed_tables (:327-343).
//
// Each shard holds its own sub-MPHF, so the level table (seeds, masks, word
// and key offsets; n_levels <= MAX_LEVELS) comes from device memory, not
// from the launch parameters as in K1.  Each block copies it into shared
// memory, then one thread per query runs common.cuh's mphf_slot over it
// (the first level whose bit is set gives the slot) and key_at_slot_equals,
// both for the W the launch picks (the stored key in 8- or 16-byte loads,
// so the wrapper asks for a 16-byte aligned key array).
// Levels padded past a shard's own have mask 0 and point at a zero word,
// so they never hit.  Every buffer slot is probed, zero-key padding
// included, as the reference does.
//
// Bound on the H100: memory bytes.  Per query its W key words, a bit word
// per level tried, and where a bit is set the rank word and the stored key,
// all random reads into the shard's arrays; the [N, 2] results written.

#include "common.cuh"

namespace {

struct Dyn {
  int64_t n;
  int W, n_levels;
  const uint32_t* queries;
  const uint32_t* bits;
  const uint32_t* ranks;
  const uint32_t* seeds;
  const uint32_t* masks;
  const int32_t* word_offsets;
  const int32_t* key_offsets;
  const uint32_t* keys;
  const int32_t* values;
};

template <int W>
__global__ void mphf_dynamic_kernel(Dyn a, int32_t* __restrict__ out) {
  __shared__ pa::Levels lv;
  for (int i = threadIdx.x; i < a.n_levels; i += blockDim.x) {
    lv.seed[i] = a.seeds[i];
    lv.mask[i] = a.masks[i];
    lv.word_off[i] = (uint32_t)a.word_offsets[i];
    lv.key_off[i] = (uint32_t)a.key_offsets[i];
  }
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n) return;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; j++) w[j] = a.queries[t * W + j];
  const int slot = pa::mphf_slot<W>(a.n_levels, lv, a.bits, a.ranks, w);
  int node = -1, off = -1;
  if (slot >= 0 && pa::key_at_slot_equals<W>(a.keys, slot, w)) {
    node = a.values[2 * (int64_t)slot];
    off = a.values[2 * (int64_t)slot + 1];
  }
  out[2 * t] = node;
  out[2 * t + 1] = off;
}

}  // namespace

extern "C" int pa_mphf_dynamic(int device, long long n, int W, int n_levels,
                               const uint32_t* queries, const uint32_t* bits,
                               const uint32_t* ranks, const uint32_t* seeds,
                               const uint32_t* masks,
                               const int32_t* word_offsets,
                               const int32_t* key_offsets,
                               const uint32_t* keys, const int32_t* values,
                               int32_t* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (W < 1 || W > pa::MAX_W || n_levels < 1 || n_levels > pa::MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Dyn a = {n, W, n_levels, queries, bits, ranks, seeds, masks,
           word_offsets, key_offsets, keys, values};
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)pa::with_w(W, [&](auto w) {
    mphf_dynamic_kernel<decltype(w)::value>
        <<<blocks, threads, 0, st>>>(a, out);
    return cudaGetLastError();
  });
}
