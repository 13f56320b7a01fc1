// K8, the shard-local MPHF probe of the k-mer-partitioned step: received
// queries [N, W] uint32 -> (node, offset) [N, 2] int32, -1 where the query
// is not a key of this shard.
//
// Replaces pseudoaligner_tpu/ops/mphf_lookup.py::mphf_probe_dynamic (:58)
// with the stored-key verify and the value gather that follow it in
// parallel/sharded_index.py::_routed_seed_tables (:327-343).
//
// Layouts (parallel/sharded_index.py upload_lookup): the shard's MPHF level
// words as (bit word, rank word) pairs, one 8-byte load per level tried;
// its slots as records of RW = 4 or 8 words (W key words, node, offset,
// zero padding), so the verify and the value gather are one 16- or 32-byte
// load of one sector.
//
// Each shard holds its own sub-MPHF, so the level table (seeds, masks, word
// and key offsets; n_levels <= MAX_LEVELS) comes from device memory, not
// from the launch parameters as in K1.  Each block copies it into shared
// memory, then one thread per query runs common.cuh's mphf_slot over it
// (the first level whose bit is set gives the slot) and verifies and reads
// the record at the slot, for the W the launch picks.  Levels padded past a
// shard's own have mask 0 and point at a zero word, so they never hit.
//
// The send buffers are mostly padding: every unused slot holds the
// all-zero query (at S = 1 three slots in four), and every all-zero query
// has the same answer, the lookup of the poly-A k-mer, whether or not that
// k-mer is a key.  So thread 0 of a block that holds all-zero queries
// probes the zero key once, and those threads write its answer without
// hashing or probing: the output is the reference's at every slot, padding
// included.  Padding fills the tail of each source's segment, so whole
// warps take that path.
//
// Bound on the H100: memory bytes, but what limits it is the rate of
// random reads: per real query its W key words, a pair per level tried and
// one record sector where a level's bit is set; the [N, 2] results
// written.  Two choices measured on the card (PERF.md §6):
// - the queries, the records and the results go under an L2 evict-first
//   policy (common.cuh load_words_evict_first), so the pair array stays in
//   L2;
// - blocks take the buffer's tiles in an interleaved order (block b takes
//   tile b * stride mod the grid, stride about a quarter of the grid and
//   coprime to it), so the probe-heavy tiles at the head of each segment
//   run beside the padding tiles that only stream, not before them.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Dyn {
  int64_t n;
  int n_levels;
  const uint32_t* queries;
  const uint2* pairs;
  const uint32_t* seeds;
  const uint32_t* masks;
  const int32_t* word_offsets;
  const int32_t* key_offsets;
  const uint32_t* records;
};

// (node, offset) of the query words w: the record at the MPHF slot when its
// key equals w, else (-1, -1) (common.cuh record_verify).
template <int W>
__device__ __forceinline__ int2 lookup(const Dyn& a, const pa::Levels& lv,
                                       const uint32_t (&w)[W]) {
  const int slot = pa::mphf_slot<W>(a.n_levels, lv, a.pairs, w);
  int2 r = make_int2(-1, -1);
  if (slot >= 0) pa::record_verify<W>(a.records, slot, w, &r.x, &r.y);
  return r;
}

template <int W>
__global__ void mphf_dynamic_kernel(Dyn a, int64_t stride,
                                    int2* __restrict__ out) {
  __shared__ pa::Levels lv;
  __shared__ int2 zero;
  for (int i = threadIdx.x; i < a.n_levels; i += blockDim.x) {
    lv.seed[i] = a.seeds[i];
    lv.mask[i] = a.masks[i];
    lv.word_off[i] = (uint32_t)a.word_offsets[i];
    lv.key_off[i] = (uint32_t)a.key_offsets[i];
  }
  __syncthreads();
  const int64_t tile = (int64_t)blockIdx.x * stride % gridDim.x;
  const int64_t t = tile * blockDim.x + threadIdx.x;
  const bool in = t < a.n;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; j++) w[j] = 0;
  if (in) pa::load_words_evict_first<W>(a.queries + t * W, w);
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < W; j++) any |= w[j];
  const bool padded = in && any == 0;
  int2 r = make_int2(-1, -1);
  if (__syncthreads_or(padded)) {
    if (threadIdx.x == 0) {
      const uint32_t zw[W] = {};
      zero = lookup<W>(a, lv, zw);
    }
    if (in && !padded) r = lookup<W>(a, lv, w);
    __syncthreads();
    if (padded) r = zero;
  } else if (in) {
    r = lookup<W>(a, lv, w);
  }
  if (in) pa::store_evict_first(out + t, r);
}

int64_t gcd(int64_t x, int64_t y) {
  while (y) {
    const int64_t r = x % y;
    x = y;
    y = r;
  }
  return x;
}

}  // namespace

extern "C" int pa_mphf_dynamic(int device, long long n, int W, int n_levels,
                               const uint32_t* queries, const uint2* pairs,
                               const uint32_t* seeds, const uint32_t* masks,
                               const int32_t* word_offsets,
                               const int32_t* key_offsets,
                               const uint32_t* records, int32_t* out,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (W < 1 || W > pa::MAX_W || n_levels < 1 || n_levels > pa::MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Dyn a = {n, n_levels, queries, pairs, seeds, masks, word_offsets,
                 key_offsets, records};
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  int64_t stride = blocks / 4 + 1;
  while (gcd(stride, blocks) != 1) stride++;
  cudaStream_t st = (cudaStream_t)stream;
  int2* o = reinterpret_cast<int2*>(out);
  return (int)pa::with_w(W, [&](auto w) {
    mphf_dynamic_kernel<decltype(w)::value>
        <<<(unsigned)blocks, THREADS, 0, st>>>(a, stride, o);
    return cudaGetLastError();
  });
}
