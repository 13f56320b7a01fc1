// K11, the owner side of the graph-sharded walk's routed fetch: serve the
// (node, delta) requests every shard sent this shard from its block of the
// graph.
//
// Replaces pseudoaligner_tpu/parallel/sharded_index.py::_routed_fetch_factory
// (:151-202), the gather of the node row from the local block and the
// window extraction from the local pool slice between its two all_to_alls.
//
// One thread per request slot, over the S x B slots of recv [S*B, 2].  A
// slot with node < 0 is "no request" (graph_walk.py writes it for lanes
// that fetch nothing) and is answered with zeros.  Otherwise the local row
// is clip(node - me*Nb, 0, Nb-1); the thread copies its 12 int32 and, when
// WW > 0, the WW words of 2-bit bases ascending from q = max(row[0] +
// delta, 0) in the block's flat pool: base q + t at bits 2*(t & 15) of word
// t >> 4, the packing pa::base_at reads.  Each word is one funnel shift of
// two neighbouring pool words; words past the pool's end read as zero
// (every window of a real request lies inside the block's padded pool).
// The response, out [S*B, 12 + WW], is int32 throughout: gloo refuses
// uint32, so the window words ride as their bit patterns.
//
// Bound on the H100: bytes, and at the walk's batch sizes launch latency.
// At S = 1 and B = 65,536 a windowed fetch reads 0.5 MB of requests and
// writes 4.2 MB of responses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t pool_word(const uint32_t* pool,
                                              int64_t n_words, int64_t i) {
  return i < n_words ? pool[i] : 0u;
}

__global__ void gfetch_kernel(int64_t n_slots, int me, int Nb, int WW,
                              int64_t pool_words,
                              const int32_t* __restrict__ recv,
                              const int32_t* __restrict__ rows,
                              const uint32_t* __restrict__ pool,
                              int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int width = 12 + WW;
  int32_t* o = out + i * width;
  const int node = recv[2 * i];
  if (node < 0) {
    for (int j = 0; j < width; j++) o[j] = 0;
    return;
  }
  const int delta = recv[2 * i + 1];
  const int ln = min(max(node - me * Nb, 0), Nb - 1);
  const int32_t* r = rows + (int64_t)ln * 12;
  for (int j = 0; j < 12; j++) o[j] = r[j];
  if (WW == 0) return;
  const int64_t q = max((int64_t)r[0] + delta, (int64_t)0);
  const int64_t w0 = q >> 4;
  const unsigned sh = 2u * (unsigned)(q & 15);
  uint32_t lo = pool_word(pool, pool_words, w0);
  for (int w = 0; w < WW; w++) {
    const uint32_t hi = pool_word(pool, pool_words, w0 + w + 1);
    o[12 + w] = (int32_t)__funnelshift_r(lo, hi, sh);
    lo = hi;
  }
}

}  // namespace

// recv [n_slots, 2] int32 requests, rows [Nb, 12] int32, pool [pool_words]
// uint32, out [n_slots, 12 + WW] int32.  Returns a cudaError_t.
extern "C" int pa_gfetch(int device, int64_t n_slots, int me, int Nb, int WW,
                         int64_t pool_words, const int32_t* recv,
                         const int32_t* rows, const uint32_t* pool,
                         int32_t* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_slots == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_slots + threads - 1) / threads;
  gfetch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      n_slots, me, Nb, WW, pool_words, recv, rows, pool, out);
  return (int)cudaGetLastError();
}
