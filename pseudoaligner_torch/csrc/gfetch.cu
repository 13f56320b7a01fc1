// K11, the owner side of the graph-sharded walk's routed fetch: serve the
// (node, delta) requests every shard sent this shard from its block of the
// graph.
//
// Replaces pseudoaligner_tpu/parallel/sharded_index.py::_routed_fetch_factory
// (:151-202), the gather of the node row from the local block and the
// window extraction from the local pool slice between its two all_to_alls.
//
// What it computes, per request slot i of recv [S*B, 2]: a slot with node
// < 0 is "no request" (graph_walk.py writes it for lanes that fetch
// nothing) and is answered with zeros.  Otherwise the local row is
// clip(node - me*Nb, 0, Nb-1); the response is its 12 int32 and, when
// WW > 0, the WW words of 2-bit bases ascending from q = max(row[0] +
// delta, 0) in the block's flat pool: base q + t at bits 2*(t & 15) of
// word t >> 4, the packing pa::base_at reads.  Each word is one funnel
// shift of two neighbouring pool words; words past the pool's end read as
// zero (every window of a real request lies inside the block's padded
// pool).  The response, out [S*B, 12 + WW], is int32 throughout: gloo
// refuses uint32, so the window words ride as their bit patterns.
//
// Bound on the H100: bytes.  At S = 1 and B = 65,536 a windowed fetch
// reads 0.5 MB of requests and writes 4.2 MB of responses, most of them
// the zeros of "no request" slots once the walk's first iteration is done.
// So the design is about the stores: one thread per 16 bytes of out, so
// that a warp's store instruction writes 512 contiguous bytes.  Where the
// response width is a multiple of 4 words (the rows-only fetch, 12, and
// the serving shape's windowed one, 16 at L = 60) a slot's 16-byte pieces
// line up with it: a thread stores one of the row's three int4, read as
// one 16-byte load (rows are 48 bytes), or four window words from five
// pool words.  Other widths (WW = 6 at L = 96, 19 at L = 300) give each
// thread four consecutive words of the flat out, which may end one slot
// and start the next, computed word by word and stored as one int4 (the
// last thread stores the words left over from the last whole int4).  The
// requests are read and the responses written under the L2 evict-first
// policy (common.cuh): the block's node rows (2.3 MB at S = 1) and pool
// stay resident in L2 for the random reads of the next fetch.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Block {
  int me, Nb;
  int64_t pool_words;
  const int32_t* rows;  // [Nb, 12]
  const uint32_t* pool;

  __device__ __forceinline__ uint32_t pool_word(int64_t i) const {
    return i < pool_words ? __ldg(pool + i) : 0u;
  }
};

// One slot's request, resolved against the block: whether it is one, its
// local row, and where its window starts (word w0, bit shift sh).
struct Slot {
  bool on;
  int ln;
  int64_t w0;
  unsigned sh;
};

__device__ __forceinline__ Slot slot_at(const Block& k, const int32_t* recv,
                                        int i, bool window) {
  uint32_t r[2];
  pa::load_words_evict_first<2>(
      reinterpret_cast<const uint32_t*>(recv) + 2 * (int64_t)i, r);
  Slot s{(int)r[0] >= 0, 0, 0, 0u};
  if (s.on) {
    s.ln = min(max((int)r[0] - k.me * k.Nb, 0), k.Nb - 1);
    if (window) {
      const int64_t q =
          max((int64_t)__ldg(k.rows + (int64_t)s.ln * 12) + (int)r[1],
              (int64_t)0);
      s.w0 = q >> 4;
      s.sh = 2u * (unsigned)(q & 15);
    }
  }
  return s;
}

// Word c of the slot's response.
__device__ __forceinline__ int32_t word_of(const Block& k, const Slot& s,
                                           int c) {
  if (!s.on) return 0;
  if (c < 12) return __ldg(k.rows + (int64_t)s.ln * 12 + c);
  const int64_t w = s.w0 + (c - 12);
  return (int32_t)__funnelshift_r(k.pool_word(w), k.pool_word(w + 1), s.sh);
}

// width % 4 == 0: thread t writes int4 `part` of slot t / Q, Q = width / 4.
__global__ void __launch_bounds__(THREADS)
    gfetch_quads_kernel(int n_quads, int Q, Block k,
                        const int32_t* __restrict__ recv,
                        int4* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_quads) return;
  const int i = t / Q, part = t - i * Q;
  const Slot s = slot_at(k, recv, i, part >= 3);
  int4 v = make_int4(0, 0, 0, 0);
  if (s.on) {
    if (part < 3) {
      v = __ldg(reinterpret_cast<const int4*>(k.rows) + (int64_t)s.ln * 3 +
                part);
    } else {
      const int64_t w = s.w0 + 4 * (part - 3);
      uint32_t a[5];
#pragma unroll
      for (int e = 0; e < 5; e++) a[e] = k.pool_word(w + e);
      v.x = (int32_t)__funnelshift_r(a[0], a[1], s.sh);
      v.y = (int32_t)__funnelshift_r(a[1], a[2], s.sh);
      v.z = (int32_t)__funnelshift_r(a[2], a[3], s.sh);
      v.w = (int32_t)__funnelshift_r(a[3], a[4], s.sh);
    }
  }
  pa::store_evict_first(out + t, v);
}

// Any width: thread t writes words 4t .. 4t+3 of the flat out [n_words].
__global__ void __launch_bounds__(THREADS)
    gfetch_words_kernel(int n_words, int width, Block k,
                        const int32_t* __restrict__ recv,
                        int32_t* __restrict__ out) {
  const int w = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (w >= n_words) return;
  int i = w / width, c = w - i * width;
  Slot s = slot_at(k, recv, i, true);  // width > 12 here
  int32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; e++) {
    if (c == width) {
      c = 0;
      i++;
      if (w + e < n_words) s = slot_at(k, recv, i, true);
    }
    v[e] = w + e < n_words ? word_of(k, s, c) : 0;
    c++;
  }
  if (w + 4 <= n_words) {
    pa::store_evict_first(reinterpret_cast<int4*>(out + w),
                          make_int4(v[0], v[1], v[2], v[3]));
  } else {
    for (int e = 0; w + e < n_words; e++) out[w + e] = v[e];
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

constexpr int64_t MAX_WORDS = 0x7FFFFFFF;  // the kernels index out in int

}  // namespace

// recv [n_slots, 2] int32 requests, rows [Nb, 12] int32, pool [pool_words]
// uint32, out [n_slots, 12 + WW] int32; rows and out on 16 bytes, recv on
// 8 (the wrapper checks).  Returns a cudaError_t.
extern "C" int pa_gfetch(int device, int64_t n_slots, int me, int Nb, int WW,
                         int64_t pool_words, const int32_t* recv,
                         const int32_t* rows, const uint32_t* pool,
                         int32_t* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_slots == 0) return 0;
  const Block k{me, Nb, pool_words, rows, pool};
  const int width = 12 + WW;
  const int64_t n_words = n_slots * width;
  if (n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (width % 4 == 0) {
    const int n = (int)(n_words / 4);
    gfetch_quads_kernel<<<blocks_for(n), THREADS, 0, st>>>(
        n, width / 4, k, recv, reinterpret_cast<int4*>(out));
  } else {
    gfetch_words_kernel<<<blocks_for((n_words + 3) / 4), THREADS, 0, st>>>(
        (int)n_words, width, k, recv, out);
  }
  return (int)cudaGetLastError();
}
