// K1, the seed kernel: 2-bit packed reads -> the fused stride-3 next-hit
// table nh3 [B, G, 3], G = ceil(P/3) rows under lazy seeds (the residue-0
// positions, the only ones probed) and P otherwise (common.cuh nh3_rows).
//
// Replaces (pseudoaligner_tpu/ops/map_kernel.py) unpack_reads, all_kmers
// (ops/kmers.py), hash_kmer_jnp (ops/hashing.py), the seed probes
// cuckoo_lookup and bucket1_lookup, the MPHF probe mphf_probe and
// verified_lookup (ops/mphf_lookup.py), and _seed_tables with
// next_hit_table.  A second entry, pa_next_hit, is next_hit_table alone
// (map_kernel.py:583) on seed tables given from outside: the
// k-mer-partitioned step's routed probes (parallel/sharded_index.py).
//
// Bound on the H100: the rate of random reads.  Each probe is a chain of
// dependent random loads (one or two 32-byte cuckoo buckets and an 8-byte
// value, a 256-byte bucket1 row at k=20, or per MPHF level tried its (bit
// word, rank word) pair, then the slot's record of key words, node and
// offset in one load, under the L2 evict-first policy so the pairs stay in
// L2) from tables far larger than the 50 MB L2 at GENCODE scale, so the
// kernel needs as many probes in flight as its threads can carry, and
// every probe and sector it does not issue counts.  On the H100 the second
// cuckoo bucket read alongside the first, or two probes interleaved in one
// thread, made it slower once every thread carried a probe.  Each
// position's k-mer words are cut from the read's words with funnel shifts
// and a 2-bit reversal (common.cuh kmer_words), with W and the index kind
// as template parameters, so the k-mer and bucket rows stay in registers;
// bucket rows come in 16-byte loads, the second cuckoo bucket only after a
// miss in the first.
//
// Two forms, one kernel each:
//
// The step's form (seed_kernel, the map step's one launch a batch):
// first-hit seeding.  The walk (K2) reads row 0 of a read, whose hit q0
// starts it, and rows past q0 for its re-seeds; the rows of a read with
// no hit on row 0's grid it never reads.  A block owns R = 256 reads (up
// to a shared-memory limit at long reads), a thread a read:
//   wave 1: each read's position 0 is probed.  A read that hits is done:
//      its row 0 is (0, node, off) and no other row is written; K2
//      resolves its few re-seeds in place (walk.cu).  About 38% of the
//      cells' reads (the sense reads from a transcript) stop here;
//   wave 2: a block-wide prefix sum of the warps' ballots lists the reads
//      that missed, in order, and the block's threads take their other
//      rows' probes in strided rounds, one probe in flight a thread, each
//      hit written to its row and marked in the read's bit mask of rows in
//      shared memory;
//   scan: one thread per (missed read, row) finds the row's next hit in
//      the mask (on the row's residue grid when every position has a row)
//      and writes (q, node, off), the node and offset read back from the
//      hit's row; a read with no hit on row 0's grid gets row 0 alone,
//      (P, -1, -1), since K2 reads no other row of it (about 60% of the
//      cells' reads: the antisense half and those from nowhere).
// So rows past row 0 are written exactly for the reads whose first hit q0
// lies past position 0, and K2 tells the kinds of read apart from q0
// alone.  The block adds the probes it issued to a device counter
// (pa.seed.probes).
//
// The table form (seed_table_kernel): every probed row of every read, the
// whole table (ops/map_kernel.py seed_tables' result), for callers that
// read all of it.  A block owns a tile of R consecutive reads in shared
// memory (common.cuh SeedTile) and runs three phases over it:
//   A, probe: one thread per (read, probed position), which is one per
//      row of the table, none past len - k; R and the block width are
//      chosen so that each thread has exactly one probe (probe_tile);
//   B, scan: common.cuh's next_hit_residue runs backwards over the tile's
//      (node, off) in shared memory: one thread per (read, residue) under
//      eager seeds, one per read over its residue-0 grid under lazy ones;
//   C, store: the tile's nh3 rows, R*G*3 contiguous int32, go out in
//      coalesced 16-byte stores.
// The next_hit entry runs B and C unchanged after a coalesced load of the
// tile's seed_node / seed_off rows in place of A.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // next_hit entry, and the step form's block
constexpr int MAX_PROBE_THREADS = 512;
constexpr int TILE = 32;  // reads per block of the table form at most
constexpr size_t SMEM_MOST = 227 * 1024;  // shared memory a block may have

// The block's nb reads from read b0 on into shared memory: their packed
// words, [nb, nw + 2] with a zero word before and after each read's, and
// their lengths [nb].
__device__ __forceinline__ void load_reads(const pa::Params& p,
                                           const uint32_t* packed,
                                           const int32_t* lens, int b0,
                                           int nb, uint32_t* read,
                                           int32_t* len) {
  const int nw = p.nw, S = nw + 2;
  for (int i = threadIdx.x; i < nb * S; i += blockDim.x) {
    const int r = i / S, q = i - r * S - 1;
    read[i] = q >= 0 && q < nw ? packed[(size_t)(b0 + r) * nw + q] : 0u;
  }
  for (int r = threadIdx.x; r < nb; r += blockDim.x) len[r] = lens[b0 + r];
}

// The seed (node, off) of the k-mer at position pos of a read whose packed
// words are words[0 ..] (words[-1] readable), by the index kind MODE.
template <int W, int MODE>
__device__ __forceinline__ void probe_at(const pa::Params& p,
                                         const pa::Levels& lv,
                                         const pa::Index& ix,
                                         const uint32_t* words, int pos,
                                         int* node, int* off) {
  uint32_t w[W];
  pa::kmer_words<W>([&](int q) { return words[q]; }, pos, p.k, w);
  pa::seed_probe_as<W, MODE>(p, lv, ix, w, node, off);
}

// ---- the step form ----

// Words of a read's bit mask of rows that hit.
__host__ __device__ inline int mask_words(int G) { return (G + 31) / 32; }

// Dynamic shared memory of a step tile of R reads, in int32 units per
// read: the packed words with a zero word before and after, the length,
// a slot of the miss list and the mask.
__host__ __device__ inline size_t step_tile_bytes(int R, int G, int nw) {
  return (size_t)4 * R * (nw + 4 + mask_words(G));
}

// The first row at or after row j whose bit is set in the MW words of
// `mask`, on j's residue grid (every third row) when `every` (a row per
// position, eager seeds); -1 when there is none.
__device__ __forceinline__ int next_hit_row(const uint32_t* mask, int MW,
                                            int j, bool every) {
  for (int w = j >> 5; w < MW; w++) {
    uint32_t x = mask[w];
    if (w == j >> 5) x &= ~0u << (j & 31);
    // bit b of word w is row 32w + b, on j's grid when b = j - 2w (mod 3)
    if (every) x &= 0x49249249u << (((j - 2 * w) % 3 + 3) % 3);
    if (x) return 32 * w + __ffs(x) - 1;
  }
  return -1;
}

template <int W, int MODE>
__global__ void seed_kernel(pa::Params p,
                            const __grid_constant__ pa::Levels lv,
                            const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens, pa::Index ix,
                            int R, int32_t* __restrict__ nh3,
                            unsigned long long* __restrict__ probes) {
  extern __shared__ int4 smem4[];
  __shared__ int s_warp[32];
  __shared__ int s_nmiss, s_probes;
  const int P = p.P, k = p.k, S = p.nw + 2;
  const int G = pa::nh3_rows(P, p.lazy), MW = mask_words(G);
  uint32_t* s_read = reinterpret_cast<uint32_t*>(smem4);  // [R, S]
  int32_t* s_len = reinterpret_cast<int32_t*>(s_read + (size_t)R * S);
  int32_t* s_miss = s_len + R;  // the tile's reads that missed, in order
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_miss + R);  // [R, MW]
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  const int b0 = blockIdx.x * R, nb = min(R, p.B - b0);
  load_reads(p, packed, lens, b0, nb, s_read, s_len);
  for (int i = t; i < R * MW; i += T) s_mask[i] = 0u;
  if (t == 0) s_probes = 0;
  __syncthreads();

  auto probe = [&](int r, int pos, int* node, int* off) {
    probe_at<W, MODE>(p, lv, ix, s_read + (size_t)r * S + 1, pos, node, off);
  };
  auto row = [&](int r, int j) {
    return nh3 + ((size_t)(b0 + r) * G + j) * 3;
  };
  auto store = [](int32_t* o, int q, int node, int off) {
    o[0] = q;
    o[1] = node;
    o[2] = off;
  };

  // wave 1: position 0 of each read, a thread a read (R <= T)
  int issued = 0;
  bool miss = false;
  if (t < nb) {
    int node = -1, off = -1;
    if (s_len[t] >= k) {
      probe(t, 0, &node, &off);
      issued = 1;
    }
    if (node >= 0)
      store(row(t, 0), 0, node, off);
    else
      miss = true;
  }
  // the reads that missed, listed in order by a prefix sum of the ballots
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, miss);
  if (lane == 0) s_warp[t >> 5] = __popc(ballot);
  __syncthreads();
  int at = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < t >> 5; w++) at += s_warp[w];
  if (miss) s_miss[at] = t;
  if (t == T - 1) s_nmiss = at + (miss ? 1 : 0);
  __syncthreads();
  const int nmiss = s_nmiss;

  // wave 2: the other rows of those reads, one probe in flight a thread
  const int G1 = G - 1;
  for (int i = t; i < nmiss * G1; i += T) {
    const int m = i / G1, j = 1 + i - m * G1, r = s_miss[m];
    const int pos = p.lazy ? 3 * j : j;
    if (pos > s_len[r] - k) continue;
    int node, off;
    probe(r, pos, &node, &off);
    issued++;
    if (node >= 0) {
      atomicOr(s_mask + (size_t)m * MW + (j >> 5), 1u << (j & 31));
      store(row(r, j), pos, node, off);
    }
  }
  issued = __reduce_add_sync(0xFFFFFFFFu, issued);
  if (lane == 0 && issued) atomicAdd(&s_probes, issued);
  __syncthreads();
  if (t == 0 && s_probes && probes != nullptr)
    atomicAdd(probes, (unsigned long long)s_probes);

  // scan: each row of a missed read takes its next hit; a read with no hit
  // on row 0's grid keeps row 0 alone, (P, -1, -1), since the walk reads
  // no other row of it
  for (int i = t; i < nmiss * G; i += T) {
    const int m = i / G, j = i - m * G;
    const uint32_t* mk = s_mask + (size_t)m * MW;
    if (j > 0 && next_hit_row(mk, MW, 0, !p.lazy) < 0) continue;
    const int jn = next_hit_row(mk, MW, j, !p.lazy);
    if (jn == j) continue;  // its probe wrote it
    const int r = s_miss[m];
    if (jn < 0) {
      store(row(r, j), P, -1, -1);
    } else {  // written by another thread before the barrier
      const int32_t* h = row(r, jn);
      store(row(r, j), p.lazy ? 3 * jn : jn, __ldcg(h + 1), __ldcg(h + 2));
    }
  }
}

// ---- the table form ----

template <int W, int MODE>
__global__ void seed_table_kernel(pa::Params p,
                                  const __grid_constant__ pa::Levels lv,
                                  const uint32_t* __restrict__ packed,
                                  const int32_t* __restrict__ lens,
                                  pa::Index ix, int R,
                                  int32_t* __restrict__ nh3) {
  extern __shared__ int4 smem4[];
  const int P = p.P, k = p.k, nw = p.nw, S = nw + 2;
  const int G = pa::nh3_rows(P, p.lazy);
  pa::SeedTile t(reinterpret_cast<int32_t*>(smem4), R, P, G, nw);
  const int b0 = blockIdx.x * R, nb = min(R, p.B - b0);
  // the tile's reads, a zero word before and after each
  for (int i = threadIdx.x; i < nb * S; i += blockDim.x) {
    const int r = i / S, q = i - r * S - 1;
    t.read[i] = q >= 0 && q < nw ? packed[(size_t)(b0 + r) * nw + q] : 0u;
  }
  for (int r = threadIdx.x; r < nb; r += blockDim.x) t.len[r] = lens[b0 + r];
  __syncthreads();

  // A: one probe per (read, probed position), that is per row of the table
  for (int i = threadIdx.x; i < nb * G; i += blockDim.x) {
    const int r = i / G, j = i - r * G;
    const int pos = p.lazy ? 3 * j : j;
    int node = -1, off = -1;
    if (pos <= t.len[r] - k) {
      const uint32_t* rw = t.read + (size_t)r * S + 1;
      uint32_t w[W];
      pa::kmer_words<W>([&](int q) { return rw[q]; }, pos, k, w);
      pa::seed_probe_as<W, MODE>(p, lv, ix, w, &node, &off);
    }
    t.node[i] = node;
    t.off[i] = off;
  }
  __syncthreads();

  // B and C
  int32_t* out = nh3 + (size_t)b0 * G * 3;
  if (p.lazy)
    t.scan_and_store<3>(k, nb, out);
  else
    t.scan_and_store<1>(k, nb, out);
}

// The next_hit entry: the same table from given per-position seeds
// (seed_node / seed_off [B, P], -1 where a position has none), as the
// k-mer-partitioned step's routed probes return them.
__global__ void next_hit_kernel(int B, int P, int k, int R,
                                const int32_t* __restrict__ seed_node,
                                const int32_t* __restrict__ seed_off,
                                const int32_t* __restrict__ lens,
                                int32_t* __restrict__ nh3) {
  extern __shared__ int4 smem4[];
  pa::SeedTile t(reinterpret_cast<int32_t*>(smem4), R, P, P, 0);
  const int b0 = blockIdx.x * R, nb = min(R, B - b0);
  const size_t at = (size_t)b0 * P;
  for (int i = threadIdx.x; i < nb * P; i += blockDim.x) {
    t.node[i] = seed_node[at + i];
    t.off[i] = seed_off[at + i];
  }
  for (int r = threadIdx.x; r < nb; r += blockDim.x) t.len[r] = lens[b0 + r];
  __syncthreads();
  t.scan_and_store<1>(k, nb, nh3 + at * 3);
}

// Reads per tile of G table rows: TILE, or as many as the default shared
// memory holds; 0 when not even one read fits the most a block may have.
int tile_reads(int G, int nw) {
  const size_t one = pa::SeedTile::bytes(1, G, nw);
  if (one > SMEM_MOST) return 0;
  const int fit = (int)(pa::SMEM_DEFAULT / one);
  return fit < 1 ? 1 : (fit < TILE ? fit : TILE);
}

// The table form's tile of R reads and its T threads, for G probes (and
// table rows) a read: one probe per thread where it fits (a thread with
// two probes in a row holds its block for two dependent load chains), with
// R a multiple of 4 (so every tile's nh3 starts on 16 bytes) and
// T = R * G rounded up to a warp, the R of the fewest idle threads with
// T <= MAX_PROBE_THREADS; 14 probes per read (lazy, P = 41) give R = 16,
// T = 224, and 41 (eager) R = 12, T = 512.  Longer reads stride, 4 or
// fewer reads per tile.
void probe_tile(int G, int nw, int* R, int* T) {
  const int most = tile_reads(G, nw);
  *R = most < 4 ? most : 4;
  *T = MAX_PROBE_THREADS;
  double best = -1.0;
  for (int r = 4; r <= most; r += 4) {
    const int t = (r * G + 31) / 32 * 32;
    if (t > MAX_PROBE_THREADS) break;
    const double used = (double)(r * G) / t;
    if (used > best) {
      best = used;
      *R = r;
      *T = t;
    }
  }
}

// The table form's launch.
template <int W, int MODE>
cudaError_t launch_table(const pa::Params& p, const pa::Levels& lv,
                         const uint32_t* packed, const int32_t* lens,
                         const pa::Index& ix, int32_t* nh3,
                         cudaStream_t stream) {
  const int G = pa::nh3_rows(p.P, p.lazy);
  int R, T;
  probe_tile(G, p.nw, &R, &T);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = pa::SeedTile::bytes(R, G, p.nw);
  cudaError_t e = pa::allow_smem(seed_table_kernel<W, MODE>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + R - 1) / R;
  seed_table_kernel<W, MODE><<<blocks, T, smem, stream>>>(
      p, lv, packed, lens, ix, R, nh3);
  return cudaGetLastError();
}

// The step form's launch: a read per thread of THREADS, fewer reads a
// block where their shared memory would pass what a block may have (reads
// of thousands of bases).
template <int W, int MODE>
cudaError_t launch_step(const pa::Params& p, const pa::Levels& lv,
                        const uint32_t* packed, const int32_t* lens,
                        const pa::Index& ix, int32_t* nh3,
                        unsigned long long* probes, cudaStream_t stream) {
  const int G = pa::nh3_rows(p.P, p.lazy);
  int R = THREADS;
  while (R > 1 && step_tile_bytes(R, G, p.nw) > SMEM_MOST - 1024) R /= 2;
  const size_t smem = step_tile_bytes(R, G, p.nw);
  if (smem > SMEM_MOST - 1024) return cudaErrorInvalidValue;
  cudaError_t e = pa::allow_smem(seed_kernel<W, MODE>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + R - 1) / R;
  seed_kernel<W, MODE><<<blocks, THREADS, smem, stream>>>(
      p, lv, packed, lens, ix, R, nh3, probes);
  return cudaGetLastError();
}

// The step form under p.first_hit, else the table form.
template <int W, int MODE>
cudaError_t launch_seed(const pa::Params& p, const pa::Levels& lv,
                        const uint32_t* packed, const int32_t* lens,
                        const pa::Index& ix, int32_t* nh3,
                        unsigned long long* probes, cudaStream_t stream) {
  if (p.first_hit)
    return launch_step<W, MODE>(p, lv, packed, lens, ix, nh3, probes,
                                stream);
  return launch_table<W, MODE>(p, lv, packed, lens, ix, nh3, stream);
}

template <int W>
cudaError_t launch_seed_w(const pa::Params& p, const pa::Levels& lv,
                          const uint32_t* packed, const int32_t* lens,
                          const pa::Index& ix, int32_t* nh3,
                          unsigned long long* probes, cudaStream_t stream) {
  switch (p.mode) {
    case pa::MODE_CUCKOO:
      return launch_seed<W, pa::MODE_CUCKOO>(p, lv, packed, lens, ix, nh3,
                                             probes, stream);
    case pa::MODE_BUCKET1:
      return launch_seed<W, pa::MODE_BUCKET1>(p, lv, packed, lens, ix, nh3,
                                              probes, stream);
    case pa::MODE_MPHF:
      return launch_seed<W, pa::MODE_MPHF>(p, lv, packed, lens, ix, nh3,
                                           probes, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// first_hit: 0 for the table form, 1 for the step form; probes: null, or
// the int64 counter the step form adds the probes it issued to.
extern "C" int pa_seed_tables(const int64_t* params, const int64_t* index,
                              int device, const uint32_t* packed,
                              const int32_t* lens, int32_t* nh3,
                              int first_hit, unsigned long long* probes,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, 0.0f);
  p.first_hit = first_hit;
  if (p.B == 0) return 0;
  const pa::Levels lv = pa::levels_from(params);
  const pa::Index ix = pa::index_from(index);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)pa::with_w(p.W, [&](auto w) {
    return launch_seed_w<decltype(w)::value>(p, lv, packed, lens, ix, nh3,
                                             probes, st);
  });
}

extern "C" int pa_next_hit(int device, int B, int P, int k,
                           const int32_t* seed_node, const int32_t* seed_off,
                           const int32_t* lens, int32_t* nh3, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  const int R = tile_reads(P, 0);
  if (R == 0 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pa::SeedTile::bytes(R, P, 0);
  if ((e = pa::allow_smem(next_hit_kernel, smem)) != cudaSuccess)
    return (int)e;
  const int blocks = (B + R - 1) / R;
  next_hit_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      B, P, k, R, seed_node, seed_off, lens, nh3);
  return (int)cudaGetLastError();
}

extern "C" const char* pa_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
