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
// Bound on the H100: memory bytes.  Random reads of the index (one or two
// 32-byte cuckoo buckets and an 8-byte value, a 256-byte bucket1 row at
// k=20, or per MPHF level tried its (bit word, rank word) pair, then the
// slot's record of key words, node and offset in one load, under the L2
// evict-first policy so the pairs stay in L2) from tables far larger than
// the 50 MB L2 at GENCODE scale, and the table's 12-byte rows, one per
// probe: about 18% of the least bytes under lazy cuckoo seeds at k = 20
// and 10% at k = 64, half under the MPHF's eager probes.  Under lazy seeds
// the table holds only the probed grid: K2 probes off-grid positions in
// place, so rows for residues 1 and 2 would never be read.  What holds it
// back is the rate of random 32-byte reads, well below the streaming rate:
// each probe is a chain of dependent random loads (two or three for
// cuckoo, one per level tried and one record for the MPHF), so the kernel
// needs as many probes in flight as its threads can carry, and every
// sector it does not read counts.  On the H100 the second cuckoo bucket read
// alongside the first, or two probes interleaved in one thread, made it
// slower once every thread carried a probe.
//
// The design: a block owns a tile of R consecutive reads in shared memory
// (common.cuh SeedTile) and runs three phases over it.
//   A, probe: the tile's packed words are loaded once into shared memory;
//      then one thread per (read, probed position), which is one per row of
//      the table: every residue-0 position under lazy seeds (14 per read at
//      L = 60, k = 20), every position otherwise, none past len - k.  R and
//      the block width are chosen so that each thread has exactly one probe
//      (probe_tile: R = 16 and 224 threads lazy, R = 12 and 512 threads
//      eager): a thread with a second probe in a row holds its whole block
//      for a second chain of loads (slower on the H100 with 32-read tiles
//      of 256 threads).  A batch has 0.9 M (lazy) to 2.7 M (eager)
//      independent probes to spread over the card, against one serial
//      chain of up to 14 probes per thread before.
//      Each position's k-mer words are cut from the read's words with
//      funnel shifts and a 2-bit reversal (common.cuh kmer_words), with
//      W and the index kind as template parameters, so the k-mer and
//      bucket rows stay in registers; bucket rows come in 16-byte loads,
//      the second cuckoo bucket only after a miss in the first.
//   B, scan: common.cuh's next_hit_residue runs backwards over the tile's
//      (node, off) in shared memory: one thread per (read, residue) under
//      eager seeds, one per read over its residue-0 grid under lazy ones.
//   C, store: the tile's nh3 rows, R*G*3 contiguous int32, go out in
//      coalesced 16-byte stores (before: 12-byte triples 36 bytes apart
//      within a thread and a row apart between threads).
// The next_hit entry runs B and C unchanged after a coalesced load of the
// tile's seed_node / seed_off rows in place of A.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // next_hit entry; the probing entry sizes its own
constexpr int MAX_PROBE_THREADS = 512;
constexpr int TILE = 32;  // reads per block at most

template <int W, int MODE>
__global__ void seed_kernel(pa::Params p,
                            const __grid_constant__ pa::Levels lv,
                            const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens, pa::Index ix,
                            int R, int32_t* __restrict__ nh3) {
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
  if (one > 227 * 1024) return 0;
  const int fit = (int)(pa::SMEM_DEFAULT / one);
  return fit < 1 ? 1 : (fit < TILE ? fit : TILE);
}

// The probing entry's tile of R reads and its T threads, for G probes (and
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

template <int W, int MODE>
cudaError_t launch_seed(const pa::Params& p, const pa::Levels& lv,
                        const uint32_t* packed, const int32_t* lens,
                        const pa::Index& ix, int32_t* nh3,
                        cudaStream_t stream) {
  const int G = pa::nh3_rows(p.P, p.lazy);
  int R, T;
  probe_tile(G, p.nw, &R, &T);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = pa::SeedTile::bytes(R, G, p.nw);
  cudaError_t e = pa::allow_smem(seed_kernel<W, MODE>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + R - 1) / R;
  seed_kernel<W, MODE><<<blocks, T, smem, stream>>>(p, lv, packed, lens, ix,
                                                    R, nh3);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_seed_w(const pa::Params& p, const pa::Levels& lv,
                          const uint32_t* packed, const int32_t* lens,
                          const pa::Index& ix, int32_t* nh3,
                          cudaStream_t stream) {
  switch (p.mode) {
    case pa::MODE_CUCKOO:
      return launch_seed<W, pa::MODE_CUCKOO>(p, lv, packed, lens, ix, nh3,
                                             stream);
    case pa::MODE_BUCKET1:
      return launch_seed<W, pa::MODE_BUCKET1>(p, lv, packed, lens, ix, nh3,
                                              stream);
    case pa::MODE_MPHF:
      return launch_seed<W, pa::MODE_MPHF>(p, lv, packed, lens, ix, nh3,
                                           stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pa_seed_tables(const int64_t* params, const int64_t* index,
                              int device, const uint32_t* packed,
                              const int32_t* lens, int32_t* nh3,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const pa::Levels lv = pa::levels_from(params);
  const pa::Index ix = pa::index_from(index);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)pa::with_w(p.W, [&](auto w) {
    return launch_seed_w<decltype(w)::value>(p, lv, packed, lens, ix, nh3, st);
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
