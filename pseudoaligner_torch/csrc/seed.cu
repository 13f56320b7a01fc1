// K1, the seed kernel: 2-bit packed reads -> the fused stride-3 next-hit
// table nh3 [B, P, 3].
//
// Replaces (pseudoaligner_tpu/ops/map_kernel.py) unpack_reads, all_kmers
// (ops/kmers.py), hash_kmer_jnp (ops/hashing.py), the seed probes
// cuckoo_lookup and bucket1_lookup, the MPHF probe mphf_probe and
// verified_lookup (ops/mphf_lookup.py), and _seed_tables with
// next_hit_table.  A second entry, pa_next_hit, is next_hit_table alone
// (map_kernel.py:583) on seed tables given from outside: the
// k-mer-partitioned step's routed probes (parallel/sharded_index.py).
//
// One thread per (read, residue r in {0,1,2}).  It walks the positions
// p = r, r+3, ... backwards, rolls each probed position's k-mer words
// straight from the packed read, probes the seed index of p.mode (cuckoo,
// bucket1 or the verified MPHF, common.cuh seed_probe), and writes
// nh3[b, p] = the nearest valid hit q >= p on the residue grid, or
// (P, -1, -1) when there is none (common.cuh next_hit_residue, shared with
// the next_hit entry).  A hit is valid when node >= 0 and
// p <= len - k; positions past len - k are not probed at all.  With lazy
// seeds (cuckoo and bucket1 only) only residue 0 is probed and residues 1
// and 2 stay (P, -1, -1).
//
// Bound on the H100: memory bytes.  Random reads of the index (two 32-byte
// cuckoo buckets, one 256-byte bucket1 row at k=20, or per MPHF level a bit
// word and a rank word plus the stored key and value at the slot) from a
// table far larger than the 50 MB L2 at GENCODE scale, and the 12*P-byte
// nh3 row write per read.  This first version keeps the scalar per-thread probe;
// warp-cooperative probing and coalesced nh3 stores are later work.

#include "common.cuh"

namespace {

__global__ void seed_kernel(pa::Params p, const __grid_constant__ pa::Levels lv,
                            const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens, pa::Index ix,
                            int32_t* __restrict__ nh3) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)p.B * 3) return;
  int b = (int)(t / 3);
  int r = (int)(t % 3);
  if (r >= p.P) return;
  const uint32_t* read = packed + (size_t)b * p.nw;
  uint32_t w[pa::MAX_W];
  pa::next_hit_residue(
      p.P, r, lens[b] - p.k, !p.lazy || r == 0,
      [&](int pos, int* node, int* off) {
        pa::kmer_words(read, pos, p.k, p.W, w);
        pa::seed_probe(p, lv, ix, w, node, off);
      },
      nh3 + (size_t)b * p.P * 3);
}

// The next_hit entry: the same table from given per-position seeds
// (seed_node / seed_off [B, P], -1 where a position has none), as the
// k-mer-partitioned step's routed probes return them.
__global__ void next_hit_kernel(int B, int P, int k,
                                const int32_t* __restrict__ seed_node,
                                const int32_t* __restrict__ seed_off,
                                const int32_t* __restrict__ lens,
                                int32_t* __restrict__ nh3) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * 3) return;
  int b = (int)(t / 3);
  int r = (int)(t % 3);
  if (r >= P) return;
  const int32_t* sn = seed_node + (size_t)b * P;
  const int32_t* so = seed_off + (size_t)b * P;
  pa::next_hit_residue(
      P, r, lens[b] - k, true,
      [&](int pos, int* node, int* off) {
        *node = sn[pos];
        *off = so[pos];
      },
      nh3 + (size_t)b * P * 3);
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
  const int threads = 128;
  int64_t n = (int64_t)p.B * 3;
  int blocks = (int)((n + threads - 1) / threads);
  seed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, lv, packed, lens, pa::index_from(index), nh3);
  return (int)cudaGetLastError();
}

extern "C" int pa_next_hit(int device, int B, int P, int k,
                           const int32_t* seed_node, const int32_t* seed_off,
                           const int32_t* lens, int32_t* nh3, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  const int threads = 128;
  int64_t n = (int64_t)B * 3;
  int blocks = (int)((n + threads - 1) / threads);
  next_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      B, P, k, seed_node, seed_off, lens, nh3);
  return (int)cudaGetLastError();
}

extern "C" const char* pa_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
