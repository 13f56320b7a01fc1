// K1, the seed kernel: 2-bit packed reads -> the fused stride-3 next-hit
// table nh3 [B, P, 3].
//
// Replaces (pseudoaligner_tpu/ops/map_kernel.py) unpack_reads, all_kmers
// (ops/kmers.py), hash_kmer_jnp (ops/hashing.py), cuckoo_lookup and
// _seed_tables with next_hit_table.
//
// One thread per (read, residue r in {0,1,2}).  It walks the positions
// p = r, r+3, ... backwards, rolls each probed position's k-mer words
// straight from the packed read, probes the cuckoo table, and writes
// nh3[b, p] = the nearest valid hit q >= p on the residue grid, or
// (P, -1, -1) when there is none.  A hit is valid when node >= 0 and
// p <= len - k; positions past len - k are not probed at all.  With lazy
// seeds only residue 0 is probed and residues 1 and 2 stay (P, -1, -1).
//
// Bound on the H100: random 32-byte cuckoo bucket reads (two per probe,
// from a table far larger than the 50 MB L2 at GENCODE scale) and the
// 12*P-byte nh3 row write per read.  This first version keeps the scalar
// per-thread probe; warp-cooperative probing and coalesced nh3 stores are
// later work.

#include "common.cuh"

namespace {

__global__ void seed_kernel(pa::Params p, const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens,
                            const uint32_t* __restrict__ cuckoo,
                            const uint32_t* __restrict__ vals,
                            int32_t* __restrict__ nh3) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)p.B * 3) return;
  int b = (int)(t / 3);
  int r = (int)(t % 3);
  if (r >= p.P) return;
  const uint32_t* read = packed + (size_t)b * p.nw;
  int last_valid = lens[b] - p.k;
  bool probe_residue = !p.lazy || r == 0;
  int q = p.P, qn = -1, qo = -1;
  uint32_t w[pa::MAX_W];
  int top = r + 3 * ((p.P - 1 - r) / 3);
  for (int pos = top; pos >= r; pos -= 3) {
    if (probe_residue && pos <= last_valid) {
      int node, off;
      pa::kmer_words(read, pos, p.k, p.W, w);
      pa::cuckoo_probe(p, cuckoo, vals, w, &node, &off);
      if (node >= 0) {
        q = pos;
        qn = node;
        qo = off;
      }
    }
    int32_t* out = nh3 + ((size_t)b * p.P + pos) * 3;
    out[0] = q;
    out[1] = qn;
    out[2] = qo;
  }
}

}  // namespace

extern "C" int pa_seed_tables(const int64_t* params, int device,
                              const uint32_t* packed, const int32_t* lens,
                              const uint32_t* cuckoo, const uint32_t* vals,
                              int32_t* nh3, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const int threads = 128;
  int64_t n = (int64_t)p.B * 3;
  int blocks = (int)((n + threads - 1) / threads);
  seed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, packed, lens, cuckoo, vals, nh3);
  return (int)cudaGetLastError();
}

extern "C" const char* pa_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
