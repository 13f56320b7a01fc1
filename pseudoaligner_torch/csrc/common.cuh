// Shared device code of the mapping kernels (seed.cu, walk.cu): launch
// parameters, 2-bit base access, the k-mer hash and the cuckoo probe.
//
// Layouts (see pseudoaligner_torch/ops/map_kernel.py):
//   packed      [B, nw] uint32, base i of a read at bits 2*(i%16) of word i/16
//   pool        [R*8] uint32, the same packing over the padded sequence pool
//   node_row    [N, 12] int32: start(+pad), len, exts, ec, r_edge[4], l_edge[4]
//   cuckoo      [NB, 4*W] uint32 keys; empty slots hold all-ones keys
//   cuckoo_vals [NB*4*2] uint32 flat (node, offset) per slot
//   nh3         [B, P, 3] int32 (q, node, off)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pa {

// must match pseudoaligner_tpu/index/cuckoo.py
constexpr uint32_t H1_SEED = 0x13579BDFu;
constexpr uint32_t H2_SEED = 0x2468ACE0u;
constexpr int SLOTS = 4;
constexpr int MAX_W = 4;  // k <= 64

// Launch parameters.  The C entry points fill this from an int64 array in
// the order of PARAM_NAMES in ops/kernels.py.
struct Params {
  int B, nw, L, k, W, P, lazy;
  uint32_t cuckoo_mask;
  int ones_node, ones_off;
  int allowed, max_nodes, lcap, wcap, dc, ec16, cov8;
  float left_frac;
};

inline Params params_from(const int64_t* v, float left_frac) {
  Params p;
  p.B = (int)v[0];
  p.nw = (int)v[1];
  p.L = (int)v[2];
  p.k = (int)v[3];
  p.W = (2 * p.k + 31) / 32;
  p.P = p.L - p.k + 1;
  p.lazy = (int)v[4];
  p.cuckoo_mask = (uint32_t)v[5];
  p.ones_node = (int)v[6];
  p.ones_off = (int)v[7];
  p.allowed = (int)v[8];
  p.max_nodes = (int)v[9];
  p.lcap = (int)v[10];
  p.wcap = (int)v[11];
  p.dc = (int)v[12];
  p.ec16 = (int)v[13];
  p.cov8 = (int)v[14];
  p.left_frac = left_frac;
  return p;
}

__device__ __forceinline__ int base_at(const uint32_t* words, int p) {
  return (int)((words[p >> 4] >> ((p & 15) * 2)) & 3u);
}

// murmur3 fmix32, bit-identical to pseudoaligner_tpu/ops/hashing.py
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_words(const uint32_t* w, int W,
                                               uint32_t seed) {
  uint32_t h = seed;
  for (int j = 0; j < W; j++) h = mix32(h ^ w[j]);
  return h;
}

// k-mer words of the read at position p (dna.pack_kmers layout: base j of
// the k-mer at bit 2*(k-1-j), little-endian words).  Needs p + k <= L.
__device__ __forceinline__ void kmer_words(const uint32_t* read, int p, int k,
                                           int W, uint32_t* out) {
  for (int j = 0; j < W; j++) out[j] = 0u;
  for (int j = 0; j < k; j++) {
    int bitpos = 2 * (k - 1 - j);
    out[bitpos >> 5] |= (uint32_t)base_at(read, p + j) << (bitpos & 31);
  }
}

// Two-bucket, 4-slot cuckoo probe; the first key match in (bucket, slot)
// order wins.  At 2k == 32W the all-ones k-mer resolves from the launch
// parameters, since its key pattern also marks empty slots.
__device__ __forceinline__ void cuckoo_probe(const Params& p,
                                             const uint32_t* cuckoo,
                                             const uint32_t* vals,
                                             const uint32_t* w, int* node,
                                             int* off) {
  const int W = p.W;
  *node = -1;
  *off = -1;
  bool found = false;
  for (int b = 0; b < 2 && !found; b++) {
    uint32_t h = hash_words(w, W, b == 0 ? H1_SEED : H2_SEED) & p.cuckoo_mask;
    const uint32_t* row = cuckoo + (size_t)h * (SLOTS * W);
    for (int s = 0; s < SLOTS; s++) {
      bool eq = true;
      for (int j = 0; j < W; j++) eq = eq && (row[s * W + j] == w[j]);
      if (eq) {
        size_t v = ((size_t)h * SLOTS + s) * 2;
        *node = (int)vals[v];
        *off = (int)vals[v + 1];
        found = true;
        break;
      }
    }
  }
  if (2 * p.k == 32 * W) {
    bool ones = true;
    for (int j = 0; j < W; j++) ones = ones && (w[j] == 0xFFFFFFFFu);
    if (ones) {
      *node = p.ones_node;
      *off = p.ones_off;
    }
  }
}

}  // namespace pa
