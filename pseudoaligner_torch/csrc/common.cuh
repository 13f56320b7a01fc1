// Shared device code of the mapping kernels (seed.cu, walk.cu, stats.cu,
// route.cu, mphfdyn.cu, gwalk.cu): launch parameters, 2-bit base access,
// the k-mer hash, the three seed index probes (cuckoo, bucket1, MPHF with a
// stored-key verify), the backward pass of the next-hit table, and the
// walk's segment compare and output encoding.
//
// Layouts (see pseudoaligner_torch/ops/map_kernel.py):
//   packed      [B, nw] uint32, base i of a read at bits 2*(i%16) of word i/16
//   pool        [R*8] uint32, the same packing over the padded sequence pool
//   node_row    [N, 12] int32: start(+pad), len, exts, ec, r_edge[4], l_edge[4]
//   cuckoo      cuckoo mode:  [NB, 4*W] uint32 keys; empty slots hold
//                             all-ones keys
//               bucket1 mode: [NB, 16*(W+2)] uint32 rows of (key words, node,
//                             offset) slots; empty slots have node EMPTY
//   cuckoo_vals [NB*4*2] uint32 flat (node, offset) per cuckoo slot
//   mphf_bits   [bw] uint32 level bit words, mphf_ranks [bw] set bits of the
//               level before each word; kmer_keys [nk, W] uint32,
//               kmer_node / kmer_offset [nk] int32, all in MPHF slot order
//   nh3         [B, P, 3] int32 (q, node, off)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pa {

// must match pseudoaligner_torch/index/cuckoo.py and index/mphf.py
constexpr uint32_t H1_SEED = 0x13579BDFu;
constexpr uint32_t H2_SEED = 0x2468ACE0u;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr int SLOTS = 4;
constexpr int B1_SLOTS = 16;
constexpr int MAX_W = 4;  // k <= 64
constexpr int MAX_LEVELS = 48;

// seed index kinds, in the order of SEED_INDEXES in ops/map_kernel.py
constexpr int MODE_CUCKOO = 0;
constexpr int MODE_BUCKET1 = 1;
constexpr int MODE_MPHF = 2;

// Launch parameters.  The C entry points fill this from an int64 array in
// the order of PARAM_NAMES in ops/kernels.py.
struct Params {
  int B, nw, L, k, W, P, lazy;
  uint32_t cuckoo_mask;
  int ones_node, ones_off;
  int allowed, max_nodes, lcap, wcap, dc, ec16, cov8;
  int mode;
  uint32_t bucket_seed;
  int n_levels;
  float left_frac;
};

// The MPHF's per-level metadata, passed to the kernels by value (768 B of
// kernel parameters).  It follows the fixed parameters in the int64 array:
// n_levels seeds, then masks, word offsets and key offsets.
struct Levels {
  uint32_t seed[MAX_LEVELS], mask[MAX_LEVELS], word_off[MAX_LEVELS],
      key_off[MAX_LEVELS];
};

constexpr int N_FIXED = 18;  // entries of PARAM_NAMES

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
  p.mode = (int)v[15];
  p.bucket_seed = (uint32_t)v[16];
  p.n_levels = v[17] < MAX_LEVELS ? (int)v[17] : MAX_LEVELS;
  p.left_frac = left_frac;
  return p;
}

inline Levels levels_from(const int64_t* v) {
  Levels lv = {};
  const int n = (int)v[17];  // the array holds n of each column
  const int64_t* a = v + N_FIXED;
  for (int i = 0; i < n && i < MAX_LEVELS; i++) {
    lv.seed[i] = (uint32_t)a[i];
    lv.mask[i] = (uint32_t)a[n + i];
    lv.word_off[i] = (uint32_t)a[2 * n + i];
    lv.key_off[i] = (uint32_t)a[3 * n + i];
  }
  return lv;
}

// The seed index's device arrays; the C entry points fill it from a host
// array of pointers in the order of INDEX_ARRAYS in ops/kernels.py.  The
// arrays a mode does not read may be empty.
struct Index {
  const uint32_t* cuckoo;
  const uint32_t* vals;
  const uint32_t* bits;
  const uint32_t* ranks;
  const uint32_t* keys;
  const int32_t* knode;
  const int32_t* koff;
};

inline Index index_from(const int64_t* ptrs) {
  Index ix;
  ix.cuckoo = reinterpret_cast<const uint32_t*>(ptrs[0]);
  ix.vals = reinterpret_cast<const uint32_t*>(ptrs[1]);
  ix.bits = reinterpret_cast<const uint32_t*>(ptrs[2]);
  ix.ranks = reinterpret_cast<const uint32_t*>(ptrs[3]);
  ix.keys = reinterpret_cast<const uint32_t*>(ptrs[4]);
  ix.knode = reinterpret_cast<const int32_t*>(ptrs[5]);
  ix.koff = reinterpret_cast<const int32_t*>(ptrs[6]);
  return ix;
}

__device__ __forceinline__ int base_at(const uint32_t* words, int p) {
  return (int)((words[p >> 4] >> ((p & 15) * 2)) & 3u);
}

// murmur3 fmix32, bit-identical to pseudoaligner_torch/ops/hashing.py
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

// Single-hash probe of one B1_SLOTS-slot row (hash seed p.bucket_seed, which
// the build may have re-salted); the first slot whose node is not EMPTY and
// whose key matches wins.  Empty slots hold zero keys, so without the node
// check the all-A k-mer would match them.  The all-ones k-mer is an
// ordinary key here.
__device__ __forceinline__ void bucket1_probe(const Params& p,
                                              const uint32_t* rows,
                                              const uint32_t* w, int* node,
                                              int* off) {
  const int W = p.W, S = W + 2;
  const uint32_t h = hash_words(w, W, p.bucket_seed) & p.cuckoo_mask;
  const uint32_t* row = rows + (size_t)h * (B1_SLOTS * S);
  *node = -1;
  *off = -1;
  for (int s = 0; s < B1_SLOTS; s++) {
    const uint32_t* slot = row + s * S;
    if (slot[W] == EMPTY) continue;
    bool eq = true;
    for (int j = 0; j < W; j++) eq = eq && (slot[j] == w[j]);
    if (eq) {
      *node = (int)slot[W];
      *off = (int)slot[W + 1];
      return;
    }
  }
}

// BBHash level probe: per level, hash with the level's seed, mask, read the
// bit word and its rank word; the first level whose bit is set gives the
// slot key_off + rank + popcount(bits below), in 32-bit arithmetic as the
// reference's int32.  -1 when no level's bit is set.  An alien k-mer can
// land on a set bit: the caller verifies the stored key.
__device__ __forceinline__ int mphf_slot(const Params& p, const Levels& lv,
                                         const uint32_t* bits,
                                         const uint32_t* ranks,
                                         const uint32_t* w) {
  for (int l = 0; l < p.n_levels; l++) {
    const uint32_t h = hash_words(w, p.W, lv.seed[l]) & lv.mask[l];
    const uint32_t wi = lv.word_off[l] + (h >> 5);
    const uint32_t word = bits[wi];
    const uint32_t bp = h & 31u;
    if ((word >> bp) & 1u) {
      const uint32_t below = word & ((1u << bp) - 1u);
      return (int)(lv.key_off[l] + ranks[wi] + (uint32_t)__popc(below));
    }
  }
  return -1;
}

// Whether the key stored at MPHF slot `slot` equals the query words.
__device__ __forceinline__ bool key_at_slot_equals(const uint32_t* keys,
                                                   int slot, int W,
                                                   const uint32_t* w) {
  const uint32_t* stored = keys + (size_t)slot * W;
  bool eq = true;
  for (int j = 0; j < W; j++) eq = eq && (stored[j] == w[j]);
  return eq;
}

// MPHF probe plus the stored-key verify: (node, offset) at the slot when the
// key there equals the query, else (-1, -1).
__device__ __forceinline__ void mphf_verified_probe(const Params& p,
                                                    const Levels& lv,
                                                    const Index& ix,
                                                    const uint32_t* w,
                                                    int* node, int* off) {
  const int slot = mphf_slot(p, lv, ix.bits, ix.ranks, w);
  if (slot >= 0 && key_at_slot_equals(ix.keys, slot, p.W, w)) {
    *node = ix.knode[slot];
    *off = ix.koff[slot];
  } else {
    *node = -1;
    *off = -1;
  }
}

// The seed probe of the index kind p.mode (ops/map_kernel.py seed_probe).
__device__ __forceinline__ void seed_probe(const Params& p, const Levels& lv,
                                           const Index& ix,
                                           const uint32_t* w, int* node,
                                           int* off) {
  if (p.mode == MODE_BUCKET1)
    bucket1_probe(p, ix.cuckoo, w, node, off);
  else if (p.mode == MODE_MPHF)
    mphf_verified_probe(p, lv, ix, w, node, off);
  else
    cuckoo_probe(p, ix.cuckoo, ix.vals, w, node, off);
}

// One (read, residue r) row of the stride-3 next-hit table (ops/map_kernel.py
// next_hit_table): walks the positions r, r+3, ... backwards and writes
// nh3_row[pos] = (q, node, off) of the nearest seed q >= pos on the grid, or
// (P, -1, -1) when there is none.  seed(pos, &node, &off) is asked only for
// positions up to last_valid (len - k), and for none when `ask` is false; a
// seed counts when its node is >= 0.  K1's seed pass (which probes) and its
// next_hit entry (which reads routed seed tables) both call this, so the
// table has one definition.
template <class Seed>
__device__ __forceinline__ void next_hit_residue(int P, int r, int last_valid,
                                                 bool ask, Seed seed,
                                                 int32_t* nh3_row) {
  int q = P, qn = -1, qo = -1;
  const int top = r + 3 * ((P - 1 - r) / 3);
  for (int pos = top; pos >= r; pos -= 3) {
    if (ask && pos <= last_valid) {
      int node, off;
      seed(pos, &node, &off);
      if (node >= 0) {
        q = pos;
        qn = node;
        qo = off;
      }
    }
    int32_t* out = nh3_row + (size_t)pos * 3;
    out[0] = q;
    out[1] = qn;
    out[2] = qo;
  }
}

// One segment compare of the walk under the per-segment SNP budget: bases
// i = 0, 1, ... < maxm, where ref(i) and read(i) give compared base i of
// the reference and of the read.  The base that breaks the budget counts
// as a mismatch (*seen) but not as matched; returns whether it was broken.
// The reference side is the global pool in K2 (walk.cu) and a window a
// routed fetch returned in K10 (gwalk.cu), so both walks share this loop.
template <class Ref, class Read>
__device__ __forceinline__ bool segment_compare(int maxm, int allowed, Ref ref,
                                                Read read, int* matched,
                                                int* seen) {
  int m = 0, s = 0;
  bool prem = false;
  for (int i = 0; i < maxm; i++) {
    if (ref(i) != read(i)) {
      if (++s > allowed) {
        prem = true;
        break;
      }
    }
    m++;
  }
  *matched = m;
  *seen = s;
  return prem;
}

// One read's outputs from its walk (K2 and K10): n_nodes, mapped and the
// mismatches; then the full node list (p.dc == 0) or the compact output:
// coverage (uint8 when p.cov8), the run-length EC ids of the push buffer
// mybuf [max_nodes, 2] in p.dc slots, -2 in the last when more runs were
// visited, -3 when `capped` (int16 when p.ec16).
__device__ __forceinline__ void encode_output(
    const Params& p, int b, const int32_t* mybuf, int nn, int cov, int mm,
    bool capped, uint8_t* mapped_out, void* cov_out, int32_t* mm_out,
    int32_t* nn_out, void* dist_out, int32_t* nodes_out) {
  const int M = p.max_nodes;
  nn_out[b] = nn;
  mapped_out[b] = nn > 0;
  mm_out[b] = mm;
  if (p.dc == 0) {
    reinterpret_cast<int32_t*>(cov_out)[b] = cov;
    for (int i = 0; i < M; i++) nodes_out[(size_t)b * M + i] = mybuf[2 * i];
    return;
  }
  if (p.cov8)
    reinterpret_cast<uint8_t*>(cov_out)[b] = (uint8_t)cov;
  else
    reinterpret_cast<int32_t*>(cov_out)[b] = cov;
  // run-length compaction of the stored EC ids in push order
  int slots[64];
  const int dc = p.dc;
  for (int i = 0; i < dc; i++) slots[i] = -1;
  int runs = 0, prev = -1;
  for (int i = 0; i < M; i++) {
    const int v = mybuf[2 * i + 1];
    if (v >= 0 && v != prev) {
      if (runs < dc) slots[runs] = v;
      runs++;
    }
    prev = v;
  }
  if (runs > dc) slots[dc - 1] = -2;
  if (capped) slots[dc - 1] = -3;
  if (p.ec16) {
    int16_t* o = reinterpret_cast<int16_t*>(dist_out) + (size_t)b * dc;
    for (int i = 0; i < dc; i++) o[i] = (int16_t)slots[i];
  } else {
    int32_t* o = reinterpret_cast<int32_t*>(dist_out) + (size_t)b * dc;
    for (int i = 0; i < dc; i++) o[i] = slots[i];
  }
}

}  // namespace pa
