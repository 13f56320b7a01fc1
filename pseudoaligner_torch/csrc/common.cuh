// Shared device code of the mapping kernels (seed.cu, walk.cu, stats.cu,
// route.cu, mphfdyn.cu, gwalk.cu, gfetch.cu): launch parameters, 2-bit
// base access, the k-mer hash, k-mer words cut from packed words, the
// three seed index probes (cuckoo, bucket1, MPHF with a stored-key
// verify), L2 evict-first loads and stores, the backward pass of the
// next-hit table with the tile store around it, and the walk's word-wise
// segment compare and output encoding.
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
//   mphf_pairs  [bw, 2] uint32: each MPHF level word's bits and the set bits
//               of the level before it, side by side (one 8-byte load)
//   records     [nk, RECORD_WORDS<W>] uint32 in MPHF slot order: each
//               slot's W key words, node, offset, zero padding (one 16-
//               or 32-byte load); K8's shard-local records have the same
//               layout
//   nh3         [B, G, 3] int32 (q, node, off): G = nh3_rows(P, lazy) rows,
//               row j for position j under eager seeds and 3j under lazy
//               ones (the residue-0 grid K1 probes)
//
// What bounds the kernels that use this file, and what the shared pieces do
// about it: the seed probes are chains of dependent random loads into
// tables far larger than L2, so they are latency-bound per thread and
// bandwidth-bound over the card once enough probes are in flight.  Every
// kernel that probes or hashes a k-mer (K1, K2's lazy seek, K3, K7, K8)
// instantiates the helpers for a compile-time W (a switch on W at launch),
// so the k-mer and the bucket rows stay in registers and each bucket row
// is read with 16-byte loads; the k-mer words come from the read's packed
// words with funnel shifts and a 2-bit reversal, not base by base.  The
// walk's compare runs 16 bases per step (an XOR of two 32-bit windows
// folded to one mismatch bit per base, popcount, and the breaking mismatch
// found by clearing low bits), so a segment costs at most ceil(maxm / 16)
// steps of four word loads.
#pragma once

#include <cstdint>
#include <type_traits>
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
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opt-in

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
  // nh3 is K1's step form (seed.cu), set by the seed and walk entries from
  // their call path, not from the parameter array
  int first_hit;
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
  p.first_hit = 0;
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
  const uint2* pairs;  // (bit word, rank word) per MPHF level word
  const uint32_t* records;  // (key words, node, offset) per MPHF slot
};

inline Index index_from(const int64_t* ptrs) {
  Index ix;
  ix.cuckoo = reinterpret_cast<const uint32_t*>(ptrs[0]);
  ix.vals = reinterpret_cast<const uint32_t*>(ptrs[1]);
  ix.pairs = reinterpret_cast<const uint2*>(ptrs[2]);
  ix.records = reinterpret_cast<const uint32_t*>(ptrs[3]);
  return ix;
}

// Opt a kernel in to `bytes` of dynamic shared memory where that is more
// than the default allows.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// f(std::integral_constant<int, W>()) for the key width W = 1..4, so a
// launch picks the kernel instantiated for it; an invalid W is
// cudaErrorInvalidValue.
template <class F>
inline cudaError_t with_w(int W, F f) {
  switch (W) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
  }
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ int base_at(const uint32_t* words, int p) {
  return (int)((words[p >> 4] >> ((p & 15) * 2)) & 3u);
}

// Base p of a packed sequence whose word q is word(q).
template <class Word>
__device__ __forceinline__ int base_of(Word word, int p) {
  return (int)((word(p >> 4) >> ((p & 15) * 2)) & 3u);
}

// The 16 bases p .. p+15 of a packed sequence whose word q is word(q), as
// one 32-bit word (base p at bits 0-1).  Reads words floor(p/16) and the
// one after it; p may be negative.
template <class Word>
__device__ __forceinline__ uint32_t window16(Word word, int p) {
  const int bit = 2 * p;
  const int q = bit >> 5;  // floor, also below 0
  return __funnelshift_r(word(q), word(q + 1), (unsigned)(bit & 31));
}

// The 2-bit digits of x in reverse order.
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
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

// The hash of W key words.
template <int W>
__device__ __forceinline__ uint32_t hash_words(const uint32_t (&w)[W],
                                               uint32_t seed) {
  uint32_t h = seed;
#pragma unroll
  for (int j = 0; j < W; j++) h = mix32(h ^ w[j]);
  return h;
}

// Word q of the n packed words at w, 0 outside them: the word source of a
// sequence in global memory whose neighbours may be asked for (kmer_words
// and segment_compare read one word either side of what they use).
__device__ __forceinline__ auto window_words(const uint32_t* w, int n) {
  return [w, n](int q) { return q >= 0 && q < n ? w[q] : 0u; };
}

// The k-mer words of the read at position p (dna.pack_kmers layout: base j
// of the k-mer at bit 2*(k-1-j), little-endian words), cut from the packed
// words word(q) of the read: with pad = 32W - 2k, word m of
// (bases p.. shifted up by pad bits) is the funnel shift of two read words
// at bit 2p - pad + 32m, the pad bits below the k-mer are cleared, and
// reversing the 2-bit digits of all W words gives the reference's order.
// word(q) is asked for q in [floor((2p - pad) / 32), (2p + 2k - 1) / 32 + 1];
// bits outside the k-mer may be anything.
template <int W, class Word>
__device__ __forceinline__ void kmer_words(Word word, int p, int k,
                                           uint32_t (&out)[W]) {
  const int pad = 32 * W - 2 * k;
  uint32_t y[W];
#pragma unroll
  for (int m = 0; m < W; m++) {
    const int bit = 2 * p - pad + 32 * m;
    const int q = bit >> 5;
    y[m] = __funnelshift_r(word(q), word(q + 1), (unsigned)(bit & 31));
  }
  if (pad > 0) y[0] &= ~((1u << pad) - 1u);
#pragma unroll
  for (int j = 0; j < W; j++) out[j] = rev2(y[W - 1 - j]);
}

// An L2 evict-first cache policy (createpolicy, sm_80+): lines a load or a
// store brings in under it are the first the L2 evicts.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// load_words under the evict-first policy, for data no later read of the
// launch wants from L2: the MPHF probers (K1, K2's lazy seek, K3, K8) read
// their random slot records, K8 its streamed queries and results, this
// way, so those do not evict the (bit word, rank word) pairs every probe
// reads (K3 20%, K8 12% faster on the H100; an L2 persisting window over
// the pairs did as well, but the L2 set-aside it needs halved the
// streaming rate of every later kernel: PERF.md §6).
template <int N>
__device__ __forceinline__ void load_words_evict_first(const uint32_t* p,
                                                       uint32_t (&r)[N]) {
  const uint64_t pol = evict_first_policy();
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; i++)
      asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
          : "=r"(r[4 * i]), "=r"(r[4 * i + 1]), "=r"(r[4 * i + 2]),
            "=r"(r[4 * i + 3])
          : "l"(p + 4 * i), "l"(pol));
  } else if (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; i++)
      asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
          : "=r"(r[2 * i]), "=r"(r[2 * i + 1])
          : "l"(p + 2 * i), "l"(pol));
  } else {
#pragma unroll
    for (int i = 0; i < N; i++)
      asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
          : "=r"(r[i]) : "l"(p + i), "l"(pol));
  }
}

// One 8-byte store under the evict-first policy.
__device__ __forceinline__ void store_evict_first(int2* p, int2 v) {
  asm volatile("st.global.L2::cache_hint.v2.s32 [%0], {%1, %2}, %3;"
               :: "l"(p), "r"(v.x), "r"(v.y), "l"(evict_first_policy())
               : "memory");
}

// One 16-byte store under the evict-first policy (K11's responses).
__device__ __forceinline__ void store_evict_first(int4* p, int4 v) {
  asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
                  "l"(evict_first_policy())
               : "memory");
}

// N consecutive words from p into registers, in 16-byte loads where N is a
// multiple of 4 (the caller keeps p 16-byte aligned then), else 8-byte or
// 4-byte ones.
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&r)[N]) {
  if (N % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < N / 4; i++) {
      const uint4 x = __ldg(v + i);
      r[4 * i] = x.x;
      r[4 * i + 1] = x.y;
      r[4 * i + 2] = x.z;
      r[4 * i + 3] = x.w;
    }
  } else if (N % 2 == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; i++) {
      const uint2 x = __ldg(v + i);
      r[2 * i] = x.x;
      r[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i++) r[i] = __ldg(p + i);
  }
}

// Two-bucket, 4-slot cuckoo probe; the first key match in (bucket, slot)
// order wins.  A bucket row (4W words) is W 16-byte loads; the second
// bucket is read only when the first has no match (K1 is bound by the rate
// of random 32-byte reads once every thread carries a probe, so a second
// row read alongside the first costs more than the round trip it saves).
// At 2k == 32W the all-ones k-mer resolves from the launch parameters,
// since its key pattern also marks empty slots.
template <int W>
__device__ __forceinline__ void cuckoo_probe(const Params& p,
                                             const uint32_t* cuckoo,
                                             const uint32_t* vals,
                                             const uint32_t (&w)[W],
                                             int* node, int* off) {
  *node = -1;
  *off = -1;
  for (int b = 0; b < 2; b++) {
    const uint32_t h =
        hash_words<W>(w, b == 0 ? H1_SEED : H2_SEED) & p.cuckoo_mask;
    uint32_t row[SLOTS * W];
    load_words<SLOTS * W>(cuckoo + (size_t)h * (SLOTS * W), row);
    int hit = -1;
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; s--) {
      bool eq = true;
#pragma unroll
      for (int j = 0; j < W; j++) eq = eq && (row[s * W + j] == w[j]);
      if (eq) hit = s;
    }
    if (hit >= 0) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(vals) +
                            (size_t)h * SLOTS + hit);
      *node = (int)v.x;
      *off = (int)v.y;
      break;
    }
  }
  if (2 * p.k == 32 * W) {
    bool ones = true;
#pragma unroll
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
// ordinary key here.  The row is read in groups of 4 slots (16(W+2) bytes,
// W+2 16-byte loads), a group only when the ones before it hold no match.
template <int W>
__device__ __forceinline__ void bucket1_probe(const Params& p,
                                              const uint32_t* rows,
                                              const uint32_t (&w)[W],
                                              int* node, int* off) {
  constexpr int S = W + 2, G = 4;
  const uint32_t h = hash_words<W>(w, p.bucket_seed) & p.cuckoo_mask;
  const uint32_t* row = rows + (size_t)h * (B1_SLOTS * S);
  *node = -1;
  *off = -1;
#pragma unroll 1
  for (int g = 0; g < B1_SLOTS; g += G) {
    uint32_t r[G * S];
    load_words<G * S>(row + g * S, r);
    int hit = -1;
#pragma unroll
    for (int s = G - 1; s >= 0; s--) {
      bool eq = r[s * S + W] != EMPTY;
#pragma unroll
      for (int j = 0; j < W; j++) eq = eq && (r[s * S + j] == w[j]);
      if (eq) hit = s;
    }
    if (hit >= 0) {
#pragma unroll
      for (int s = 0; s < G; s++) {
        if (s == hit) {
          *node = (int)r[s * S + W];
          *off = (int)r[s * S + W + 1];
        }
      }
      return;
    }
  }
}

// BBHash level probe: per level, hash with the level's seed, mask, read the
// level word's (bit word, rank word) pair in one 8-byte load; the first
// level whose bit is set gives the slot key_off + rank + popcount(bits
// below), in 32-bit arithmetic as the reference's int32.  -1 when no
// level's bit is set.  An alien k-mer can land on a set bit: the caller
// verifies the stored key.  The levels are read one after another: loading
// two levels' pairs at once costs more of the random-access rate that
// bounds the probers than the round trip it saves (PERF.md §6).
template <int W>
__device__ __forceinline__ int mphf_slot(int n_levels, const Levels& lv,
                                         const uint2* pairs,
                                         const uint32_t (&w)[W]) {
  for (int l = 0; l < n_levels; l++) {
    const uint32_t h = hash_words<W>(w, lv.seed[l]) & lv.mask[l];
    const uint2 p = __ldg(pairs + lv.word_off[l] + (h >> 5));
    const uint32_t bp = h & 31u;
    if ((p.x >> bp) & 1u)
      return (int)(lv.key_off[l] + p.y +
                   (uint32_t)__popc(p.x & ((1u << bp) - 1u)));
  }
  return -1;
}

// Words of an MPHF slot record of W key words, node and offset
// (ops/map_kernel.py record_words): 16 bytes up to W = 2, else 32, so a
// record never straddles a 32-byte sector.
template <int W>
constexpr int RECORD_WORDS = W + 2 <= 4 ? 4 : 8;

// The stored-key verify of MPHF slot `slot`: one load of its record under
// the evict-first policy (records are not read again within a launch; the
// pairs are); whether its key equals the query words, and (node, offset)
// from the same registers when it does, else (-1, -1).  K1, K2's lazy
// seek, K3 and K8 all verify through it.
template <int W>
__device__ __forceinline__ bool record_verify(const uint32_t* records,
                                              int slot,
                                              const uint32_t (&w)[W],
                                              int* node, int* off) {
  constexpr int RW = RECORD_WORDS<W>;
  uint32_t rec[RW];
  load_words_evict_first<RW>(records + (size_t)slot * RW, rec);
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; j++) eq = eq && (rec[j] == w[j]);
  *node = eq ? (int)rec[W] : -1;
  *off = eq ? (int)rec[W + 1] : -1;
  return eq;
}

// MPHF probe plus the stored-key verify: (node, offset) at the slot when the
// key there equals the query, else (-1, -1).  Key and values share one
// record, so after the level walk a probe reads one sector, hit or miss,
// and a hit's values come with its key rather than a round trip later.
template <int W>
__device__ __forceinline__ void mphf_verified_probe(const Params& p,
                                                    const Levels& lv,
                                                    const Index& ix,
                                                    const uint32_t (&w)[W],
                                                    int* node, int* off) {
  const int slot = mphf_slot<W>(p.n_levels, lv, ix.pairs, w);
  *node = -1;
  *off = -1;
  if (slot >= 0) record_verify<W>(ix.records, slot, w, node, off);
}

// The seed probe of the index kind MODE (ops/map_kernel.py seed_probe).
template <int W, int MODE>
__device__ __forceinline__ void seed_probe_as(const Params& p,
                                              const Levels& lv,
                                              const Index& ix,
                                              const uint32_t (&w)[W],
                                              int* node, int* off) {
  if (MODE == MODE_BUCKET1)
    bucket1_probe<W>(p, ix.cuckoo, w, node, off);
  else if (MODE == MODE_MPHF)
    mphf_verified_probe<W>(p, lv, ix, w, node, off);
  else
    cuckoo_probe<W>(p, ix.cuckoo, ix.vals, w, node, off);
}

// The same with the kind p.mode chosen at run time (K2's lazy seek).
template <int W>
__device__ __forceinline__ void seed_probe(const Params& p, const Levels& lv,
                                           const Index& ix,
                                           const uint32_t (&w)[W], int* node,
                                           int* off) {
  if (p.mode == MODE_BUCKET1)
    seed_probe_as<W, MODE_BUCKET1>(p, lv, ix, w, node, off);
  else if (p.mode == MODE_MPHF)
    seed_probe_as<W, MODE_MPHF>(p, lv, ix, w, node, off);
  else
    seed_probe_as<W, MODE_CUCKOO>(p, lv, ix, w, node, off);
}

// Rows of the next-hit table over P positions: the grid K1 probes, every
// third position (residue 0) under lazy seeds, else every position
// (MapMeta.nh3_rows in ops/map_kernel.py).
__host__ __device__ inline int nh3_rows(int P, int lazy) {
  return lazy ? (P + 2) / 3 : P;
}

// One (read, residue r) grid of the stride-3 next-hit table
// (ops/map_kernel.py next_hit_table): walks the positions r, r+3, ...
// backwards and writes row pos / S of nh3 = (q, node, off) of the nearest
// seed q >= pos on the grid, or (P, -1, -1) when there is none.  S is the
// table's stride: 1 (a row per position) or 3 (lazy seeds: residue 0's
// rows alone, r = 0).  seed(pos / S, &node, &off) is asked only for
// positions up to last_valid (len - k); a seed counts when its node is
// >= 0.  K1's seed pass and its next_hit entry both run it over a tile in
// shared memory (SeedTile), so the table has one definition.
template <int S, class Seed>
__device__ __forceinline__ void next_hit_residue(int P, int r, int last_valid,
                                                 Seed seed, int32_t* nh3) {
  int q = P, qn = -1, qo = -1;
  const int top = r + 3 * ((P - 1 - r) / 3);
  for (int pos = top; pos >= r; pos -= 3) {
    const int row = pos / S;
    if (pos <= last_valid) {
      int node, off;
      seed(row, &node, &off);
      if (node >= 0) {
        q = pos;
        qn = node;
        qo = off;
      }
    }
    int32_t* out = nh3 + (size_t)row * 3;
    out[0] = q;
    out[1] = qn;
    out[2] = qo;
  }
}

// n int32 from src to dst by all threads of the block, 16 bytes at a time
// where both are 16-byte aligned.
__device__ __forceinline__ void block_copy(int32_t* dst, const int32_t* src,
                                           int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// n int32 of dst set to v by all threads of the block, 16 bytes at a time
// where dst is 16-byte aligned.
__device__ __forceinline__ void block_fill(int32_t* dst, int n, int32_t v) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4 v4 = make_int4(v, v, v, v);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = v4;
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = v;
}

// A tile of K1: R consecutive reads of a block, in dynamic shared memory
// (int32 units): nh3 [R, G, 3] first (16-byte aligned for the store),
// then node and off [R, G], then, for the probing entry, the reads' packed
// words with a zero word before and after each read, [R, nw + 2], and
// lens [R].  G is the table's rows (nh3_rows): node and off hold the seed
// of each row's position.
struct SeedTile {
  int R, P, G, nw;
  int32_t* nh3;
  int32_t* node;
  int32_t* off;
  uint32_t* read;
  int32_t* len;

  __host__ __device__ static size_t bytes(int R, int G, int nw) {
    return (size_t)4 * R * (5 * G + (nw > 0 ? nw + 3 : 1));
  }

  __device__ SeedTile(int32_t* smem, int R_, int P_, int G_, int nw_)
      : R(R_), P(P_), G(G_), nw(nw_) {
    nh3 = smem;
    node = nh3 + (size_t)R * G * 3;
    off = node + (size_t)R * G;
    read = reinterpret_cast<uint32_t*>(off + (size_t)R * G);
    len = reinterpret_cast<int32_t*>(read + (size_t)R * (nw > 0 ? nw + 2 : 0));
  }

  // Phases B and C: the next-hit rows of the tile's nb reads from their
  // seeds (node, off), then the tile's nh3 [nb, G, 3] to global memory at
  // `out` in 16-byte stores.  Stride S = 1 (G = P): one thread per (read,
  // residue); S = 3 (lazy seeds, G = ceil(P / 3)): one thread per read over
  // its residue-0 grid, the only rows the table has.
  template <int S>
  __device__ void scan_and_store(int k, int nb, int32_t* out) {
    constexpr int NR = S == 1 ? 3 : 1;  // residue grids in a read's rows
    for (int i = threadIdx.x; i < nb * NR; i += blockDim.x) {
      const int r = i / NR, res = i - NR * r;
      if (res >= P) continue;
      const int32_t* sn = node + (size_t)r * G;
      const int32_t* so = off + (size_t)r * G;
      next_hit_residue<S>(
          P, res, len[r] - k,
          [&](int row, int* n, int* o) {
            *n = sn[row];
            *o = so[row];
          },
          nh3 + (size_t)r * G * 3);
    }
    __syncthreads();
    block_copy(out, nh3, nb * G * 3);
  }
};

// One segment compare of the walk under the per-segment SNP budget: bases
// i = 0, 1, ... < maxm of the reference at ref0 + dir*i against the read at
// read0 + dir*i (dir +1 forward, -1 for the left extension), where ref(q)
// and read(q) give the sources' packed words.  The base that breaks the
// budget counts as a mismatch (*seen) but not as matched; returns whether
// it was broken.  Sixteen bases per step: the two 32-bit windows are
// XORed, each base's two bits folded into one mismatch bit (reversed for
// dir -1, so bit 2t is base i + t), the bases past maxm masked, and a step
// that breaks the budget finds the breaking mismatch by clearing the ones
// within budget.  The reference side is the global pool in K2 (walk.cu)
// and a window a routed fetch returned in K10 (gwalk.cu), so both walks
// share this compare.  The sources are asked for the words around the
// compared bases (up to 15 bases beyond each end); what those words hold
// outside the compared bases does not matter.
template <class Ref, class Read>
__device__ __forceinline__ bool segment_compare(int maxm, int allowed,
                                                int dir, Ref ref, int ref0,
                                                Read read, int read0,
                                                int* matched, int* seen) {
  int s = 0;
  for (int i = 0; i < maxm; i += 16) {
    uint32_t x;
    if (dir > 0) {
      x = window16(ref, ref0 + i) ^ window16(read, read0 + i);
    } else {
      x = window16(ref, ref0 - i - 15) ^ window16(read, read0 - i - 15);
    }
    uint32_t m = (x | (x >> 1)) & 0x55555555u;
    if (dir < 0) m = __brev(m) >> 1;
    const int n = maxm - i;
    if (n < 16) m &= (1u << (2 * n)) - 1u;
    const int c = __popc(m);
    if (s + c > allowed) {
      for (int j = s; j < allowed; j++) m &= m - 1u;
      *matched = i + ((__ffs(m) - 1) >> 1);
      *seen = allowed + 1;
      return true;
    }
    s += c;
  }
  *matched = maxm > 0 ? maxm : 0;
  *seen = s;
  return false;
}

// The walk's output arrays (MapResult's fields; ec_distinct and coverage
// narrowed as the launch parameters say).
struct WalkOut {
  uint8_t* mapped;
  void* cov;
  int32_t* mm;
  int32_t* nn;
  void* dist;
  int32_t* nodes;
};

// Block-wide start of the walk's output (K2 and K10's finish; every thread
// of the block calls it, then __syncthreads): in the full-output shape
// (p.dc == 0) the rows of the block's nb reads in nodes [B, max_nodes] are
// set to -1 with 16-byte stores, so each read then writes only its pushed
// nodes.
__device__ __forceinline__ void walk_out_begin(const Params& p, int b0, int nb,
                                               const WalkOut& o) {
  if (p.dc == 0 && nb > 0)
    block_fill(o.nodes + (size_t)b0 * p.max_nodes, nb * p.max_nodes, -1);
}

// One read's pushes (node, class id) in push order, as they come: only the
// first max_nodes are kept, nn counts all.  The full output writes the node
// straight to the read's row of nodes; the compact output run-length
// compacts the class ids online into dc slots in shared memory (slot i at
// slots[i * stride]): a class id >= 0 that differs from the one before it
// opens a run, and the first dc runs fill the slots.
struct Pushes {
  int32_t* row;
  int32_t* slots;
  int stride;
  int nn, runs, prev;

  __device__ Pushes(const Params& p, const WalkOut& o, int b, int32_t* slots_,
                    int stride_)
      : row(o.nodes + (size_t)b * p.max_nodes), slots(slots_),
        stride(stride_), nn(0), runs(0), prev(-1) {
    for (int i = 0; i < p.dc; i++) slots[i * stride] = -1;
  }

  __device__ __forceinline__ void push(const Params& p, int node, int ec) {
    if (nn < p.max_nodes) {
      if (p.dc == 0) {
        row[nn] = node;
      } else {
        if (ec >= 0 && ec != prev) {
          if (runs < p.dc) slots[runs * stride] = ec;
          runs++;
        }
        prev = ec;
      }
    }
    nn++;
  }
};

// One read's outputs from its walk (K2 and K10): n_nodes, mapped and the
// mismatches; coverage (uint8 when p.cov8 in the compact shape); in the
// compact shape the dc slots, -2 in the last when more runs were pushed,
// -3 when `capped` (int16 when p.ec16).  The full node list is already
// written by the pushes.
__device__ __forceinline__ void encode_output(const Params& p, int b,
                                              const Pushes& s, int cov,
                                              int mm, bool capped,
                                              const WalkOut& o) {
  o.nn[b] = s.nn;
  o.mapped[b] = s.nn > 0;
  o.mm[b] = mm;
  if (p.dc == 0) {
    reinterpret_cast<int32_t*>(o.cov)[b] = cov;
    return;
  }
  if (p.cov8)
    reinterpret_cast<uint8_t*>(o.cov)[b] = (uint8_t)cov;
  else
    reinterpret_cast<int32_t*>(o.cov)[b] = cov;
  const int dc = p.dc;
  for (int i = 0; i < dc; i++) {
    int v = s.slots[i * s.stride];
    if (i == dc - 1) {
      if (s.runs > dc) v = -2;
      if (capped) v = -3;
    }
    if (p.ec16)
      reinterpret_cast<int16_t*>(o.dist)[(size_t)b * dc + i] = (int16_t)v;
    else
      reinterpret_cast<int32_t*>(o.dist)[(size_t)b * dc + i] = v;
  }
}

}  // namespace pa
