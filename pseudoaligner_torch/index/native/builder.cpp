// Native index-build census — the heavy host-side stage of index
// construction (stage A; see ../builder.py).
//
// TPU-native equivalent of the reference's sharded build hot path:
// rayon-parallel super-k-mer sort + debruijn::filter_kmers k-mer census +
// CountFilterEqClass equivalence-class interning + the ScmapCompress join
// computation (reference: src/build_index.rs:50-71,153-179 and
// src/equiv_classes.rs:62-91 [dep]).  Where the reference shards by MSP
// bucket to bound memory and parallelize, this builder byte-partitions the
// global occurrence table on the k-mer's top bits (same invariant: every
// distinct k-mer lands wholly in one partition) and sorts partitions on a
// thread pool.
//
// Produces, per distinct k-mer (ascending order): packed words, exts union,
// equivalence-class id (ids dense, assigned by first appearance in sorted
// k-mer order — deterministic, bit-identical to the NumPy path), the EC
// table in CSR form, and the unitig join successor array with self-loops
// and cycles broken at each cycle's minimum element.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct U128 {
  uint64_t lo, hi;
  bool operator<(const U128& o) const {
    return hi != o.hi ? hi < o.hi : lo < o.lo;
  }
  bool operator==(const U128& o) const { return hi == o.hi && lo == o.lo; }
};

struct Occ {
  U128 km;
  uint32_t tx;
  uint8_t ext;
};

inline U128 shl2_or(U128 v, uint64_t b, int k) {
  U128 r;
  r.hi = (v.hi << 2) | (v.lo >> 62);
  r.lo = (v.lo << 2) | b;
  int bits = 2 * k;
  if (bits < 64) {
    r.lo &= (1ULL << bits) - 1;
    r.hi = 0;
  } else if (bits < 128) {
    r.hi &= (bits == 64) ? 0ULL : ((1ULL << (bits - 64)) - 1);
  }
  return r;
}

inline uint64_t first_base(U128 v, int k) {
  int shift = 2 * (k - 1);
  if (shift >= 64) return (v.hi >> (shift - 64)) & 3;
  return (v.lo >> shift) & 3;
}

inline unsigned top_byte(U128 v, int k) {
  int shift = 2 * k - 8;
  if (shift < 0) return (unsigned)(v.lo & 0xFF);
  if (shift >= 64) return (unsigned)((v.hi >> (shift - 64)) & 0xFF);
  uint64_t x = v.lo >> shift;
  if (shift > 0 && 64 - shift < 8) x |= v.hi << (64 - shift);
  return (unsigned)(x & 0xFF);
}

struct VecHash {
  size_t operator()(const std::vector<uint32_t>& v) const {
    uint64_t h = 1469598103934665603ULL;
    for (uint32_t x : v) {
      h ^= x;
      h *= 1099511628211ULL;
      h ^= h >> 29;
    }
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

typedef struct {
  int64_t nk;
  int64_t n_ecs;
  int64_t ec_total;
  int32_t words_per_kmer;
  uint32_t* kmer_words;  // nk * W, little-endian words
  uint8_t* exts;         // nk
  uint32_t* ec_of_kmer;  // nk
  uint32_t* ec_offsets;  // n_ecs + 1
  uint32_t* ec_txs;      // ec_total
  int64_t* nxt;          // nk
} PaCensus;

void pa_census_free(PaCensus* c) {
  std::free(c->kmer_words);
  std::free(c->exts);
  std::free(c->ec_of_kmer);
  std::free(c->ec_offsets);
  std::free(c->ec_txs);
  std::free(c->nxt);
  std::memset(c, 0, sizeof(*c));
}

// codes: concatenated per-sequence base codes (0..3, one byte each)
// offsets: n_seqs+1 prefix offsets into codes
// returns 0 on success
int pa_census(const uint8_t* codes, const int64_t* offsets, int64_t n_seqs,
              int32_t k, int32_t n_threads, PaCensus* out) {
  if (k < 4 || k > 64) return 2;
  if (n_threads < 1) n_threads = 1;

  // ---- occurrence fill (parallel over sequences) ----
  int64_t total = 0;
  for (int64_t s = 0; s < n_seqs; s++) {
    int64_t len = offsets[s + 1] - offsets[s];
    if (len >= k) total += len - k + 1;
  }
  if (total == 0) return 1;

  std::vector<Occ> occ(total);
  {
    std::vector<int64_t> seq_base(n_seqs + 1, 0);
    for (int64_t s = 0; s < n_seqs; s++) {
      int64_t len = offsets[s + 1] - offsets[s];
      seq_base[s + 1] = seq_base[s] + (len >= k ? len - k + 1 : 0);
    }
    auto fill = [&](int64_t s_begin, int64_t s_end) {
      for (int64_t s = s_begin; s < s_end; s++) {
        const uint8_t* c = codes + offsets[s];
        int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;
        int64_t num = len - k + 1;
        Occ* dst = occ.data() + seq_base[s];
        U128 v{0, 0};
        for (int i = 0; i < k; i++) v = shl2_or(v, c[i], k);
        for (int64_t p = 0;; p++) {
          Occ& o = dst[p];
          o.km = v;
          o.tx = (uint32_t)s;
          uint8_t e = 0;
          if (p > 0) e |= (uint8_t)(1u << (4 + c[p - 1]));
          if (p + k < len) e |= (uint8_t)(1u << c[p + k]);
          o.ext = e;
          if (p + 1 >= num) break;
          v = shl2_or(v, c[p + k], k);
        }
      }
    };
    int T = n_threads;
    std::vector<std::thread> ths;
    int64_t chunk = (n_seqs + T - 1) / T;
    for (int t = 0; t < T; t++) {
      int64_t b = t * chunk, e = std::min(n_seqs, b + chunk);
      if (b < e) ths.emplace_back(fill, b, e);
    }
    for (auto& th : ths) th.join();
  }

  // ---- 256-way partition by top byte, parallel sort of partitions ----
  {
    std::vector<int64_t> counts(257, 0);
    for (const Occ& o : occ) counts[top_byte(o.km, k) + 1]++;
    for (int i = 0; i < 256; i++) counts[i + 1] += counts[i];
    std::vector<Occ> tmp(total);
    {
      std::vector<int64_t> cur(counts.begin(), counts.begin() + 256);
      for (const Occ& o : occ) tmp[cur[top_byte(o.km, k)]++] = o;
    }
    occ.swap(tmp);
    auto cmp = [](const Occ& a, const Occ& b) {
      if (!(a.km == b.km)) return a.km < b.km;
      return a.tx < b.tx;
    };
    std::vector<std::thread> ths;
    std::atomic<int> next_part{0};  // stack-local: all threads join
    auto work = [&]() {             // before this scope exits
      for (;;) {
        int p = next_part.fetch_add(1);
        if (p >= 256) return;
        std::sort(occ.begin() + counts[p], occ.begin() + counts[p + 1], cmp);
      }
    };
    for (int t = 0; t < n_threads; t++) ths.emplace_back(work);
    for (auto& th : ths) th.join();
  }

  // ---- group scan: exts union, tx dedup, EC interning ----
  std::vector<U128> kmers;
  std::vector<uint8_t> exts;
  std::vector<uint32_t> ecs;
  kmers.reserve(total / 2);
  exts.reserve(total / 2);
  ecs.reserve(total / 2);

  std::unordered_map<std::vector<uint32_t>, uint32_t, VecHash> intern;
  std::vector<uint32_t> ec_offsets{0};
  std::vector<uint32_t> ec_txs;
  std::vector<uint32_t> scratch;

  for (int64_t i = 0; i < total;) {
    U128 km = occ[i].km;
    uint8_t e = 0;
    scratch.clear();
    int64_t j = i;
    for (; j < total && occ[j].km == km; j++) {
      e |= occ[j].ext;
      if (scratch.empty() || scratch.back() != occ[j].tx)
        scratch.push_back(occ[j].tx);
    }
    auto it = intern.find(scratch);
    uint32_t id;
    if (it == intern.end()) {
      id = (uint32_t)intern.size();
      intern.emplace(scratch, id);
      ec_txs.insert(ec_txs.end(), scratch.begin(), scratch.end());
      ec_offsets.push_back((uint32_t)ec_txs.size());
    } else {
      id = it->second;
    }
    kmers.push_back(km);
    exts.push_back(e);
    ecs.push_back(id);
    i = j;
  }
  occ.clear();
  occ.shrink_to_fit();
  int64_t nk = (int64_t)kmers.size();

  // ---- join successors (ScmapCompress rule) ----
  std::vector<int64_t> nxt(nk, -1);
  {
    auto find = [&](U128 v) -> int64_t {
      auto it = std::lower_bound(kmers.begin(), kmers.end(), v);
      if (it == kmers.end() || !(*it == v)) return -1;
      return it - kmers.begin();
    };
    auto work = [&](int64_t b, int64_t e) {
      for (int64_t i = b; i < e; i++) {
        unsigned r = exts[i] & 0xF;
        if (__builtin_popcount(r) != 1) continue;
        unsigned rb = __builtin_ctz(r);
        U128 succ = shl2_or(kmers[i], rb, k);
        int64_t j = find(succ);
        if (j < 0 || j == i) continue;  // missing (impossible) or self-loop
        unsigned l = exts[j] >> 4;
        if (__builtin_popcount(l) != 1) continue;
        if (__builtin_ctz(l) != first_base(kmers[i], k)) continue;
        if (ecs[i] != ecs[j]) continue;
        nxt[i] = j;
      }
    };
    std::vector<std::thread> ths;
    int64_t chunk = (nk + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t b = t * chunk, e = std::min(nk, b + chunk);
      if (b < e) ths.emplace_back(work, b, e);
    }
    for (auto& th : ths) th.join();
  }

  // ---- cycle breaking (sequential) ----
  {
    std::vector<int64_t> prv(nk, -1);
    for (int64_t i = 0; i < nk; i++)
      if (nxt[i] >= 0) prv[nxt[i]] = i;
    std::vector<uint8_t> visited(nk, 0);
    for (int64_t i = 0; i < nk; i++) {
      if (prv[i] >= 0) continue;  // not a head
      for (int64_t x = i; x >= 0; x = nxt[x]) visited[x] = 1;
    }
    for (int64_t i = 0; i < nk; i++) {
      if (visited[i]) continue;
      // walk the cycle, find min
      int64_t m = i, x = nxt[i];
      visited[i] = 1;
      while (x != i) {
        visited[x] = 1;
        if (x < m) m = x;
        x = nxt[x];
      }
      // break the edge entering m
      int64_t y = m;
      while (nxt[y] != m) y = nxt[y];
      nxt[y] = -1;
    }
  }

  // ---- emit ----
  int W = (2 * k + 31) / 32;
  out->nk = nk;
  out->n_ecs = (int64_t)intern.size();
  out->ec_total = (int64_t)ec_txs.size();
  out->words_per_kmer = W;
  out->kmer_words = (uint32_t*)std::malloc(sizeof(uint32_t) * nk * W);
  out->exts = (uint8_t*)std::malloc(nk);
  out->ec_of_kmer = (uint32_t*)std::malloc(sizeof(uint32_t) * nk);
  out->ec_offsets = (uint32_t*)std::malloc(sizeof(uint32_t) * ec_offsets.size());
  out->ec_txs = (uint32_t*)std::malloc(sizeof(uint32_t) * std::max<size_t>(1, ec_txs.size()));
  out->nxt = (int64_t*)std::malloc(sizeof(int64_t) * nk);
  if (!out->kmer_words || !out->exts || !out->ec_of_kmer || !out->ec_offsets ||
      !out->ec_txs || !out->nxt) {
    pa_census_free(out);
    return 3;
  }
  for (int64_t i = 0; i < nk; i++) {
    for (int w = 0; w < W; w++) {
      uint64_t word;
      if (w < 2)
        word = (kmers[i].lo >> (32 * w)) & 0xFFFFFFFFULL;
      else
        word = (kmers[i].hi >> (32 * (w - 2))) & 0xFFFFFFFFULL;
      out->kmer_words[i * W + w] = (uint32_t)word;
    }
  }
  std::memcpy(out->exts, exts.data(), nk);
  std::memcpy(out->ec_of_kmer, ecs.data(), sizeof(uint32_t) * nk);
  std::memcpy(out->ec_offsets, ec_offsets.data(),
              sizeof(uint32_t) * ec_offsets.size());
  if (!ec_txs.empty())
    std::memcpy(out->ec_txs, ec_txs.data(), sizeof(uint32_t) * ec_txs.size());
  std::memcpy(out->nxt, nxt.data(), sizeof(int64_t) * nk);
  return 0;
}

}  // extern "C"

namespace {

// murmur3 fmix32 — bit-identical to ops/hashing.py::mix32_np
inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t hash_kmer(const uint32_t* w, int W, uint32_t seed) {
  uint32_t h = seed;
  for (int j = 0; j < W; j++) h = mix32(h ^ w[j]);
  return h;
}

}  // namespace

extern "C" {

// Native build of the 4-slot two-choice cuckoo seed table (the speed-mode
// k-mer index; layout and hash spec shared with ../cuckoo.py — the probe is
// placement-invariant, so this build only needs validity + determinism, not
// bit-identity with the NumPy builder).  Serving-time equivalent of the
// reference loading its NoKeyBoomHashMap (src/build_index.rs:220 [dep]);
// here the table is rebuilt from the serialized flat arrays at load time.
//
// keys: n*W uint32 (distinct), rows out: n_buckets * SLOTS*(W+2) uint32,
// caller-allocated and zeroed.  n_buckets must be a power of two.
// Returns 0 on success, 1 if placement failed (caller grows the table).
int pa_cuckoo(const uint32_t* keys, const uint32_t* nodes,
              const uint32_t* offsets, int64_t n, int32_t W,
              int64_t n_buckets, int32_t n_threads, uint32_t* rows) {
  constexpr int SLOTS = 4;
  constexpr uint32_t EMPTY = 0xFFFFFFFFu;
  constexpr uint32_t H1_SEED = 0x13579BDFu;
  constexpr uint32_t H2_SEED = 0x2468ACE0u;
  constexpr int MAX_KICKS = 512;
  if (n_buckets < 2 || (n_buckets & (n_buckets - 1)) != 0) return 2;
  uint32_t mask = (uint32_t)(n_buckets - 1);
  if (n_threads < 1) n_threads = 1;

  std::vector<uint32_t> h1(n), h2(n);
  {
    auto work = [&](int64_t b, int64_t e) {
      for (int64_t i = b; i < e; i++) {
        h1[i] = hash_kmer(keys + i * W, W, H1_SEED) & mask;
        h2[i] = hash_kmer(keys + i * W, W, H2_SEED) & mask;
      }
    };
    std::vector<std::thread> ths;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t b = t * chunk, e = std::min(n, b + chunk);
      if (b < e) ths.emplace_back(work, b, e);
    }
    for (auto& th : ths) th.join();
  }

  // slots hold key indices during construction (evictions reuse hashes)
  std::vector<int64_t> slot_idx((size_t)n_buckets * SLOTS, -1);
  std::vector<uint8_t> used(n_buckets, 0);
  uint64_t rng = 0x9E3779B97F4A7C15ULL;  // deterministic xorshift64*
  auto next_rng = [&rng]() {
    rng ^= rng >> 12;
    rng ^= rng << 25;
    rng ^= rng >> 27;
    return rng * 0x2545F4914F6CDD1DULL;
  };

  // the placement loop is cache-miss-bound (two random touches per key
  // over a table far beyond LLC): prefetch the bucket metadata + slot
  // rows a fixed distance ahead (~2x at 52M keys)
  const int64_t PFD = 24;
  for (int64_t i = 0; i < n; i++) {
    if (i + PFD < n) {
      uint32_t p1 = h1[i + PFD], p2 = h2[i + PFD];
      __builtin_prefetch(&used[p1], 1, 1);
      __builtin_prefetch(&used[p2], 1, 1);
      __builtin_prefetch(&slot_idx[(size_t)p1 * SLOTS], 1, 1);
      __builtin_prefetch(&slot_idx[(size_t)p2 * SLOTS], 1, 1);
    }
    int64_t cur = i;
    uint32_t b1 = h1[cur], b2 = h2[cur];
    // two-choice: emptier bucket first
    uint32_t b = used[b1] <= used[b2] ? b1 : b2;
    if (used[b] < SLOTS) {
      slot_idx[(size_t)b * SLOTS + used[b]] = cur;
      used[b]++;
      continue;
    }
    b = (b == b1) ? b2 : b1;
    bool ok = false;
    for (int kick = 0; kick < MAX_KICKS; kick++) {
      if (used[b] < SLOTS) {
        slot_idx[(size_t)b * SLOTS + used[b]] = cur;
        used[b]++;
        ok = true;
        break;
      }
      int s = (int)(next_rng() >> 32) & (SLOTS - 1);
      int64_t victim = slot_idx[(size_t)b * SLOTS + s];
      slot_idx[(size_t)b * SLOTS + s] = cur;
      cur = victim;
      b = (b == h1[cur]) ? h2[cur] : h1[cur];
    }
    if (!ok) return 1;
  }

  // materialize rows (parallel): per slot [key words..., node, offset]
  {
    int RW = SLOTS * (W + 2);
    auto work = [&](int64_t bb, int64_t be) {
      for (int64_t b = bb; b < be; b++) {
        uint32_t* row = rows + b * RW;
        for (int s = 0; s < SLOTS; s++) {
          uint32_t* slot = row + s * (W + 2);
          int64_t ki = slot_idx[(size_t)b * SLOTS + s];
          if (ki < 0) {
            for (int j = 0; j < W; j++) slot[j] = 0;
            slot[W] = EMPTY;
            slot[W + 1] = 0;
          } else {
            for (int j = 0; j < W; j++) slot[j] = keys[ki * W + j];
            slot[W] = nodes[ki];
            slot[W + 1] = offsets[ki];
          }
        }
      }
    };
    std::vector<std::thread> ths;
    int64_t chunk = (n_buckets + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t b = t * chunk, e = std::min(n_buckets, b + chunk);
      if (b < e) ths.emplace_back(work, b, e);
    }
    for (auto& th : ths) th.join();
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Native BBHash-style MPHF construction — bit-identical to the NumPy
// builder in ../mphf.py (the level-assignment algorithm is deterministic
// given the keys: per level, keys whose hash bucket has exactly one
// occupant are placed; pow2 level sizes, gamma widening on tail levels).
// TPU-native equivalent of boomphf::Mphf::from_chunked_iterator_parallel
// (reference: src/build_index.rs:195-197 [dep]).
typedef struct {
  int64_t n_keys;
  int32_t n_levels;
  int64_t total_words;
  uint32_t* seeds;         // n_levels
  uint32_t* masks;         // n_levels
  uint32_t* word_offsets;  // n_levels
  uint32_t* key_offsets;   // n_levels
  uint32_t* bits;          // total_words
  uint32_t* ranks;         // total_words
  int64_t* slot_of_key;    // n_keys
} PaMphf;

void pa_mphf_free(PaMphf* m) {
  std::free(m->seeds);
  std::free(m->masks);
  std::free(m->word_offsets);
  std::free(m->key_offsets);
  std::free(m->bits);
  std::free(m->ranks);
  std::free(m->slot_of_key);
  std::memset(m, 0, sizeof(*m));
}

int pa_mphf(const uint32_t* keys, int64_t n, int32_t W, double gamma,
            int32_t n_threads, PaMphf* out) {
  constexpr int MAX_LEVELS = 48;
  constexpr uint32_t GOLDEN32 = 0x9E3779B9u;
  if (n_threads < 1) n_threads = 1;
  std::memset(out, 0, sizeof(*out));

  out->slot_of_key = (int64_t*)std::malloc(sizeof(int64_t) * (size_t)n);
  if (!out->slot_of_key) return 3;
  for (int64_t i = 0; i < n; i++) out->slot_of_key[i] = -1;

  std::vector<int64_t> remaining(n);
  for (int64_t i = 0; i < n; i++) remaining[i] = i;

  std::vector<uint32_t> seeds, masks, word_offsets, key_offsets;
  std::vector<std::vector<uint32_t>> bits_parts, ranks_parts;
  int64_t word_off = 0, key_off = 0;

  auto parallel_for = [&](int64_t count, auto fn) {
    std::vector<std::thread> ths;
    int64_t chunk = (count + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t b = t * chunk, e = std::min(count, b + chunk);
      if (b < e) ths.emplace_back(fn, b, e);
    }
    for (auto& th : ths) th.join();
  };

  int lv = 0;
  for (; lv < MAX_LEVELS && !remaining.empty(); lv++) {
    int64_t m = (int64_t)remaining.size();
    double g = lv < 3 ? gamma : std::max(gamma, 8.0);
    int64_t want = (int64_t)std::ceil(g * (double)m);
    int bl = 6;
    while ((1LL << bl) < want) bl++;
    int64_t size = 1LL << bl;
    uint32_t mask = (uint32_t)(size - 1);
    uint32_t seed = mix32((uint32_t)((uint64_t)(lv + 1) * GOLDEN32));

    std::vector<uint32_t> h(m);
    std::vector<std::atomic<uint32_t>> counts(size);
    parallel_for(m, [&](int64_t b, int64_t e) {
      for (int64_t i = b; i < e; i++) {
        uint32_t hv = hash_kmer(keys + remaining[i] * W, W, seed) & mask;
        h[i] = hv;
        counts[hv].fetch_add(1, std::memory_order_relaxed);
      }
    });

    int64_t nwords = size / 32;
    std::vector<uint32_t> bitvec(nwords, 0);
    // set bits for singleton buckets (disjoint h values -> plain stores
    // would race per word; use atomic fetch_or)
    {
      std::atomic<uint32_t>* bv =
          reinterpret_cast<std::atomic<uint32_t>*>(bitvec.data());
      parallel_for(m, [&](int64_t b, int64_t e) {
        for (int64_t i = b; i < e; i++) {
          uint32_t hv = h[i];
          if (counts[hv].load(std::memory_order_relaxed) == 1)
            bv[hv >> 5].fetch_or(1u << (hv & 31), std::memory_order_relaxed);
        }
      });
    }

    std::vector<uint32_t> rank(nwords);
    uint32_t acc = 0;
    for (int64_t w = 0; w < nwords; w++) {
      rank[w] = acc;
      acc += (uint32_t)__builtin_popcount(bitvec[w]);
    }

    parallel_for(m, [&](int64_t b, int64_t e) {
      for (int64_t i = b; i < e; i++) {
        uint32_t hv = h[i];
        if (counts[hv].load(std::memory_order_relaxed) != 1) continue;
        uint32_t below = bitvec[hv >> 5] & ((1u << (hv & 31)) - 1u);
        out->slot_of_key[remaining[i]] =
            key_off + rank[hv >> 5] + __builtin_popcount(below);
      }
    });

    // compact the non-unique tail (stable, ascending — matches NumPy)
    std::vector<int64_t> next_remaining;
    next_remaining.reserve(m / 2);
    int64_t placed = 0;
    for (int64_t i = 0; i < m; i++) {
      if (counts[h[i]].load(std::memory_order_relaxed) == 1)
        placed++;
      else
        next_remaining.push_back(remaining[i]);
    }

    seeds.push_back(seed);
    masks.push_back(mask);
    word_offsets.push_back((uint32_t)word_off);
    key_offsets.push_back((uint32_t)key_off);
    bits_parts.push_back(std::move(bitvec));
    ranks_parts.push_back(std::move(rank));
    word_off += nwords;
    key_off += placed;
    remaining.swap(next_remaining);
  }
  if (!remaining.empty()) {
    pa_mphf_free(out);
    return 1;  // did not converge (mirrors the NumPy RuntimeError)
  }

  out->n_keys = n;
  out->n_levels = (int32_t)seeds.size();
  out->total_words = word_off;
  size_t nl = seeds.size();
  out->seeds = (uint32_t*)std::malloc(4 * nl);
  out->masks = (uint32_t*)std::malloc(4 * nl);
  out->word_offsets = (uint32_t*)std::malloc(4 * nl);
  out->key_offsets = (uint32_t*)std::malloc(4 * nl);
  out->bits = (uint32_t*)std::malloc(4 * std::max<int64_t>(1, word_off));
  out->ranks = (uint32_t*)std::malloc(4 * std::max<int64_t>(1, word_off));
  if (!out->seeds || !out->masks || !out->word_offsets || !out->key_offsets ||
      !out->bits || !out->ranks) {
    pa_mphf_free(out);
    return 3;
  }
  std::memcpy(out->seeds, seeds.data(), 4 * nl);
  std::memcpy(out->masks, masks.data(), 4 * nl);
  std::memcpy(out->word_offsets, word_offsets.data(), 4 * nl);
  std::memcpy(out->key_offsets, key_offsets.data(), 4 * nl);
  int64_t w = 0;
  for (size_t p = 0; p < bits_parts.size(); p++) {
    std::memcpy(out->bits + w, bits_parts[p].data(), 4 * bits_parts[p].size());
    std::memcpy(out->ranks + w, ranks_parts[p].data(),
                4 * ranks_parts[p].size());
    w += (int64_t)bits_parts[p].size();
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Parallel exact lookup of queries in a sorted unique key array
// (little-endian uint32 words, numeric order == lexicographic from the
// most significant word).  out[i] = index or -1.
void pa_lookup(const uint32_t* keys, int64_t nk, int32_t W,
               const uint32_t* queries, int64_t nq, int32_t n_threads,
               int64_t* out) {
  auto cmp_lt = [W](const uint32_t* a, const uint32_t* b) {
    for (int j = W - 1; j >= 0; j--) {
      if (a[j] != b[j]) return a[j] < b[j];
    }
    return false;
  };
  auto eq = [W](const uint32_t* a, const uint32_t* b) {
    for (int j = 0; j < W; j++)
      if (a[j] != b[j]) return false;
    return true;
  };
  auto work = [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; i++) {
      const uint32_t* q = queries + i * W;
      int64_t lo = 0, hi = nk;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (cmp_lt(keys + mid * W, q)) lo = mid + 1; else hi = mid;
      }
      out[i] = (lo < nk && eq(keys + lo * W, q)) ? lo : -1;
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> ths;
  int64_t chunk = (nq + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t b = t * chunk, e = std::min(nq, b + chunk);
    if (b < e) ths.emplace_back(work, b, e);
  }
  for (auto& th : ths) th.join();
}

}  // extern "C"

extern "C" {

// Stage B in native code: unitig chains, sequence pool, dense edge tables
// — the graph-assembly equivalent of compress_kmers_with_hash +
// BaseGraph::finish + edge resolution (reference: src/build_index.rs:
// 171-179 [dep]), consuming pa_census outputs.
typedef struct {
  int64_t n_nodes;
  int64_t total_bases;
  uint32_t* node_start;
  uint32_t* node_len;
  uint8_t* node_exts;
  uint32_t* node_ec;
  int32_t* l_edge;  // n_nodes*4
  int32_t* r_edge;  // n_nodes*4
  uint8_t* seq_pool;
  uint32_t* kmer_node;    // per census k-mer (ascending order)
  uint32_t* kmer_offset;  // offset of the k-mer within its node
} PaGraph;

void pa_graph_free(PaGraph* g) {
  std::free(g->node_start);
  std::free(g->node_len);
  std::free(g->node_exts);
  std::free(g->node_ec);
  std::free(g->l_edge);
  std::free(g->r_edge);
  std::free(g->seq_pool);
  std::free(g->kmer_node);
  std::free(g->kmer_offset);
  std::memset(g, 0, sizeof(*g));
}

static inline U128 load_kmer(const uint32_t* w, int W) {
  U128 v{0, 0};
  for (int j = 0; j < W && j < 2; j++) v.lo |= (uint64_t)w[j] << (32 * j);
  for (int j = 2; j < W; j++) v.hi |= (uint64_t)w[j] << (32 * (j - 2));
  return v;
}

static inline unsigned base_at(U128 v, int k, int i) {
  int shift = 2 * (k - 1 - i);
  if (shift >= 64) return (unsigned)((v.hi >> (shift - 64)) & 3);
  return (unsigned)((v.lo >> shift) & 3);
}

static inline U128 shr2_or_top(U128 v, uint64_t b, int k) {
  U128 r;
  r.lo = (v.lo >> 2) | (v.hi << 62);
  r.hi = v.hi >> 2;
  int hb = 2 * (k - 1);
  if (hb >= 64) r.hi |= b << (hb - 64); else r.lo |= b << hb;
  return r;
}

int pa_graph(const uint32_t* kmer_words, const uint8_t* exts,
             const uint32_t* ec, const int64_t* nxt, int64_t nk, int32_t k,
             PaGraph* out) {
  int W = (2 * k + 31) / 32;
  std::vector<U128> kmers(nk);
  for (int64_t i = 0; i < nk; i++) kmers[i] = load_kmer(kmer_words + i * W, W);

  std::vector<int64_t> prv(nk, -1);
  for (int64_t i = 0; i < nk; i++)
    if (nxt[i] >= 0) prv[nxt[i]] = i;

  // chains: heads visited in ascending k-mer order -> ascending node ids
  std::vector<uint32_t> node_of(nk), dist(nk);
  std::vector<int64_t> head_of_node, tail_of_node, lenk_of_node;
  for (int64_t i = 0; i < nk; i++) {
    if (prv[i] >= 0) continue;
    uint32_t nid = (uint32_t)head_of_node.size();
    int64_t x = i, d = 0, last = i;
    for (;;) {
      node_of[x] = nid;
      dist[x] = (uint32_t)d;
      last = x;
      if (nxt[x] < 0) break;
      x = nxt[x];
      d++;
    }
    head_of_node.push_back(i);
    tail_of_node.push_back(last);
    lenk_of_node.push_back(d + 1);
  }
  int64_t n_nodes = (int64_t)head_of_node.size();

  int64_t total = 0;
  std::vector<uint32_t> starts(n_nodes);
  for (int64_t n = 0; n < n_nodes; n++) {
    starts[n] = (uint32_t)total;
    total += lenk_of_node[n] + k - 1;
  }

  out->n_nodes = n_nodes;
  out->total_bases = total;
  out->node_start = (uint32_t*)std::malloc(4 * n_nodes);
  out->node_len = (uint32_t*)std::malloc(4 * n_nodes);
  out->node_exts = (uint8_t*)std::malloc(n_nodes);
  out->node_ec = (uint32_t*)std::malloc(4 * n_nodes);
  out->l_edge = (int32_t*)std::malloc(4 * 4 * n_nodes);
  out->r_edge = (int32_t*)std::malloc(4 * 4 * n_nodes);
  out->seq_pool = (uint8_t*)std::malloc((size_t)std::max<int64_t>(1, total));
  out->kmer_node = (uint32_t*)std::malloc(4 * nk);
  out->kmer_offset = (uint32_t*)std::malloc(4 * nk);
  if (!out->node_start || !out->node_len || !out->node_exts || !out->node_ec ||
      !out->l_edge || !out->r_edge || !out->seq_pool || !out->kmer_node ||
      !out->kmer_offset) {
    pa_graph_free(out);
    return 3;
  }

  std::memcpy(out->kmer_node, node_of.data(), 4 * nk);
  std::memcpy(out->kmer_offset, dist.data(), 4 * nk);

  auto find = [&](U128 v) -> int64_t {
    auto it = std::lower_bound(kmers.begin(), kmers.end(), v);
    if (it == kmers.end() || !(*it == v)) return -1;
    return it - kmers.begin();
  };

  for (int64_t n = 0; n < n_nodes; n++) {
    int64_t h = head_of_node[n], t = tail_of_node[n];
    out->node_start[n] = starts[n];
    out->node_len[n] = (uint32_t)(lenk_of_node[n] + k - 1);
    out->node_exts[n] = (uint8_t)((exts[h] & 0xF0) | (exts[t] & 0x0F));
    out->node_ec[n] = ec[h];
    // sequence: head k-mer bases, then each member's last base
    uint8_t* dst = out->seq_pool + starts[n];
    for (int i = 0; i < k; i++) dst[i] = (uint8_t)base_at(kmers[h], k, i);
    int64_t x = nxt[h];
    int64_t p = k;
    while (x >= 0) {
      dst[p++] = (uint8_t)(kmers[x].lo & 3);
      x = nxt[x];
    }
    // edges
    for (int b = 0; b < 4; b++) {
      int32_t le = -1, re = -1;
      if ((exts[h] >> (4 + b)) & 1) {
        int64_t j = find(shr2_or_top(kmers[h], (uint64_t)b, k));
        if (j < 0) { pa_graph_free(out); return 4; }  // no output leak

        le = (int32_t)node_of[j];
      }
      if ((exts[t] >> b) & 1) {
        int64_t j = find(shl2_or(kmers[t], (uint64_t)b, k));
        if (j < 0) { pa_graph_free(out); return 4; }
        re = (int32_t)node_of[j];
      }
      out->l_edge[n * 4 + b] = le;
      out->r_edge[n * 4 + b] = re;
    }
  }
  return 0;
}

}  // extern "C"
