// K2, the walk kernel: per read, left extension, the forward unitig walk
// and the output encoding.
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::_walk (left extension,
// forward walk, compact output) with its helpers _segment_math, _push,
// _kmer_at, _base_at and the window compares (_extract_pool_window_rows,
// _extract_read_window, _mismatch_bits).
//
// One thread per read runs the reference's scalar loop
// (ops/native/mapper.cpp::map_one, src/pseudoaligner.rs:64-319) with the
// device engine's additions:
//   - seeding from nh3[b, 0]; the left gate is floorf(0.2f * len) in float32;
//   - iteration caps: max_left_iters on the left loop, max_walk_iters on the
//     forward loop, where each lazy seek probe costs one whole iteration;
//     a read still active at a cap, or with more pushes than max_nodes, is
//     "capped" (-3);
//   - lazy re-seeds (cuckoo and bucket1): on-grid positions (kpos % 3 == 0)
//     read nh3's row kpos / 3 (the table holds the residue-0 grid alone;
//     row kpos under eager seeds), off-grid positions probe the seed index
//     in place (common.cuh seed_probe) and step by 3 on a miss;
//   - on K1's step form of the table (seed.cu, first-hit seeding; the
//     entry sets Params::first_hit from its call path), a read whose first
//     hit is position 0 has row 0 alone: each of its re-seeds
//     that would read a row probes kpos, kpos + 3, ... up to len - k in
//     place, within the same iteration, and takes the first hit, which is
//     the row's content, so iteration counts and outputs are unchanged.
//     Such reads seldom re-seed (more than the mismatch budget inside one
//     segment, or an error on a branch base); the probes are counted
//     (warp-aggregated) into pa.walk.inplace_probes;
//   - output: compact run-length EC ids in distinct_cap slots (-2 on
//     overflow, -3 when capped, int16/uint8 narrowing), or the full node
//     list when distinct_cap == 0.
// The segment compare and the output encoding are common.cuh's, shared
// with the graph-sharded walk's steps (K10, gwalk.cu).
//
// Bound on the H100: a latency-bound, divergent pointer chase.  Each step
// reads a 48-byte node row, a few pool words and, on seek, the seed
// index's bucket rows, all dependent loads from tables far larger than L2
// at GENCODE scale; reads finish after different numbers of steps, so warps
// diverge.  The walk stays one thread per read, and the design takes the
// waste out around it:
//   - the block's reads are loaded once, coalesced, into shared memory, one
//     column per thread ([nw + 2][threads], zero words at both ends), where
//     any base or word is one bank-conflict-free load (a register array
//     indexed at run time would sit in local memory);
//   - the segment compare runs 16 bases per step on word windows
//     (common.cuh segment_compare), not two base loads per base;
//   - a node row is read as 16-byte loads: (start, len, exts, ec) and the
//     edge quad the loop follows;
//   - no push buffer in device memory.  The compact shape run-length
//     compacts the class ids online into its dc slots, a shared-memory
//     column per thread; the full shape sets the block's rows of nodes to
//     -1 with 16-byte stores and then writes each push straight to its
//     slot, so every read keeps full occupancy whatever max_nodes is
//     (staging max_nodes ids per thread on chip would cap a block at a few
//     warps per SM at max_nodes 120-192);
//   - W is a template parameter, so the lazy seek's k-mer (cut from the
//     read's words, common.cuh kmer_words) and bucket rows stay in
//     registers.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int edge(const int4& e, int nb) {
  return nb == 0 ? e.x : nb == 1 ? e.y : nb == 2 ? e.z : e.w;
}

template <int W>
__global__ void walk_kernel(pa::Params p,
                            const __grid_constant__ pa::Levels lv,
                            const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ nh3,
                            const uint32_t* __restrict__ pool,
                            const int32_t* __restrict__ node_row, pa::Index ix,
                            pa::WalkOut o,
                            unsigned long long* __restrict__ inplace) {
  extern __shared__ int4 smem4[];
  const int T = blockDim.x, t = threadIdx.x;
  const int nw = p.nw;
  uint32_t* s_read = reinterpret_cast<uint32_t*>(smem4);  // [nw + 2][T]
  int32_t* s_slots = reinterpret_cast<int32_t*>(s_read + (nw + 2) * T);
  const int b0 = blockIdx.x * T, nb = min(T, p.B - b0);
  for (int i = t; i < nb * nw; i += T) {
    const int r = i / nw, q = i - r * nw;
    s_read[(q + 1) * T + r] = packed[(size_t)b0 * nw + i];
  }
  s_read[t] = 0u;
  s_read[(nw + 1) * T + t] = 0u;
  pa::walk_out_begin(p, b0, nb, o);
  __syncthreads();
  if (t >= nb) return;

  const int b = b0 + t;
  const int k = p.k, P = p.P, M = p.max_nodes, allowed = p.allowed;
  const int32_t* tbl = nh3 + (size_t)b * pa::nh3_rows(P, p.lazy) * 3;
  const int len = lens[b];
  const int4* rows = reinterpret_cast<const int4*>(node_row);  // 3 per node
  auto rd = [&](int q) { return s_read[(q + 1) * T + t]; };
  auto pw = [&](int q) { return __ldg(pool + q); };
  pa::Pushes out(p, o, b, s_slots + t, T);
  int cov = 0, mm = 0;

  const int q0 = tbl[0], node0 = tbl[1], off0 = tbl[2];
  const bool seeded = q0 < P;
  // K1's step form wrote row 0 alone for a read whose first hit is 0
  const bool rowless = p.first_hit && q0 == 0;
  int n_inplace = 0;
  bool capped = false;

  // ---- left extension (src/pseudoaligner.rs:124-205) ----
  const int thresh = (int)floorf(__fmul_rn(p.left_frac, (float)len));
  if (seeded && q0 >= thresh) {
    int node = node0;
    int pko = off0 > 0 ? off0 - 1 : 0;
    int last_pos = q0 - 1;
    bool active = true;
    for (int it = 0; active && (p.lcap == 0 || it < p.lcap); it++) {
      const int4 a = __ldg(rows + (size_t)node * 3);  // start, len, exts, ec
      const int4 le = __ldg(rows + (size_t)node * 3 + 2);  // l_edge
      const int maxm = min(last_pos + 1, pko + 1);
      int matched, seen;
      const bool prem = pa::segment_compare(maxm, allowed, -1, pw, a.x + pko,
                                            rd, last_pos, &matched, &seen);
      cov += matched;
      mm += seen;
      const bool stop = (last_pos + 1 - matched == 0) || prem;
      const int lp2 = last_pos - matched;
      active = false;
      if (!stop) {
        const int nb = pa::base_of(rd, lp2);
        if ((a.z >> (4 + nb)) & 1) {
          const int nxt = edge(le, nb);
          const int4 nx = __ldg(rows + (size_t)nxt * 3);
          out.push(p, nxt, nx.w);
          node = nxt;
          pko = nx.y - k;
          active = true;
        }
      }
      last_pos = lp2;
    }
    capped = p.lcap > 0 && active;
  }

  // ---- forward walk (src/pseudoaligner.rs:208-302) ----
  if (seeded) {
    int node = node0, koff = off0, kpos = q0;
    bool active = true, seeking = false;
    for (int it = 0; active && (p.wcap == 0 || it < p.wcap); it++) {
      if (seeking) {
        // one exact probe at kpos costs this whole iteration
        int pn, po;
        uint32_t w[W];
        pa::kmer_words<W>(rd, kpos, k, w);
        pa::seed_probe<W>(p, lv, ix, w, &pn, &po);
        if (pn >= 0) {
          node = pn;
          koff = po;
          seeking = false;
        } else {
          kpos += 3;
          active = seeking = kpos <= len - k;
        }
        continue;
      }
      const int4 a = __ldg(rows + (size_t)node * 3);  // start, len, exts, ec
      const int4 re = __ldg(rows + (size_t)node * 3 + 1);  // r_edge
      kpos += k;
      cov += k;
      out.push(p, node, a.w);
      const int ref_off = koff + k;
      const int maxm = max(min(len - kpos, a.y - ref_off), 0);
      int matched, seen;
      const bool prem = pa::segment_compare(maxm, allowed, 1, pw,
                                            a.x + ref_off, rd, kpos, &matched,
                                            &seen);
      kpos += matched;
      cov += matched;
      mm += seen;
      if (kpos >= len) {
        active = false;
        continue;
      }
      const int nb = pa::base_of(rd, kpos);
      if (!prem && ((a.z >> nb) & 1)) {
        node = edge(re, nb);
        koff = 0;
        kpos -= k - 1;
        cov -= k - 1;
      } else if (kpos > len - k) {
        active = false;
      } else if (p.lazy && kpos % 3 != 0) {
        seeking = true;
      } else if (rowless) {
        // the row's next hit on kpos's grid, probed here
        int q = kpos, pn = -1, po = -1;
        for (; q <= len - k; q += 3) {
          uint32_t w[W];
          pa::kmer_words<W>(rd, q, k, w);
          pa::seed_probe<W>(p, lv, ix, w, &pn, &po);
          n_inplace++;
          if (pn >= 0) break;
        }
        if (pn >= 0) {
          kpos = q;
          node = pn;
          koff = po;
        } else {
          active = false;
        }
      } else {
        const int32_t* row = tbl + (size_t)(p.lazy ? kpos / 3 : kpos) * 3;
        if (row[0] < P) {
          kpos = row[0];
          node = row[1];
          koff = row[2];
        } else {
          active = false;
        }
      }
    }
    capped = capped || (p.wcap > 0 && active);
  }
  capped = capped || out.nn > M;

  // ---- output ----
  pa::encode_output(p, b, out, cov, mm, capped, o);
  if (p.first_hit && inplace != nullptr) {
    const unsigned lanes = __activemask();
    const int n = __reduce_add_sync(lanes, n_inplace);
    if (n > 0 && (t & 31) == __ffs(lanes) - 1)
      atomicAdd(inplace, (unsigned long long)n);
  }
}

template <int W>
cudaError_t launch_walk(const pa::Params& p, const pa::Levels& lv,
                        const uint32_t* packed, const int32_t* lens,
                        const int32_t* nh3, const uint32_t* pool,
                        const int32_t* node_row, const pa::Index& ix,
                        const pa::WalkOut& o, unsigned long long* inplace,
                        cudaStream_t stream) {
  const size_t smem = (size_t)4 * THREADS * (p.nw + 2 + p.dc);
  cudaError_t e = pa::allow_smem(walk_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + THREADS - 1) / THREADS;
  walk_kernel<W><<<blocks, THREADS, smem, stream>>>(
      p, lv, packed, lens, nh3, pool, node_row, ix, o, inplace);
  return cudaGetLastError();
}

}  // namespace

// first_hit: 0 when nh3 is a whole table, 1 for K1's step form; inplace:
// null, or the int64 counter the in-place re-seed probes are added to.
extern "C" int pa_walk(const int64_t* params, const int64_t* index,
                       float left_frac, int device, const uint32_t* packed,
                       const int32_t* lens, const int32_t* nh3,
                       const uint32_t* pool, const int32_t* node_row,
                       uint8_t* mapped, void* coverage, int32_t* mismatches,
                       int32_t* n_nodes, void* ec_distinct, int32_t* nodes,
                       int first_hit, unsigned long long* inplace,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, left_frac);
  p.first_hit = first_hit;
  if (p.B == 0) return 0;
  const pa::Levels lv = pa::levels_from(params);
  const pa::Index ix = pa::index_from(index);
  const pa::WalkOut o{mapped, coverage, mismatches, n_nodes, ec_distinct,
                      nodes};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)pa::with_w(p.W, [&](auto w) {
    return launch_walk<decltype(w)::value>(p, lv, packed, lens, nh3, pool,
                                           node_row, ix, o, inplace, st);
  });
}
