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
//   - lazy re-seeds: on-grid positions (kpos % 3 == 0) read nh3, off-grid
//     positions probe the cuckoo table in place and step by 3 on a miss;
//   - output: compact run-length EC ids in distinct_cap slots (-2 on
//     overflow, -3 when capped, int16/uint8 narrowing), or the full node
//     list when distinct_cap == 0.
// The (node, ec) push buffer is the wrapper's [B, max_nodes, 2] scratch;
// only the first max_nodes pushes are stored, n_nodes counts all.
//
// Bound on the H100: a latency-bound, divergent pointer chase.  Each step
// reads a 48-byte node row, a few pool words and, on seek, two cuckoo
// buckets, all dependent loads from tables far larger than L2 at GENCODE
// scale; reads finish after different numbers of steps, so warps diverge.
// This first version keeps one thread per read and relies on many reads in
// flight to hide latency; warp-cooperative walks are later work.

#include "common.cuh"

namespace {

__global__ void walk_kernel(pa::Params p, const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ nh3,
                            const uint32_t* __restrict__ pool,
                            const int32_t* __restrict__ node_row,
                            const uint32_t* __restrict__ cuckoo,
                            const uint32_t* __restrict__ vals,
                            int32_t* __restrict__ buf,
                            uint8_t* __restrict__ mapped_out,
                            void* __restrict__ cov_out,
                            int32_t* __restrict__ mm_out,
                            int32_t* __restrict__ nn_out,
                            void* __restrict__ dist_out,
                            int32_t* __restrict__ nodes_out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int k = p.k, P = p.P, M = p.max_nodes, allowed = p.allowed;
  const uint32_t* read = packed + (size_t)b * p.nw;
  const int32_t* tbl = nh3 + (size_t)b * P * 3;
  const int len = lens[b];
  int32_t* mybuf = buf + (size_t)b * M * 2;
  for (int i = 0; i < 2 * M; i++) mybuf[i] = -1;

  int cov = 0, mm = 0, nn = 0;
  auto push = [&](int node, int ec) {
    if (nn < M) {
      mybuf[2 * nn] = node;
      mybuf[2 * nn + 1] = ec;
    }
    nn++;
  };

  const int q0 = tbl[0], node0 = tbl[1], off0 = tbl[2];
  const bool seeded = q0 < P;
  bool capped = false;

  // ---- left extension (src/pseudoaligner.rs:124-205) ----
  const int thresh = (int)floorf(__fmul_rn(p.left_frac, (float)len));
  if (seeded && q0 >= thresh) {
    int node = node0;
    int pko = off0 > 0 ? off0 - 1 : 0;
    int last_pos = q0 - 1;
    bool active = true;
    for (int it = 0; active && (p.lcap == 0 || it < p.lcap); it++) {
      const int32_t* nr = node_row + (size_t)node * 12;
      const int nstart = nr[0];
      const int maxm = min(last_pos + 1, pko + 1);
      int matched = 0, seen = 0;
      bool prem = false;
      for (int i = 0; i < maxm; i++) {
        if (pa::base_at(pool, nstart + pko - i) !=
            pa::base_at(read, last_pos - i)) {
          if (++seen > allowed) {
            prem = true;
            break;
          }
        }
        matched++;
      }
      cov += matched;
      mm += seen;
      const bool stop = (last_pos + 1 - matched == 0) || prem;
      const int lp2 = last_pos - matched;
      active = false;
      if (!stop) {
        const int nb = pa::base_at(read, lp2);
        if ((nr[2] >> (4 + nb)) & 1) {
          const int nxt = nr[8 + nb];
          const int32_t* nx = node_row + (size_t)nxt * 12;
          push(nxt, nx[3]);
          node = nxt;
          pko = nx[1] - k;
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
    uint32_t w[pa::MAX_W];
    for (int it = 0; active && (p.wcap == 0 || it < p.wcap); it++) {
      if (seeking) {
        // one exact probe at kpos costs this whole iteration
        int pn, po;
        pa::kmer_words(read, kpos, k, p.W, w);
        pa::cuckoo_probe(p, cuckoo, vals, w, &pn, &po);
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
      const int32_t* nr = node_row + (size_t)node * 12;
      kpos += k;
      cov += k;
      push(node, nr[3]);
      const int ref_off = koff + k;
      const int nstart = nr[0] + ref_off;
      const int maxm = max(min(len - kpos, nr[1] - ref_off), 0);
      int matched = 0, seen = 0;
      bool prem = false;
      for (int i = 0; i < maxm; i++) {
        if (pa::base_at(pool, nstart + i) != pa::base_at(read, kpos + i)) {
          if (++seen > allowed) {
            prem = true;
            break;
          }
        }
        matched++;
      }
      kpos += matched;
      cov += matched;
      mm += seen;
      if (kpos >= len) {
        active = false;
        continue;
      }
      const int nb = pa::base_at(read, kpos);
      if (!prem && ((nr[2] >> nb) & 1)) {
        node = nr[4 + nb];
        koff = 0;
        kpos -= k - 1;
        cov -= k - 1;
      } else if (kpos > len - k) {
        active = false;
      } else if (p.lazy && kpos % 3 != 0) {
        seeking = true;
      } else {
        const int32_t* t = tbl + (size_t)kpos * 3;
        if (t[0] < P) {
          kpos = t[0];
          node = t[1];
          koff = t[2];
        } else {
          active = false;
        }
      }
    }
    capped = capped || (p.wcap > 0 && active);
  }
  capped = capped || nn > M;

  // ---- output ----
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

}  // namespace

extern "C" int pa_walk(const int64_t* params, float left_frac, int device,
                       const uint32_t* packed, const int32_t* lens,
                       const int32_t* nh3, const uint32_t* pool,
                       const int32_t* node_row, const uint32_t* cuckoo,
                       const uint32_t* vals, int32_t* buf, uint8_t* mapped,
                       void* coverage, int32_t* mismatches, int32_t* n_nodes,
                       void* ec_distinct, int32_t* nodes, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  pa::Params p = pa::params_from(params, left_frac);
  if (p.B == 0) return 0;
  const int threads = 128;
  int blocks = (p.B + threads - 1) / threads;
  walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, packed, lens, nh3, pool, node_row, cuckoo, vals, buf, mapped,
      coverage, mismatches, n_nodes, ec_distinct, nodes);
  return (int)cudaGetLastError();
}
