// K10, the graph-sharded walk's steps: the walk of K2 cut at every graph
// access, so that the node rows and compare windows can come from the shard
// that owns the node (K11, gfetch.cu, behind two all_to_alls).
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::_walk in its global mode
// (fetch = parallel/sharded_index.py::_routed_fetch_factory, cond_all =
// psum-OR): the left body's two fetches (:799 row and window, :820 the
// successor's row), the forward body's one (:944), and the output encoding.
//
// One thread per read.  The read's walk state lives in device memory
// between launches, st [B, NSTATE] int32 (the column enum below, the
// order of pseudoaligner_torch/parallel/graph_walk.py), beside the
// [B, max_nodes, 2] (node, ec) push buffer.  The host loop
// (graph_walk.py) runs the steps in lockstep over the shards and decides,
// from an all_reduce of the shards' any-active flags, whether another
// iteration runs; a read only advances while it is active, so the trip
// count changes no result.  Each step writes the request of the fetch that
// follows it, req [S, B, 2]: slot [owner, lane] = (node, delta) with owner
// = min(node / Nb, S - 1), every other slot (-1, 0), the "no request"
// marker the owner skips (the reference fetches node 0 for them; no lane
// reads those responses).  The responses come back as back [S, B, 12 + WW]:
// a lane reads back[owner, lane], the node row and, for windowed fetches,
// WW words of 2-bit bases ascending from the row's start + delta.
//
// Entries:
//   init     nh3[b, 0] -> both loops' start state (the left gate
//            floorf(0.2f * len) in float32, as K2), the push buffer set to
//            -1, the first left request (row and window, delta pko - (L-1))
//            and the first forward request (row and window, delta koff + k);
//   left_a   the left body up to the successor: the descending segment
//            compare against the window (base nstart + pko - i is window
//            position L-1-i), coverage, mismatches, last_pos, and l_edge of
//            the next read base; requests the successor's row (delta 0);
//   left_b   the successor's row: push (node, ec), node, pko = len - k;
//            requests the next left fetch of the lanes still active;
//   forward  the forward body: push, the ascending segment compare against
//            the window, then follow r_edge or re-seed from the nh3 row
//            (eager seeds: kpart turns lazy seeds off); requests the next
//            forward fetch;
//   finish   capped (a cap left a loop active, or pushes beyond max_nodes)
//            and common.cuh's output encoding, shared with K2: the stored
//            pushes are replayed through it as K2 feeds it its live ones.
//
// Bound on the H100: launch latency.  Each step does one read's handful of
// loads and a compare of at most L bases; at B = 65,536 a step moves a few
// MB.  The state round trip through device memory and the host's
// per-iteration liveness read are the price of the routed fetch.

#include "common.cuh"

namespace {

// the columns of st, in the order of graph_walk.py's state columns
enum {
  L_ACT,   // left loop: the read is active
  L_NODE,  // left loop: current node
  L_PKO,   // left loop: offset in the node
  L_LAST,  // left loop: last read position still to compare
  F_ACT,   // forward loop: the read is active
  F_NODE,  // forward loop: current node
  F_KOFF,  // forward loop: the k-mer's offset in the node
  F_KPOS,  // forward loop: the k-mer's read position
  COV,     // coverage
  MM,      // mismatches
  NN,      // pushes (may exceed max_nodes)
  FOLLOW,  // left_a -> left_b: the successor node, or -1
  NSTATE
};

struct Geo {
  int S, Nb, WW;
};

__device__ __forceinline__ int owner_of(const Geo& g, int node) {
  return min(node / g.Nb, g.S - 1);
}

// lane b's column of req [S, B, 2]: (node, delta) at its owner's slot when
// node >= 0, (-1, 0) everywhere else
__device__ __forceinline__ void write_request(const Geo& g, int B, int b,
                                              int32_t* req, int node,
                                              int delta) {
  const int o = node >= 0 ? owner_of(g, node) : -1;
  for (int s = 0; s < g.S; s++) {
    int32_t* r = req + ((size_t)s * B + b) * 2;
    r[0] = s == o ? node : -1;
    r[1] = s == o ? delta : 0;
  }
}

// lane b's response from the owner of `node`: the 12-int row, then the
// window words (when the fetch had them)
__device__ __forceinline__ const int32_t* response(const Geo& g, int B, int b,
                                                   const int32_t* back,
                                                   int width, int node) {
  return back + ((size_t)owner_of(g, node) * B + b) * width;
}

__device__ __forceinline__ void push(int32_t* mybuf, int M, int32_t* s,
                                     int node, int ec) {
  const int nn = s[NN];
  if (nn < M) {
    mybuf[2 * nn] = node;
    mybuf[2 * nn + 1] = ec;
  }
  s[NN] = nn + 1;
}

__global__ void gwalk_init_kernel(pa::Params p, Geo g,
                                  const int32_t* __restrict__ nh3,
                                  const int32_t* __restrict__ lens,
                                  int32_t* __restrict__ st,
                                  int32_t* __restrict__ buf,
                                  int32_t* __restrict__ req_l,
                                  int32_t* __restrict__ req_f) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int32_t* t = nh3 + (size_t)b * p.P * 3;
  const int q0 = t[0], node0 = t[1], off0 = t[2];
  const bool seeded = q0 < p.P;
  const int thresh = (int)floorf(__fmul_rn(p.left_frac, (float)lens[b]));
  const bool lact = seeded && q0 >= thresh;
  const int pko = off0 > 0 ? off0 - 1 : 0;
  int32_t* s = st + (size_t)b * NSTATE;
  s[L_ACT] = lact;
  s[L_NODE] = node0;
  s[L_PKO] = pko;
  s[L_LAST] = q0 - 1;
  s[F_ACT] = seeded;
  s[F_NODE] = node0;
  s[F_KOFF] = off0;
  s[F_KPOS] = q0;
  s[COV] = s[MM] = s[NN] = 0;
  s[FOLLOW] = -1;
  int32_t* mybuf = buf + (size_t)b * p.max_nodes * 2;
  for (int i = 0; i < 2 * p.max_nodes; i++) mybuf[i] = -1;
  write_request(g, p.B, b, req_l, lact ? node0 : -1, pko - (p.L - 1));
  write_request(g, p.B, b, req_f, seeded ? node0 : -1, off0 + p.k);
}

__global__ void gwalk_left_a_kernel(pa::Params p, Geo g,
                                    const uint32_t* __restrict__ packed,
                                    const int32_t* __restrict__ back,
                                    int32_t* __restrict__ st,
                                    int32_t* __restrict__ req) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  int32_t* s = st + (size_t)b * NSTATE;
  int follow = -1;
  if (s[L_ACT]) {
    const uint32_t* read = packed + (size_t)b * p.nw;
    const int pko = s[L_PKO], last_pos = s[L_LAST];
    const int32_t* r = response(g, p.B, b, back, 12 + g.WW, s[L_NODE]);
    const uint32_t* win = reinterpret_cast<const uint32_t*>(r + 12);
    const int maxm = min(last_pos + 1, pko + 1);
    int matched, seen;
    const bool prem = pa::segment_compare(
        maxm, p.allowed, -1, pa::window_words(win, g.WW), p.L - 1,
        pa::window_words(read, p.nw), last_pos, &matched, &seen);
    s[COV] += matched;
    s[MM] += seen;
    const int lp2 = last_pos - matched;
    if (!((last_pos + 1 - matched == 0) || prem)) {
      const int nb = pa::base_at(read, lp2);
      if ((r[2] >> (4 + nb)) & 1) follow = r[8 + nb];
    }
    s[L_LAST] = lp2;
  }
  s[FOLLOW] = follow;
  write_request(g, p.B, b, req, follow, 0);
}

__global__ void gwalk_left_b_kernel(pa::Params p, Geo g,
                                    const int32_t* __restrict__ back,
                                    int32_t* __restrict__ st,
                                    int32_t* __restrict__ buf,
                                    int32_t* __restrict__ req) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  int32_t* s = st + (size_t)b * NSTATE;
  const int f = s[FOLLOW];
  if (f >= 0) {
    const int32_t* r = response(g, p.B, b, back, 12, f);
    push(buf + (size_t)b * p.max_nodes * 2, p.max_nodes, s, f, r[3]);
    s[L_NODE] = f;
    s[L_PKO] = r[1] - p.k;
  }
  s[L_ACT] = f >= 0;
  write_request(g, p.B, b, req, f >= 0 ? f : -1, s[L_PKO] - (p.L - 1));
}

__global__ void gwalk_forward_kernel(pa::Params p, Geo g,
                                     const uint32_t* __restrict__ packed,
                                     const int32_t* __restrict__ lens,
                                     const int32_t* __restrict__ nh3,
                                     const int32_t* __restrict__ back,
                                     int32_t* __restrict__ st,
                                     int32_t* __restrict__ buf,
                                     int32_t* __restrict__ req) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  int32_t* s = st + (size_t)b * NSTATE;
  const int k = p.k;
  bool active = s[F_ACT];
  int node = s[F_NODE], koff = s[F_KOFF];
  if (active) {
    const uint32_t* read = packed + (size_t)b * p.nw;
    const int len = lens[b];
    const int32_t* r = response(g, p.B, b, back, 12 + g.WW, node);
    const uint32_t* win = reinterpret_cast<const uint32_t*>(r + 12);
    int kpos = s[F_KPOS] + k;
    int cov = s[COV] + k;
    push(buf + (size_t)b * p.max_nodes * 2, p.max_nodes, s, node, r[3]);
    const int ref_off = koff + k;
    const int maxm = max(min(len - kpos, r[1] - ref_off), 0);
    int matched, seen;
    const bool prem = pa::segment_compare(
        maxm, p.allowed, 1, pa::window_words(win, g.WW), 0,
        pa::window_words(read, p.nw), kpos, &matched, &seen);
    kpos += matched;
    cov += matched;
    s[MM] += seen;
    if (kpos >= len) {
      active = false;
    } else {
      const int nb = pa::base_at(read, kpos);
      if (!prem && ((r[2] >> nb) & 1)) {
        node = r[4 + nb];
        koff = 0;
        kpos -= k - 1;
        cov -= k - 1;
      } else if (kpos > len - k) {
        active = false;
      } else {
        const int32_t* t = nh3 + ((size_t)b * p.P + kpos) * 3;
        if (t[0] < p.P) {
          kpos = t[0];
          node = t[1];
          koff = t[2];
        } else {
          active = false;
        }
      }
    }
    s[F_ACT] = active;
    s[F_NODE] = node;
    s[F_KOFF] = koff;
    s[F_KPOS] = kpos;
    s[COV] = cov;
  }
  write_request(g, p.B, b, req, active ? node : -1, koff + k);
}

__global__ void gwalk_finish_kernel(pa::Params p,
                                    const int32_t* __restrict__ st,
                                    const int32_t* __restrict__ buf,
                                    pa::WalkOut o) {
  extern __shared__ int4 smem4[];
  int32_t* s_slots = reinterpret_cast<int32_t*>(smem4);  // [dc][blockDim]
  const int b0 = blockIdx.x * blockDim.x, nb = min((int)blockDim.x, p.B - b0);
  pa::walk_out_begin(p, b0, nb, o);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  const int b = b0 + threadIdx.x;
  const int32_t* s = st + (size_t)b * NSTATE;
  const int32_t* mybuf = buf + (size_t)b * p.max_nodes * 2;
  // the stored pushes, through the same encoding as K2's live ones
  pa::Pushes out(p, o, b, s_slots + threadIdx.x, blockDim.x);
  const int n = min(s[NN], p.max_nodes);
  for (int i = 0; i < n; i++) out.push(p, mybuf[2 * i], mybuf[2 * i + 1]);
  out.nn = s[NN];
  const bool capped = (p.lcap > 0 && s[L_ACT]) || (p.wcap > 0 && s[F_ACT]) ||
                      s[NN] > p.max_nodes;
  pa::encode_output(p, b, out, s[COV], s[MM], capped, o);
}

constexpr int THREADS = 128;

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace

// Every entry: params = ops/kernels.py's launch parameters (PARAM_NAMES),
// geo = {S, Nb, WW}.  Returns a cudaError_t.

extern "C" int pa_gwalk_init(const int64_t* params, const int64_t* geo,
                             float left_frac, int device, const int32_t* nh3,
                             const int32_t* lens, int32_t* st, int32_t* buf,
                             int32_t* req_l, int32_t* req_f, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const pa::Params p = pa::params_from(params, left_frac);
  if (p.B == 0) return 0;
  const Geo g{(int)geo[0], (int)geo[1], (int)geo[2]};
  gwalk_init_kernel<<<blocks_for(p.B), THREADS, 0, (cudaStream_t)stream>>>(
      p, g, nh3, lens, st, buf, req_l, req_f);
  return (int)cudaGetLastError();
}

extern "C" int pa_gwalk_left_a(const int64_t* params, const int64_t* geo,
                               int device, const uint32_t* packed,
                               const int32_t* back, int32_t* st, int32_t* req,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const Geo g{(int)geo[0], (int)geo[1], (int)geo[2]};
  gwalk_left_a_kernel<<<blocks_for(p.B), THREADS, 0, (cudaStream_t)stream>>>(
      p, g, packed, back, st, req);
  return (int)cudaGetLastError();
}

extern "C" int pa_gwalk_left_b(const int64_t* params, const int64_t* geo,
                               int device, const int32_t* back, int32_t* st,
                               int32_t* buf, int32_t* req, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const Geo g{(int)geo[0], (int)geo[1], (int)geo[2]};
  gwalk_left_b_kernel<<<blocks_for(p.B), THREADS, 0, (cudaStream_t)stream>>>(
      p, g, back, st, buf, req);
  return (int)cudaGetLastError();
}

extern "C" int pa_gwalk_forward(const int64_t* params, const int64_t* geo,
                                int device, const uint32_t* packed,
                                const int32_t* lens, const int32_t* nh3,
                                const int32_t* back, int32_t* st,
                                int32_t* buf, int32_t* req, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const Geo g{(int)geo[0], (int)geo[1], (int)geo[2]};
  gwalk_forward_kernel<<<blocks_for(p.B), THREADS, 0, (cudaStream_t)stream>>>(
      p, g, packed, lens, nh3, back, st, buf, req);
  return (int)cudaGetLastError();
}

extern "C" int pa_gwalk_finish(const int64_t* params, int device,
                               const int32_t* st, const int32_t* buf,
                               uint8_t* mapped, void* coverage,
                               int32_t* mismatches, int32_t* n_nodes,
                               void* ec_distinct, int32_t* nodes,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const pa::Params p = pa::params_from(params, 0.0f);
  if (p.B == 0) return 0;
  const size_t smem = (size_t)4 * THREADS * p.dc;  // <= 32 KB: dc <= 64
  const pa::WalkOut o{mapped, coverage, mismatches, n_nodes, ec_distinct,
                      nodes};
  gwalk_finish_kernel<<<blocks_for(p.B), THREADS, smem,
                        (cudaStream_t)stream>>>(p, st, buf, o);
  return (int)cudaGetLastError();
}
