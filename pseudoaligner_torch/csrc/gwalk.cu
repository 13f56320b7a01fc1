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
// Bound on the H100: launch latency and the latency of a few dependent
// loads; bytes only in init.  Every entry runs over all B lanes, though
// after the first iteration only a few percent are still active, so a
// step's traffic is mostly the lanes' state rows (48 bytes each, 3.1 MB
// at B = 65,536) and request slots.  Each warp stages its 32 lanes'
// contiguous state rows in shared memory with 16-byte loads, 512
// contiguous bytes per instruction, and waits for itself alone; each
// thread then takes its row in three 16-byte shared loads (a 48-byte
// stride is free of bank conflicts for 16-byte accesses).  A lane writes
// its row back, three 16-byte stores, only when the step changed it: most
// lanes are inactive and write only their request slots, one 8-byte store
// per shard (a warp's 256 contiguous bytes for each).  init writes every
// row, so it stages them and each warp writes its rows back as it read
// them.  An active lane reads its response's node row in 16-byte loads
// where the response width keeps rows on 16 bytes (the serving shape's 16
// words and the rows-only fetch's 12).  init sets the block's contiguous
// range of the push buffer to -1 with block-wide 16-byte stores (as K2's
// full output does).  finish stages the state rows like the steps; then
// each lane reads its stored pushes itself, eight 8-byte loads in flight
// at a time.  The alternatives measured on the H100 (PERF.md §6): a
// block-wide stage and write-back (a barrier per stage, and the whole
// 3.1 MB rewritten each step, since a block of 128 lanes almost always
// holds an active one), and staging the push buffer in shared memory for
// finish (one more dependent round trip when only the pieces a lane
// replays are read), were slower.

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
static_assert(NSTATE % 4 == 0, "state rows move as int4");

constexpr int THREADS = 128;   // lanes per block
constexpr int PUSH_LOADS = 8;  // finish: pushes read at a time per lane

struct Geo {
  int S, Nb, WW;
};

__device__ __forceinline__ int owner_of(const Geo& g, int node) {
  return min(node / g.Nb, g.S - 1);
}

// lane b's column of req [S, B, 2]: (node, delta) at its owner's slot when
// node >= 0, (-1, 0) everywhere else; one 8-byte store per shard
__device__ __forceinline__ void write_request(const Geo& g, int B, int b,
                                              int32_t* req, int node,
                                              int delta) {
  const int o = node >= 0 ? owner_of(g, node) : -1;
  int2* r = reinterpret_cast<int2*>(req) + b;
  for (int s = 0; s < g.S; s++)
    r[(size_t)s * B] = s == o ? make_int2(node, delta) : make_int2(-1, 0);
}

// lane b's response from the owner of `node`: the 12-int row, then the
// window words (when the fetch had them)
__device__ __forceinline__ const int32_t* response(const Geo& g, int B, int b,
                                                   const int32_t* back,
                                                   int width, int node) {
  return back + ((size_t)owner_of(g, node) * B + b) * width;
}

// The response's node row in registers: three 16-byte loads where every
// row starts on 16 bytes (width % 4 == 0: the serving shape's windowed
// fetch, 16 words, and every rows-only fetch, 12), else word by word.
__device__ __forceinline__ void load_row(const int32_t* r, int width,
                                         int32_t (&row)[12]) {
  if (width % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 3; i++) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(r) + i);
      row[4 * i] = v.x;
      row[4 * i + 1] = v.y;
      row[4 * i + 2] = v.z;
      row[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 12; i++) row[i] = __ldg(r + i);
  }
}

// row[at + nb] for a base nb in 0..3, without indexing registers at run
// time (which would put the row in local memory)
__device__ __forceinline__ int edge(const int32_t (&row)[12], int at,
                                    int nb) {
  return at == 4 ? (nb == 0 ? row[4] : nb == 1 ? row[5] : nb == 2 ? row[6]
                                                                  : row[7])
                 : (nb == 0 ? row[8] : nb == 1 ? row[9] : nb == 2 ? row[10]
                                                                  : row[11]);
}

// lane b's push of (node, ec) into its row of buf [B, M, 2] (kept when
// fewer than M came before it), one 8-byte store
__device__ __forceinline__ void push(int32_t* buf, int M, int b,
                                     int32_t (&s)[NSTATE], int node, int ec) {
  const int nn = s[NN];
  if (nn < M)
    reinterpret_cast<int2*>(buf)[(size_t)b * M + nn] = make_int2(node, ec);
  s[NN] = nn + 1;
}

// The block's lanes' rows of st, [nb, NSTATE] from lane b0, staged in
// shared memory warp by warp: each warp moves its 32 lanes' contiguous
// rows (1,536 bytes) with three 16-byte accesses per thread, 512
// contiguous bytes per instruction, and waits only for itself
// (__syncwarp).  load() and flush() are called by every thread of the
// block; get(), put() and store() by the lanes (threadIdx.x < nb) for
// their rows.
struct StateTile {
  int32_t* sm;
  int b0, nb;

  __device__ StateTile(int4* smem, int B)
      : sm(reinterpret_cast<int32_t*>(smem)),
        b0(blockIdx.x * THREADS),
        nb(min(THREADS, B - (int)(blockIdx.x * THREADS))) {}

  __device__ bool mine() const { return (int)threadIdx.x < nb; }
  __device__ int lane() const { return b0 + threadIdx.x; }

  // the warp's rows: first int4 in st and in the stage, and their count
  __device__ int warp0() const { return threadIdx.x & ~31; }
  __device__ int warp_quads() const {
    return max(0, min(32, nb - warp0())) * (NSTATE / 4);
  }

  __device__ void load(const int32_t* st) {
    const int4* src =
        reinterpret_cast<const int4*>(st + (size_t)(b0 + warp0()) * NSTATE);
    int4* dst = reinterpret_cast<int4*>(sm + warp0() * NSTATE);
    for (int i = threadIdx.x & 31; i < warp_quads(); i += 32) dst[i] = src[i];
    __syncwarp();
  }

  __device__ void get(int32_t (&s)[NSTATE]) const {
    const int4* v = reinterpret_cast<const int4*>(sm + threadIdx.x * NSTATE);
#pragma unroll
    for (int i = 0; i < NSTATE / 4; i++) {
      const int4 x = v[i];
      s[4 * i] = x.x;
      s[4 * i + 1] = x.y;
      s[4 * i + 2] = x.z;
      s[4 * i + 3] = x.w;
    }
  }

  __device__ void put(const int32_t (&s)[NSTATE]) {
    int4* v = reinterpret_cast<int4*>(sm + threadIdx.x * NSTATE);
#pragma unroll
    for (int i = 0; i < NSTATE / 4; i++)
      v[i] = make_int4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  }

  // every row of the warp (each put() by its lane) to st, as load() reads
  __device__ void flush(int32_t* st) {
    __syncwarp();
    int4* dst = reinterpret_cast<int4*>(st + (size_t)(b0 + warp0()) * NSTATE);
    const int4* src = reinterpret_cast<const int4*>(sm + warp0() * NSTATE);
    for (int i = threadIdx.x & 31; i < warp_quads(); i += 32) dst[i] = src[i];
  }

  // the lane's own row to st, three 16-byte stores
  __device__ void store(int32_t* st, const int32_t (&s)[NSTATE]) const {
    int4* v = reinterpret_cast<int4*>(st + (size_t)lane() * NSTATE);
#pragma unroll
    for (int i = 0; i < NSTATE / 4; i++)
      v[i] = make_int4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  }
};

__device__ __forceinline__ bool differs(const int32_t (&a)[NSTATE],
                                        const int32_t (&b)[NSTATE]) {
  bool d = false;
#pragma unroll
  for (int i = 0; i < NSTATE; i++) d |= a[i] != b[i];
  return d;
}

__global__ void __launch_bounds__(THREADS)
    gwalk_init_kernel(pa::Params p, Geo g, const int32_t* __restrict__ nh3,
                      const int32_t* __restrict__ lens,
                      int32_t* __restrict__ st, int32_t* __restrict__ buf,
                      int32_t* __restrict__ req_l,
                      int32_t* __restrict__ req_f) {
  __shared__ int4 smem[THREADS * NSTATE / 4];
  StateTile tile(smem, p.B);
  pa::block_fill(buf + (size_t)tile.b0 * p.max_nodes * 2,
                 tile.nb * p.max_nodes * 2, -1);
  if (tile.mine()) {
    const int b = tile.lane();
    const int32_t* t = nh3 + (size_t)b * p.P * 3;
    const int q0 = t[0], node0 = t[1], off0 = t[2];
    const bool seeded = q0 < p.P;
    const int thresh = (int)floorf(__fmul_rn(p.left_frac, (float)lens[b]));
    const bool lact = seeded && q0 >= thresh;
    const int pko = off0 > 0 ? off0 - 1 : 0;
    int32_t s[NSTATE];
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
    tile.put(s);
    write_request(g, p.B, b, req_l, lact ? node0 : -1, pko - (p.L - 1));
    write_request(g, p.B, b, req_f, seeded ? node0 : -1, off0 + p.k);
  }
  tile.flush(st);  // every row is new
}

__global__ void __launch_bounds__(THREADS)
    gwalk_left_a_kernel(pa::Params p, Geo g,
                        const uint32_t* __restrict__ packed,
                        const int32_t* __restrict__ back,
                        int32_t* __restrict__ st, int32_t* __restrict__ req) {
  __shared__ int4 smem[THREADS * NSTATE / 4];
  StateTile tile(smem, p.B);
  tile.load(st);
  if (tile.mine()) {
    const int b = tile.lane();
    int32_t s[NSTATE], s0[NSTATE];
    tile.get(s0);
    tile.get(s);
    int follow = -1;
    if (s[L_ACT]) {
      const uint32_t* read = packed + (size_t)b * p.nw;
      const int pko = s[L_PKO], last_pos = s[L_LAST];
      const int32_t* r = response(g, p.B, b, back, 12 + g.WW, s[L_NODE]);
      int32_t row[12];
      load_row(r, 12 + g.WW, row);
      const uint32_t* win = reinterpret_cast<const uint32_t*>(r + 12);
      const int maxm = min(last_pos + 1, pko + 1);
      int matched, seen;
      const bool prem = pa::segment_compare(
          maxm, p.allowed, -1, pa::window_words(win, g.WW), p.L - 1,
          pa::window_words(read, p.nw), last_pos, &matched, &seen);
      s[COV] += matched;
      s[MM] += seen;
      const int lp2 = last_pos - matched;
      if (!((lp2 + 1 == 0) || prem)) {
        const int nb = pa::base_at(read, lp2);
        if ((row[2] >> (4 + nb)) & 1) follow = edge(row, 8, nb);
      }
      s[L_LAST] = lp2;
    }
    s[FOLLOW] = follow;
    if (differs(s, s0)) tile.store(st, s);
    write_request(g, p.B, b, req, follow, 0);
  }
}

__global__ void __launch_bounds__(THREADS)
    gwalk_left_b_kernel(pa::Params p, Geo g, const int32_t* __restrict__ back,
                        int32_t* __restrict__ st, int32_t* __restrict__ buf,
                        int32_t* __restrict__ req) {
  __shared__ int4 smem[THREADS * NSTATE / 4];
  StateTile tile(smem, p.B);
  tile.load(st);
  if (tile.mine()) {
    const int b = tile.lane();
    int32_t s[NSTATE], s0[NSTATE];
    tile.get(s0);
    tile.get(s);
    const int f = s[FOLLOW];
    if (f >= 0) {
      int32_t row[12];
      load_row(response(g, p.B, b, back, 12, f), 12, row);
      push(buf, p.max_nodes, b, s, f, row[3]);
      s[L_NODE] = f;
      s[L_PKO] = row[1] - p.k;
    }
    s[L_ACT] = f >= 0;
    if (differs(s, s0)) tile.store(st, s);
    write_request(g, p.B, b, req, f >= 0 ? f : -1, s[L_PKO] - (p.L - 1));
  }
}

__global__ void __launch_bounds__(THREADS)
    gwalk_forward_kernel(pa::Params p, Geo g,
                         const uint32_t* __restrict__ packed,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ nh3,
                         const int32_t* __restrict__ back,
                         int32_t* __restrict__ st, int32_t* __restrict__ buf,
                         int32_t* __restrict__ req) {
  __shared__ int4 smem[THREADS * NSTATE / 4];
  StateTile tile(smem, p.B);
  tile.load(st);
  if (tile.mine()) {
    const int b = tile.lane(), k = p.k;
    int32_t s[NSTATE];
    tile.get(s);
    bool active = s[F_ACT];
    int node = s[F_NODE], koff = s[F_KOFF];
    if (active) {
      const uint32_t* read = packed + (size_t)b * p.nw;
      const int len = lens[b];
      const int32_t* r = response(g, p.B, b, back, 12 + g.WW, node);
      int32_t row[12];
      load_row(r, 12 + g.WW, row);
      const uint32_t* win = reinterpret_cast<const uint32_t*>(r + 12);
      int kpos = s[F_KPOS] + k;
      int cov = s[COV] + k;
      push(buf, p.max_nodes, b, s, node, row[3]);
      const int ref_off = koff + k;
      const int maxm = max(min(len - kpos, row[1] - ref_off), 0);
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
        if (!prem && ((row[2] >> nb) & 1)) {
          node = edge(row, 4, nb);
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
      tile.store(st, s);  // the push at least changed it
    }
    write_request(g, p.B, b, req, active ? node : -1, koff + k);
  }
}

__global__ void __launch_bounds__(THREADS)
    gwalk_finish_kernel(pa::Params p, const int32_t* __restrict__ st,
                        const int32_t* __restrict__ buf, pa::WalkOut o) {
  // dynamic shared memory: the state rows [THREADS, NSTATE], then the
  // compact output's slots [dc, THREADS]
  extern __shared__ int4 smem4[];
  StateTile tile(smem4, p.B);
  int32_t* s_slots = tile.sm + THREADS * NSTATE;
  const int M = p.max_nodes;
  pa::walk_out_begin(p, tile.b0, tile.nb, o);
  tile.load(st);
  __syncthreads();  // walk_out_begin's fill before the pushes
  if (!tile.mine()) return;
  int32_t s[NSTATE];
  tile.get(s);
  const int b = tile.lane();
  // the stored pushes, PUSH_LOADS 8-byte loads in flight at a time,
  // through the same encoding as K2's live ones
  pa::Pushes out(p, o, b, s_slots + threadIdx.x, THREADS);
  const int2* mine = reinterpret_cast<const int2*>(buf) + (size_t)b * M;
  const int n = min(s[NN], M);
  for (int i0 = 0; i0 < n; i0 += PUSH_LOADS) {
    int2 v[PUSH_LOADS];
#pragma unroll
    for (int e = 0; e < PUSH_LOADS; e++)
      v[e] = i0 + e < n ? __ldg(mine + i0 + e) : make_int2(0, 0);
#pragma unroll
    for (int e = 0; e < PUSH_LOADS; e++)
      if (i0 + e < n) out.push(p, v[e].x, v[e].y);
  }
  out.nn = s[NN];
  const bool capped = (p.lcap > 0 && s[L_ACT]) || (p.wcap > 0 && s[F_ACT]) ||
                      s[NN] > M;
  pa::encode_output(p, b, out, s[COV], s[MM], capped, o);
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace

// Every entry: params = ops/kernels.py's launch parameters (PARAM_NAMES),
// geo = {S, Nb, WW}; st, buf and back on 16 bytes, req on 8 (the wrappers
// check).  Returns a cudaError_t.

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
  const size_t smem = (size_t)4 * THREADS * (NSTATE + p.dc);  // <= 38 KB
  const pa::WalkOut o{mapped, coverage, mismatches, n_nodes, ec_distinct,
                      nodes};
  gwalk_finish_kernel<<<blocks_for(p.B), THREADS, smem,
                        (cudaStream_t)stream>>>(p, st, buf, o);
  return (int)cudaGetLastError();
}
