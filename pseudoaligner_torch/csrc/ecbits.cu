// K4, the bitset EC intersection: per read, the AND of its classes'
// transcript bitsets -> ec_bits [B, TW] (uint32 words, bit t of word w =
// transcript 32w + t).
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::_walk's bitset EC
// intersection (:1180-1218), which sorts and run-compacts each lane's class
// ids, ANDs CAP unrolled row gathers and covers the rest in a while loop.
//
// What it computes, per read b: 0 in every word when !mapped[b]; else,
// from all-ones, the AND of ec_bits[e] over the classes e >= 0 of its
// first min(n_nodes[b], M) ids (none when n_nodes[b] <= 0): node ids whose
// class is node_row[n, 3] (pa_ec_bits), or the class ids the graph-sharded
// walk pushed (pa_ec_bits_classes; its replicated node_row is a
// placeholder).  Ids below 0 are empty slots.
//
// Bound on the H100: bytes, the B x TW x 4 output (88 MB at B = 65,536 and
// TW = 337; the class table, 22.7 MB at 16,816 classes, is read from L2).
// A read's classes are few (about 1.3 distinct on average), so the work is
// the output stream; what held the kernel back was latency: the parent
// re-read each read's ids and re-gathered their classes on every one of
// its ceil(TW / 32) passes, and wrote rows 1,348 bytes long in 128-byte
// warp stores that straddled two lines.  Here one warp owns one read and
// nothing waits on the rest of the block:
//  1. the warp reads the read's ids 32 at a time (mapped, n_nodes and the
//     first chunk in one round of loads), gathers their classes, and keeps
//     each distinct class once in its own slice of shared memory
//     (__match_any_sync within a chunk, a check against the classes kept
//     so far across chunks), up to C of them; a read with more than C
//     distinct classes takes its ids from device memory again in step 2
//     (AND is idempotent, so ANDing a class twice changes nothing);
//  2. the warp writes the read's row: the words before the row's first
//     16-byte boundary and after its last one (at most 3 each, TW not a
//     multiple of 4) one by one, and the rest as 16-byte pieces, lane l
//     taking pieces l, l + 32, ..., U of them per pass with every one of
//     their class-row loads in flight before the first store, so a pass
//     costs one load latency per class.  A warp's store instruction writes
//     512 contiguous bytes under the L2 evict-first policy (common.cuh), so
//     the stream does not evict the class rows; neighbouring lanes read
//     neighbouring words of a class row.
// The kernel is held by latency and occupancy (48 registers): reading a
// lane's four class-row words as one 16-byte load, with shuffles from the
// next lane where the row is not on 16 bytes, cut its L1 traffic but took
// 80 registers and ran slower, and so did blocks of 8 warps, two reads a
// warp, or a register cap that spilled (PERF.md, §6).

#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // reads per block, one warp each
constexpr int U = 3;      // pieces a lane keeps in flight: 384 words a pass
constexpr int C = 16;     // distinct classes kept per read
constexpr int UNMAPPED = -1;
constexpr int OVER = C + 1;  // more than C classes: ids from device memory
constexpr unsigned FULL = 0xFFFFFFFFu;

template <bool CLASSES>
struct Args {
  int B, M, TW;
  const int32_t* ids;  // [B, M] node ids, or class ids when CLASSES
  const int32_t* n_nodes;
  const bool* mapped;
  const int32_t* node_row;  // [n, 12]; not read when CLASSES
  const uint32_t* ec_bits;  // [n_classes, TW]

  // the class of id v, or -1 for an empty slot
  __device__ __forceinline__ int class_of(int v) const {
    if (v < 0) return -1;
    return CLASSES ? v : __ldg(node_row + (int64_t)v * 12 + 3);
  }

  // v[i] &= word w + i of class e's row
  template <int N>
  __device__ __forceinline__ void and_row(int e, int w,
                                          uint32_t (&v)[N]) const {
    const uint32_t* row = ec_bits + (int64_t)e * TW + w;
#pragma unroll
    for (int i = 0; i < N; i++) v[i] &= __ldg(row + i);
  }
};

// v[u] = the N words from w[u] of read b's row, for each u with live[u];
// step 1 left the read's classes as n_cls: UNMAPPED, a count of classes in
// cls, or OVER (then its ids are read again).
template <bool CLASSES, int N, int K>
__device__ __forceinline__ void row_words(const Args<CLASSES>& a, int64_t b,
                                          int n_cls, const int* cls,
                                          const int (&w)[K],
                                          const bool (&live)[K],
                                          uint32_t (&v)[K][N]) {
  const uint32_t init = n_cls == UNMAPPED ? 0u : FULL;
#pragma unroll
  for (int u = 0; u < K; u++)
#pragma unroll
    for (int i = 0; i < N; i++) v[u][i] = init;
  if (n_cls <= C) {
    for (int k = 0; k < n_cls; k++) {
      const int e = cls[k];
#pragma unroll
      for (int u = 0; u < K; u++)
        if (live[u]) a.and_row(e, w[u], v[u]);
    }
    return;
  }
  const int n = min(__ldg(a.n_nodes + b), a.M);
  const int32_t* ids = a.ids + b * a.M;
  for (int i = 0; i < n; i++) {
    const int e = a.class_of(__ldg(ids + i));
    if (e < 0) continue;
#pragma unroll
    for (int u = 0; u < K; u++)
      if (live[u]) a.and_row(e, w[u], v[u]);
  }
}

template <bool CLASSES>
__global__ void __launch_bounds__(WARPS * 32)
    ec_bits_kernel(Args<CLASSES> a, uint32_t* __restrict__ out) {
  __shared__ int cls_all[WARPS][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= a.B) return;  // b is uniform over the warp: the whole warp leaves
  int* cls = cls_all[warp];

  // step 1: the read's distinct classes, once
  const int32_t* ids = a.ids + b * a.M;
  // mapped, n_nodes and the first chunk's ids in one round of loads
  const bool on = a.mapped[b];
  int n = __ldg(a.n_nodes + b);
  int v = lane < a.M ? __ldg(ids + lane) : -1;
  n = min(n, a.M);
  int kept = on ? 0 : UNMAPPED;
  for (int c0 = 0; on && c0 < n && kept <= C; c0 += 32) {
    if (c0 > 0) v = c0 + lane < n ? __ldg(ids + c0 + lane) : -1;
    const int e = c0 + lane < n ? a.class_of(v) : -1;
    const unsigned same = __match_any_sync(FULL, e);
    bool fresh = e >= 0 && __ffs(same) - 1 == lane;
    for (int k = 0; fresh && k < kept; k++) fresh = cls[k] != e;
    const unsigned add = __ballot_sync(FULL, fresh);
    const int slot = kept + __popc(add & ((1u << lane) - 1u));
    if (fresh && slot < C) cls[slot] = e;
    kept += __popc(add);  // above C: the read overflows
    __syncwarp();
  }
  const int n_cls = min(kept, OVER);

  // step 2: the row, out[b * TW ...], 16-byte aligned pieces between its
  // edge words
  const int TW = a.TW;
  uint32_t* o = out + b * TW;
  const int head = min((int)((4 - ((b * TW) & 3)) & 3), TW);
  const int n_pieces = (TW - head) >> 2;
  const int tail = head + 4 * n_pieces;
  for (int p0 = lane; p0 < n_pieces; p0 += 32 * U) {
    int w[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; u++) {
      w[u] = head + 4 * (p0 + 32 * u);
      live[u] = p0 + 32 * u < n_pieces;
    }
    uint32_t r[U][4];
    row_words(a, b, n_cls, cls, w, live, r);
#pragma unroll
    for (int u = 0; u < U; u++)
      if (live[u])
        pa::store_evict_first(reinterpret_cast<int4*>(o + w[u]),
                              make_int4((int)r[u][0], (int)r[u][1],
                                        (int)r[u][2], (int)r[u][3]));
  }
  // the edge words: lane l < head takes word l, the next lanes the tail's
  if (lane < head + TW - tail) {
    const int w[1] = {lane < head ? lane : tail + lane - head};
    const bool live[1] = {true};
    uint32_t r[1][1];
    row_words(a, b, n_cls, cls, w, live, r);
    o[w[0]] = r[0][0];
  }
}

template <bool CLASSES>
int launch(int device, const Args<CLASSES>& a, uint32_t* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (a.B == 0 || a.TW == 0) return 0;
  const int64_t blocks = ((int64_t)a.B + WARPS - 1) / WARPS;
  ec_bits_kernel<CLASSES><<<(unsigned)blocks, WARPS * 32, 0,
                            (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

}  // namespace

// nodes [B, M] int32, n_nodes [B] int32, mapped [B] bool, node_row [n, 12]
// int32, ec_bits [n_classes, TW] uint32, out [B, TW] uint32 on 16 bytes
// (the wrapper allocates and checks it).  Returns a cudaError_t.
extern "C" int pa_ec_bits(int device, int B, int M, int TW,
                          const int32_t* nodes, const int32_t* n_nodes,
                          const bool* mapped, const int32_t* node_row,
                          const uint32_t* ec_bits, uint32_t* out,
                          void* stream) {
  return launch<false>(
      device, Args<false>{B, M, TW, nodes, n_nodes, mapped, node_row,
                          ec_bits},
      out, stream);
}

// The same from the pushed class ids [B, M] (no node_row).
extern "C" int pa_ec_bits_classes(int device, int B, int M, int TW,
                                  const int32_t* classes,
                                  const int32_t* n_nodes, const bool* mapped,
                                  const uint32_t* ec_bits, uint32_t* out,
                                  void* stream) {
  return launch<true>(
      device, Args<true>{B, M, TW, classes, n_nodes, mapped, nullptr,
                         ec_bits},
      out, stream);
}
