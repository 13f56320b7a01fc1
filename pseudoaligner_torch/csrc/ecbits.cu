// K4, the bitset EC intersection: per read, the AND of its classes'
// transcript bitsets -> ec_bits [B, TW] (uint32 words, bit t of word w =
// transcript 32w + t).
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::_walk's bitset EC
// intersection (:1180-1218), which sorts and run-compacts each lane's class
// ids, ANDs CAP unrolled row gathers and covers the rest in a while loop.
//
// One warp per read.  The read's first min(n_nodes, max_nodes) node ids
// (the buffer holds no more) are read 32 at a time, one per lane, and each
// lane gathers its node's class from node_row[n, 3].  __match_any_sync
// keeps the first lane of each class within those 32, so a class met
// several times in a chunk is gathered once (AND is idempotent: a class
// repeated across chunks of a read longer than 32 nodes is ANDed twice
// with the same result).  The warp then walks the TW words 32 at a time,
// one word per lane: for each kept class it ANDs the class row's 32
// consecutive words, a coalesced 128-byte read, into its accumulator,
// starting from all-ones, and writes the 32 words out.  Unmapped reads
// write zeros.  Nothing is staged in shared memory: the output (88 MB at
// B = 65,536 and TW = 337) goes straight to device memory.
//
// Bound on the H100: memory bytes.  The B x TW x 4 output bytes dominate;
// the class rows are few and reused across reads, so L2 serves most of
// their reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // reads per block

__global__ void ec_bits_kernel(int B, int M, int TW,
                               const int32_t* __restrict__ nodes,
                               const int32_t* __restrict__ n_nodes,
                               const bool* __restrict__ mapped,
                               const int32_t* __restrict__ node_row,
                               const uint32_t* __restrict__ ec_bits,
                               uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // b is uniform over the warp: the whole warp leaves
  uint32_t* o = out + b * TW;
  if (!mapped[b]) {
    for (int w = lane; w < TW; w += 32) o[w] = 0u;
    return;
  }
  const int n = min(n_nodes[b], M);
  const int32_t* nb = nodes + b * M;
  for (int w0 = 0; w0 < TW; w0 += 32) {
    const int w = w0 + lane;
    uint32_t acc = 0xFFFFFFFFu;
    for (int c0 = 0; c0 < n; c0 += 32) {
      int ec = -1;
      if (c0 + lane < n) {
        const int nd = nb[c0 + lane];
        if (nd >= 0) ec = node_row[(int64_t)nd * 12 + 3];
      }
      const unsigned same = __match_any_sync(0xFFFFFFFFu, ec);
      const bool first = ec >= 0 && __ffs(same) - 1 == lane;
      unsigned todo = __ballot_sync(0xFFFFFFFFu, first);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int e = __shfl_sync(0xFFFFFFFFu, ec, src);
        if (w < TW) acc &= ec_bits[(int64_t)e * TW + w];
      }
    }
    if (w < TW) o[w] = acc;
  }
}

}  // namespace

extern "C" int pa_ec_bits(int device, int B, int M, int TW,
                          const int32_t* nodes, const int32_t* n_nodes,
                          const bool* mapped, const int32_t* node_row,
                          const uint32_t* ec_bits, uint32_t* out,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || TW == 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  ec_bits_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      B, M, TW, nodes, n_nodes, mapped, node_row, ec_bits, out);
  return (int)cudaGetLastError();
}
