// K9, per-transcript compatibility counts: counts[t] = the number of reads
// whose intersected EC bitset has bit t set, for t < n_tx, in int32.
//
// Replaces pseudoaligner_tpu/parallel/mesh.py::tx_compat_counts (:57),
// which unpacks [B, TW, 32] bits and sums them over the reads (the psum
// across shards that follows is an all_reduce outside the kernel).
//
// Bound on the H100: bytes, the B x TW x 4 input (88 MB at B = 65,536 and
// TW = 337).  The parent kept 32 counters a thread and added every word
// bit by bit, 32 shifts, masks and adds, about 96 integer instructions a
// word: at Hopper's 64 integer lanes per SM and clock that issue alone
// took most of its time, with one 4-byte load in flight a thread.  Here a
// thread owns one word column over a run of rows and counts bit-sliced:
// plane i holds bit i of all 32 transcripts' counts.  Each group of G = 8
// rows goes through a carry-save (Harley-Seal) tree of full adders, sum
// and majority one LOP3 each, into the planes ones, twos and fours and a
// count of eights kept in 5 more planes: 14 logic operations for 8 words
// plus 10 for the eights, against ~770, and two groups' 16 loads are in
// flight together.  A thread takes at most MAX_GROUPS groups, so its
// counts fit its 8 planes without a flush.  The block's Y warps then add
// their planes pairwise in shared memory (ripple-carry adders, one plane
// more a level), and its threads turn the block's NP planes into 1,024
// counts and add them to counts with one coalesced atomic per nonzero
// count.  The host sizes the grid to one wave of the card, from the SM
// count and the kernel's occupancy, with as few row chunks (so atomics per
// transcript) as fill it: at B = 65,536 and TW = 337, 11 x 24 blocks of
// 1,024 threads, two an SM, so at most 24 atomics per transcript against
// the parent's 32 (blocks of 16 warps ran no faster and needed 47).  Loads are 4 bytes, coalesced across the warp's
// 32 columns, so any 4-byte-aligned input works (a row slice too).
// Integer addition gives the same sum in any order.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int LOG_Y = 5;
constexpr int Y = 1 << LOG_Y;  // warps per block, each over its own rows
constexpr int G = 8;           // rows per group: one carry-save tree
constexpr int HP = 5;          // planes of the eights count
constexpr int MAX_GROUPS = (1 << HP) - 1;  // groups per thread: 248 rows
constexpr int NP = 3 + HP + LOG_Y;         // planes after the block's tree

static_assert(G * MAX_GROUPS * Y < (1 << NP), "a block's counts fit NP");

// full adder over 32 bit lanes: (carry, sum) of a + b + c
__device__ __forceinline__ void csa(uint32_t& carry, uint32_t& sum,
                                    uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  carry = (a & b) | (u & c);
  sum = u ^ c;
}

// p += q, NP-plane bit-sliced numbers (no carry out: the sums fit)
__device__ __forceinline__ void add_planes(uint32_t (&p)[NP],
                                           const uint32_t (&q)[NP]) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NP; i++) csa(c, p[i], p[i], q[i], c);
}

// A block covers 32 word columns (1,024 transcripts) of a chunk of
// groups x G x Y rows; thread (x, y) counts column x over the chunk's rows
// y, y + Y, y + 2Y, ...
__global__ void __launch_bounds__(32 * Y)
    tx_counts_kernel(int B, int TW, int n_tx, int groups,
                     const uint32_t* __restrict__ bits,
                     int32_t* __restrict__ counts) {
  __shared__ uint32_t part[Y / 2][NP][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const int w = blockIdx.x * 32 + x;
  const int64_t b0 = (int64_t)blockIdx.y * groups * G * Y + y;
  uint32_t p[NP];
#pragma unroll
  for (int i = 0; i < NP; i++) p[i] = 0u;
  if (w < TW) {
    const uint32_t* col = bits + w;
    uint32_t ones = 0, twos = 0, fours = 0, h[HP] = {};
#pragma unroll 2  // two groups' 16 loads in flight
    for (int g = 0; g < groups; g++) {
      uint32_t a[G];
#pragma unroll
      for (int u = 0; u < G; u++) {
        const int64_t b = b0 + (int64_t)(g * G + u) * Y;
        a[u] = b < B ? __ldg(col + b * TW) : 0u;
      }
      uint32_t t2a, t2b, f4a, f4b, e8;
      csa(t2a, ones, ones, a[0], a[1]);
      csa(t2b, ones, ones, a[2], a[3]);
      csa(f4a, twos, twos, t2a, t2b);
      csa(t2a, ones, ones, a[4], a[5]);
      csa(t2b, ones, ones, a[6], a[7]);
      csa(f4b, twos, twos, t2a, t2b);
      csa(e8, fours, fours, f4a, f4b);
#pragma unroll
      for (int i = 0; i < HP; i++) {  // h += e8: at most one a group
        const uint32_t c = h[i] & e8;
        h[i] ^= e8;
        e8 = c;
      }
    }
    p[0] = ones;
    p[1] = twos;
    p[2] = fours;
#pragma unroll
    for (int i = 0; i < HP; i++) p[3 + i] = h[i];
  }
  // the Y warps' planes, added pairwise: warp y takes warp y + s's
  for (int s = Y / 2; s >= 1; s >>= 1) {
    if (y >= s && y < 2 * s) {
#pragma unroll
      for (int i = 0; i < NP; i++) part[y - s][i][x] = p[i];
    }
    __syncthreads();
    if (y < s) {
      uint32_t q[NP];
#pragma unroll
      for (int i = 0; i < NP; i++) q[i] = part[y][i][x];
      add_planes(p, q);
    }
    __syncthreads();
  }
  if (y == 0) {
#pragma unroll
    for (int i = 0; i < NP; i++) part[0][i][x] = p[i];
  }
  __syncthreads();
  // thread i of the block: column l = i / 32 (one per warp), bit j = i % 32,
  // so a warp's atomics hit 32 consecutive counts
  for (int i = y * 32 + x; i < 32 * 32; i += 32 * Y) {
    const int l = i >> 5, j = i & 31;
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < NP; k++) c |= ((part[0][k][l] >> j) & 1u) << k;
    const int64_t t = ((int64_t)blockIdx.x * 32 + l) * 32 + j;
    if (c != 0 && t < n_tx) atomicAdd(counts + t, (int)c);
  }
}

}  // namespace

// bits [B, TW] uint32, any 4-byte-aligned base; counts [n_tx] int32, n_tx
// <= 32 * TW.  Returns a cudaError_t.
extern "C" int pa_tx_counts(int device, int B, int TW, int n_tx,
                            const uint32_t* bits, int32_t* counts,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if ((e = cudaMemsetAsync(counts, 0, (size_t)n_tx * 4, st)) != cudaSuccess)
    return (int)e;
  if (B == 0 || TW == 0) return 0;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, tx_counts_kernel, 32 * Y, 0)) != cudaSuccess)
    return (int)e;
  // as few row chunks as fill one wave, each at most MAX_GROUPS groups deep
  const int cols = (TW + 31) / 32;
  const int64_t n_groups = ((int64_t)B + G * Y - 1) / (G * Y);  // G x Y rows
  const int64_t chunks_wave = std::max<int64_t>(
      1, (int64_t)sms * std::max(per_sm, 1) / cols);
  const int64_t groups = std::min<int64_t>(
      (n_groups + chunks_wave - 1) / chunks_wave, MAX_GROUPS);
  const int64_t chunks = (n_groups + groups - 1) / groups;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(cols, (unsigned)chunks);
  tx_counts_kernel<<<grid, dim3(32, Y), 0, st>>>(B, TW, n_tx, (int)groups,
                                                  bits, counts);
  return (int)cudaGetLastError();
}
