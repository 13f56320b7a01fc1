// K9, per-transcript compatibility counts: counts[t] = the number of reads
// whose intersected EC bitset has bit t set, for t < n_tx, in int32.
//
// Replaces pseudoaligner_tpu/parallel/mesh.py::tx_compat_counts (:57),
// which unpacks [B, TW, 32] bits and sums them over the reads (the psum
// across shards that follows is an all_reduce outside the kernel).
//
// A block covers 32 words (1,024 transcripts) of a chunk of CHUNK reads:
// threadIdx.x picks the word, so a warp reads 128 contiguous bytes of a
// row, and threadIdx.y strides over the chunk's rows.  Each thread keeps
// 32 bit counters in registers; the block sums its ROWS partial counters
// per transcript in shared memory and adds them with one atomic per block
// per transcript.  Integer addition gives the same sum in any order.
//
// Bound on the H100: memory bytes, the B x TW x 4 input (88 MB at
// B = 65,536 and TW = 337), against 2 operations per bit (~1.4 G).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int CHUNK = 2048;  // reads per block

__global__ void tx_counts_kernel(int B, int TW, int n_tx,
                                 const uint32_t* __restrict__ bits,
                                 int32_t* __restrict__ counts) {
  __shared__ int part[ROWS][32][33];  // [row][word lane][bit], padded
  const int wl = threadIdx.x, y = threadIdx.y;
  const int w = blockIdx.x * 32 + wl;
  const int b0 = blockIdx.y * CHUNK;
  const int b1 = min(B, b0 + CHUNK);
  int c[32];
#pragma unroll
  for (int j = 0; j < 32; j++) c[j] = 0;
  if (w < TW) {
    for (int b = b0 + y; b < b1; b += ROWS) {
      const uint32_t v = bits[(size_t)b * TW + w];
#pragma unroll
      for (int j = 0; j < 32; j++) c[j] += (v >> j) & 1u;
    }
  }
#pragma unroll
  for (int j = 0; j < 32; j++) part[y][wl][j] = c[j];
  __syncthreads();
  for (int i = y * 32 + wl; i < 32 * 32; i += ROWS * 32) {
    const int l = i / 32, j = i % 32;
    int s = 0;
    for (int r = 0; r < ROWS; r++) s += part[r][l][j];
    const int64_t t = ((int64_t)blockIdx.x * 32 + l) * 32 + j;
    if (s != 0 && t < n_tx) atomicAdd(&counts[t], s);
  }
}

}  // namespace

extern "C" int pa_tx_counts(int device, int B, int TW, int n_tx,
                            const uint32_t* bits, int32_t* counts,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if ((e = cudaMemsetAsync(counts, 0, (size_t)n_tx * 4, st)) != cudaSuccess)
    return (int)e;
  if (B == 0 || TW == 0) return 0;
  const dim3 grid((TW + 31) / 32, (B + CHUNK - 1) / CHUNK);
  const dim3 block(32, ROWS);
  tx_counts_kernel<<<grid, block, 0, st>>>(B, TW, n_tx, bits, counts);
  return (int)cudaGetLastError();
}
