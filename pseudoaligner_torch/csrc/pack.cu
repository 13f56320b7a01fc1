// K6, the read pack: base codes [B, L] int32 -> 2-bit packed reads
// [B, ceil(L/16)] uint32, base i of a read at bits 2*(i%16) of word i/16.
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::pack_reads_device (:704),
// which pads each row to a multiple of 16 and ORs the 16 shifted columns.
//
// One thread per output word ORs its 16 codes (positions past L count as
// zero).  Codes are not masked to two bits, as in the reference.
//
// Bound on the H100: memory bytes.  Each thread reads 64 contiguous bytes
// of its row and writes 4; the reads of a warp's neighbouring words are
// contiguous, so the whole [B, L] input streams once through L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack_kernel(int64_t n_words, int L, int nw,
                            const int32_t* __restrict__ codes,
                            uint32_t* __restrict__ packed) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const int64_t b = t / nw;
  const int w = (int)(t % nw);
  const int32_t* row = codes + b * L;
  uint32_t acc = 0u;
  for (int i = 0; i < 16; i++) {
    const int j = w * 16 + i;
    if (j < L) acc |= (uint32_t)row[j] << (2 * i);
  }
  packed[t] = acc;
}

}  // namespace

extern "C" int pa_pack_reads(int device, int B, int L, const int32_t* codes,
                             uint32_t* packed, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nw = (L + 15) / 16;
  const int64_t n = (int64_t)B * nw;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  pack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(n, L, nw, codes,
                                                            packed);
  return (int)cudaGetLastError();
}
