// K6, the read pack: base codes [B, L] -> 2-bit packed reads
// [B, ceil(L/16)] uint32, base i of a read at bits 2*(i%16) of word i/16.
// Two entries over one design: uint8 codes, the width at which the
// k-mer-partitioned path ships them over the host-to-device link (one byte
// a base), and int32 codes, for the tensor entries map_batch and
// map_batch_with_seeds.
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::pack_reads_device (:704),
// which pads each row to a multiple of 16 and ORs the 16 shifted columns.
// Codes are not masked to two bits, as in the reference, and positions past
// L count as zero.
//
// Bound on the H100: memory bytes (L = 60, a 65,536-read batch: 3.9 MB in
// at one byte a base, 15.7 MB at four, 1.0 MB out), and at one byte a base
// below the cost of any launch.  Design: a thread per output word, so a
// warp's words are consecutive and their codes one contiguous span (a
// row's words follow each other, and so do the rows), and its stores are
// 128 contiguous bytes.  Where L % 4 == 0 and the base is aligned to four
// codes, a word's codes come in at most four wide loads: 16 bytes each at
// int32, 4 bytes each at uint8, whose four codes are folded into the word
// with three shifts and masks; otherwise one code at a time.  Loads are
// plain: the codes were just copied to the card, and the L2 keeps part of
// them; an evict-first hint was slower (PERF.md, section 6).  Staging a
// block's span in shared memory first (in 16-byte loads or cp.async) was
// slower at both widths: a block's loads and its packing do not overlap.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// The 4 code bytes of y (byte j at bits 8j) as the OR of byte j << 2j.
__device__ __forceinline__ uint32_t fold4(uint32_t y) {
  return (y & 0xFFu) | ((y >> 6) & 0x3FCu) | ((y >> 12) & 0xFF0u) |
         ((y >> 18) & 0x3FC0u);
}

// Word f of the packed batch.  VEC: L % 4 == 0 and codes aligned to four
// codes, so a word's n codes (a multiple of 4) are n / 4 aligned groups.
template <typename T, bool VEC>
__device__ __forceinline__ void pack_word(int64_t n_words, int L, int nw,
                                          const T* __restrict__ codes,
                                          uint32_t* __restrict__ packed) {
  const int64_t f = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (f >= n_words) return;
  const int64_t r = f / nw;
  const int w = (int)(f - r * nw);
  const T* p = codes + r * L + 16 * w;
  const int n = min(16, L - 16 * w);
  uint32_t acc = 0u;
  if (VEC && sizeof(T) == 4) {
    uint32_t x[4][4];
#pragma unroll
    for (int k = 0; k < 4; k++)
      if (4 * k < n)
        pa::load_words<4>(reinterpret_cast<const uint32_t*>(p) + 4 * k, x[k]);
#pragma unroll
    for (int k = 0; k < 4; k++)
      if (4 * k < n)
#pragma unroll
        for (int j = 0; j < 4; j++) acc |= x[k][j] << (2 * (4 * k + j));
  } else if (VEC) {
    uint32_t x[4][1];
#pragma unroll
    for (int k = 0; k < 4; k++)
      if (4 * k < n)
        pa::load_words<1>(reinterpret_cast<const uint32_t*>(p + 4 * k), x[k]);
#pragma unroll
    for (int k = 0; k < 4; k++)
      if (4 * k < n) acc |= fold4(x[k][0]) << (8 * k);
  } else {
#pragma unroll
    for (int i = 0; i < 16; i++)
      if (i < n) acc |= (uint32_t)p[i] << (2 * i);
  }
  packed[f] = acc;
}

// one kernel name per entry (the trace tells them apart)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    pack_u8_kernel(int64_t n_words, int L, int nw,
                   const uint8_t* __restrict__ codes,
                   uint32_t* __restrict__ packed) {
  pack_word<uint8_t, VEC>(n_words, L, nw, codes, packed);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    pack_i32_kernel(int64_t n_words, int L, int nw,
                    const int32_t* __restrict__ codes,
                    uint32_t* __restrict__ packed) {
  pack_word<int32_t, VEC>(n_words, L, nw, codes, packed);
}

template <bool VEC>
void start(int blocks, cudaStream_t st, int64_t n, int L, int nw,
           const uint8_t* codes, uint32_t* packed) {
  pack_u8_kernel<VEC><<<blocks, THREADS, 0, st>>>(n, L, nw, codes, packed);
}

template <bool VEC>
void start(int blocks, cudaStream_t st, int64_t n, int L, int nw,
           const int32_t* codes, uint32_t* packed) {
  pack_i32_kernel<VEC><<<blocks, THREADS, 0, st>>>(n, L, nw, codes, packed);
}

template <typename T>
int launch(int device, int B, int L, const T* codes, uint32_t* packed,
           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nw = (L + 15) / 16;
  const int64_t n = (int64_t)B * nw;
  if (n == 0) return 0;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (L % 4 == 0 && (uintptr_t)codes % (4 * sizeof(T)) == 0)
    start<true>(blocks, st, n, L, nw, codes, packed);
  else
    start<false>(blocks, st, n, L, nw, codes, packed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pa_pack_reads_u8(int device, int B, int L,
                                const uint8_t* codes, uint32_t* packed,
                                void* stream) {
  return launch(device, B, L, codes, packed, stream);
}

extern "C" int pa_pack_reads_i32(int device, int B, int L,
                                 const int32_t* codes, uint32_t* packed,
                                 void* stream) {
  return launch(device, B, L, codes, packed, stream);
}
