// K5, the unpack of the bit-packed cuckoo upload: packed slot values (and,
// at W == 2, packed keys) -> the serving layout cuckoo_vals [2S] (node,
// offset) and cuckoo [S/4, 4W] keys-only rows.
//
// Replaces pseudoaligner_tpu/ops/map_kernel.py::_pack_unpack_jit (:1504),
// which unpacks on [*, 512]-wide tiles with a static column permutation to
// dodge the TPU's (8, 128) tile padding of narrow arrays.
//
// One thread per slot s:
//   node   = vals_lo & (2^node_bits - 1); all-ones marks an empty slot,
//            which becomes (EMPTY, 0);
//   offset = (vals_lo >> node_bits | vals_hi << (32 - node_bits)) masked
//            to off_bits;
//   keys (when keys_lo is given): word 0 = keys_lo, word 1 = the hi_bytes
//            bytes of keys_hi little-endian, or all-ones for an empty slot.
// The slot's (node, offset) pair and its two key words are written as one
// 8-byte store each, so neighbouring threads write neighbouring words.
// Without packed keys (k > 32) only the values are decoded and the keys
// rows travelled plain.
//
// Bound on the H100: memory bytes, 11 packed bytes read and 16 written per
// slot at k = 20.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;  // index/cuckoo.py EMPTY

__global__ void unpack_index_kernel(int64_t S, int node_bits, int off_bits,
                                    int hi_bytes,
                                    const uint32_t* __restrict__ vals_lo,
                                    const uint16_t* __restrict__ vals_hi,
                                    const uint32_t* __restrict__ keys_lo,
                                    const uint8_t* __restrict__ keys_hi,
                                    uint2* __restrict__ vals,
                                    uint2* __restrict__ keys) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t nmask = (1u << node_bits) - 1u;  // node_bits <= 30
  const uint32_t lo = vals_lo[s];
  const uint32_t node = lo & nmask;
  const bool empty = node == nmask;
  uint32_t off = (lo >> node_bits) | ((uint32_t)vals_hi[s] << (32 - node_bits));
  if (off_bits < 32) off &= (1u << off_bits) - 1u;
  vals[s] = empty ? make_uint2(EMPTY, 0u) : make_uint2(node, off);
  if (keys != nullptr) {
    uint32_t hi = 0u;
    for (int j = 0; j < hi_bytes; j++)
      hi |= (uint32_t)keys_hi[s * hi_bytes + j] << (8 * j);
    keys[s] = make_uint2(keys_lo[s], empty ? 0xFFFFFFFFu : hi);
  }
}

}  // namespace

extern "C" int pa_unpack_index(int device, long long S, int node_bits,
                               int off_bits, int hi_bytes,
                               const uint32_t* vals_lo,
                               const uint16_t* vals_hi,
                               const uint32_t* keys_lo,
                               const uint8_t* keys_hi, uint32_t* vals,
                               uint32_t* keys, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S == 0) return 0;
  const int64_t blocks = (S + THREADS - 1) / THREADS;
  unpack_index_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      S, node_bits, off_bits, hi_bytes, vals_lo, vals_hi, keys_lo, keys_hi,
      reinterpret_cast<uint2*>(vals), reinterpret_cast<uint2*>(keys));
  return (int)cudaGetLastError();
}
