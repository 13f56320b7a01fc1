// K7, the k-mer routing of the k-mer-partitioned step, in two launches.
//
// Replaces pseudoaligner_tpu/parallel/sharded_index.py::_routed_seed_tables
// (:262): its owner hash, the stable bucketing by owner into fixed-capacity
// send buffers (a stable argsort plus searchsorted, :297-320) and the
// unscatter of the returned (node, offset) pairs into the seed tables
// (:350-357).
//
// Route (pa_route): every valid position p <= len - k of every read gets
// owner = hash_words(k-mer, OWNER_SEED) & (S - 1); invalid positions route
// nowhere.  Each query takes slot = its rank among the queries of the same
// owner in flat b*P + p order, so the buffers hold exactly what the
// reference's stable sort puts there: entries of rank >= CAP are dropped,
// counted into `overflow`, and mark their read in `dropped`.  Unused slots
// hold zero keys and src -1.  The stable rank needs no sort and no atomics
// in its order, in three kernels over the same blocks of BLOCK positions:
//   1. route_count: each block's count per owner (shared-memory atomics:
//      counts do not depend on their order);
//   2. route_scan: one block per owner scans those counts over the blocks,
//      giving each block's first slot per owner;
//   3. route_place: inside a warp, __match_any_sync groups the lanes of one
//      owner and the popcount of the lower lanes is a lane's rank; a
//      per-warp count per owner, scanned over the block's warps in shared
//      memory, adds the earlier warps.
// Unscatter (pa_unscatter): one thread per buffer slot writes its returned
// (node, offset) to seed_node / seed_off [B, P] at its src, after both are
// set to -1.
//
// Bound on the H100: memory bytes.  The send buffers are S * CAP slots of
// W + 1 words whatever the batch holds (CAP = slack * B * P / S^2 rounded
// up, slack 4 by default), so at S = 1 the route writes four times the
// batch's queries; the k-mers are cut from the packed reads, which stay
// in L1/L2 across the three kernels.

#include "common.cuh"

namespace {

constexpr uint32_t OWNER_SEED = 0xA5A55A5Au;  // parallel/sharded_index.py
constexpr int BLOCK = 256;  // positions per block, in all three kernels
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_S = 64;
constexpr int SCAN_THREADS = 1024;  // 32 warps: block_scan relies on it

struct Route {
  int64_t n;  // B * P positions
  int nw, k, P, S, CAP;
  const uint32_t* packed;
  const int32_t* lens;
};

// Owner shard of flat position t = b*P + p, with its k-mer words in w; S
// for a position past len - k or past the batch.
template <int W>
__device__ __forceinline__ int owner_of(const Route& a, int64_t t,
                                        uint32_t (&w)[W]) {
  if (t >= a.n) return a.S;
  const int64_t b = t / a.P;
  const int p = (int)(t % a.P);
  if (p > a.lens[b] - a.k) return a.S;
  pa::kmer_words<W>(pa::window_words(a.packed + b * a.nw, a.nw), p, a.k, w);
  return (int)(pa::hash_words<W>(w, OWNER_SEED) & (uint32_t)(a.S - 1));
}

template <int W>
__global__ void route_count_kernel(Route a, int32_t* __restrict__ counts) {
  __shared__ int cnt[MAX_S];
  for (int i = threadIdx.x; i < a.S; i += BLOCK) cnt[i] = 0;
  __syncthreads();
  uint32_t w[W];
  const int o = owner_of<W>(a, (int64_t)blockIdx.x * BLOCK + threadIdx.x, w);
  if (o < a.S) atomicAdd(&cnt[o], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < a.S; i += BLOCK)
    counts[(size_t)blockIdx.x * a.S + i] = cnt[i];
}

// Inclusive scan of v over the SCAN_THREADS threads of the block; *total
// receives the block's sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, s, off);
      if (lane >= off) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[31];
  __syncthreads();  // the next call overwrites warp_sums
  return v;
}

// One block per owner o: offsets[j][o] = the sum of counts[j'][o], j' < j.
__global__ void route_scan_kernel(int n_blocks, int S,
                                  const int32_t* __restrict__ counts,
                                  int32_t* __restrict__ offsets) {
  const int o = blockIdx.x;
  int carry = 0;
  for (int base = 0; base < n_blocks; base += SCAN_THREADS) {
    const int j = base + threadIdx.x;
    const int v = j < n_blocks ? counts[(size_t)j * S + o] : 0;
    int total;
    const int incl = block_scan(v, &total);
    if (j < n_blocks) offsets[(size_t)j * S + o] = carry + incl - v;
    carry += total;
  }
}

template <int W>
__global__ void route_place_kernel(Route a,
                                   const int32_t* __restrict__ offsets,
                                   uint32_t* __restrict__ send_q,
                                   int32_t* __restrict__ send_src,
                                   int32_t* __restrict__ overflow,
                                   bool* __restrict__ dropped) {
  __shared__ int wcnt[WARPS][MAX_S];
  for (int i = threadIdx.x; i < WARPS * MAX_S; i += BLOCK)
    wcnt[i / MAX_S][i % MAX_S] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  uint32_t w[W];
  const int o = owner_of<W>(a, t, w);
  // every lane of the warp takes part: invalid ones under owner S
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, o);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (o < a.S && rank == 0) wcnt[warp][o] = __popc(peers);
  __syncthreads();
  for (int s = threadIdx.x; s < a.S; s += BLOCK) {  // exclusive, per owner
    int acc = 0;
    for (int i = 0; i < WARPS; i++) {
      const int c = wcnt[i][s];
      wcnt[i][s] = acc;
      acc += c;
    }
  }
  __syncthreads();
  if (o >= a.S) return;
  const int slot = offsets[(size_t)blockIdx.x * a.S + o] + wcnt[warp][o] + rank;
  if (slot < a.CAP) {
    const size_t d = (size_t)o * a.CAP + slot;
#pragma unroll
    for (int j = 0; j < W; j++) send_q[d * W + j] = w[j];
    send_src[d] = (int32_t)t;
  } else {
    atomicAdd(overflow, 1);
    dropped[t / a.P] = true;
  }
}

__global__ void unscatter_kernel(int64_t n_slots,
                                 const int32_t* __restrict__ back,
                                 const int32_t* __restrict__ src,
                                 int32_t* __restrict__ node,
                                 int32_t* __restrict__ off) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;
  const int s = src[t];
  if (s < 0) return;
  node[s] = back[2 * t];
  off[s] = back[2 * t + 1];
}

}  // namespace

// counts and offsets: scratch of ceil(B*P / 256) * S int32 each.
extern "C" int pa_route(int device, int B, int nw, int k, int P, int S,
                        int CAP, const uint32_t* packed, const int32_t* lens,
                        int32_t* counts, int32_t* offsets, uint32_t* send_q,
                        int32_t* send_src, int32_t* overflow, bool* dropped,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S < 1 || S > MAX_S || (S & (S - 1)) || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int W = (2 * k + 31) / 32;
  const size_t slots = (size_t)S * CAP;
  if ((e = cudaMemsetAsync(send_q, 0, slots * W * 4, st)) != cudaSuccess ||
      (e = cudaMemsetAsync(send_src, 0xFF, slots * 4, st)) != cudaSuccess ||
      (e = cudaMemsetAsync(overflow, 0, 4, st)) != cudaSuccess ||
      (e = cudaMemsetAsync(dropped, 0, (size_t)B, st)) != cudaSuccess)
    return (int)e;
  Route a;
  a.n = (int64_t)B * P;
  a.nw = nw;
  a.k = k;
  a.P = P;
  a.S = S;
  a.CAP = CAP;
  a.packed = packed;
  a.lens = lens;
  const int n_blocks = (int)((a.n + BLOCK - 1) / BLOCK);
  if (n_blocks == 0) return 0;
  return (int)pa::with_w(W, [&](auto w) {
    constexpr int WT = decltype(w)::value;
    route_count_kernel<WT><<<n_blocks, BLOCK, 0, st>>>(a, counts);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    route_scan_kernel<<<S, SCAN_THREADS, 0, st>>>(n_blocks, S, counts,
                                                  offsets);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    route_place_kernel<WT><<<n_blocks, BLOCK, 0, st>>>(
        a, offsets, send_q, send_src, overflow, dropped);
    return cudaGetLastError();
  });
}

extern "C" int pa_unscatter(int device, long long n_slots, long long n_pos,
                            const int32_t* back, const int32_t* src,
                            int32_t* node, int32_t* off, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if ((e = cudaMemsetAsync(node, 0xFF, (size_t)n_pos * 4, st)) != cudaSuccess ||
      (e = cudaMemsetAsync(off, 0xFF, (size_t)n_pos * 4, st)) != cudaSuccess)
    return (int)e;
  if (n_slots == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n_slots + threads - 1) / threads);
  unscatter_kernel<<<blocks, threads, 0, st>>>(n_slots, back, src, node, off);
  return (int)cudaGetLastError();
}
