// Batched LRU metadata update: stamp a batch of accessed slots, find the
// LRU victim.
//
// Replaces the TPU kernel src/repro/kernels/cache_update.py::_sweep_kernel
// (entry lru_batch_update, wrapped by repro.kernels.ops.lru_batch_update):
//
//     new_ts = timestamps; new_ts[a] = now for every accessed id a >= 0;
//     victim = the FIRST index of min(new_ts)
//
// repro_torch/kernels/cache_update.py holds the plain version
// (index_fill_ then argmin), which the wrapper runs on CPU tensors.
//
// What bounds it on an H100: bytes.  The function reads C timestamps and N
// ids and writes C timestamps (8C + 4N bytes); it does O(C + N) integer
// operations.  The TPU kernel compared every slot of a tile with every id
// of the batch (O(C·N) on its vector unit) and left the cross-tile argmin
// to the host.  Here:
//   * sweep_kernel: block b owns the contiguous chunk [b·chunk, (b+1)·chunk)
//     of slots.  It marks the ids of the batch that fall in its chunk in a
//     shared-memory bitmap (duplicates set the same bit; negative ids and
//     ids outside the chunk are skipped), then streams its chunk once:
//     new_ts[i] = marked ? now : ts[i], while each thread keeps its
//     (value, index) minimum.  A warp-shuffle and a shared-memory pass
//     reduce them to the block's (value, index), written to a partial.
//   * argmin_kernel: one block reduces the partials to the victim.
// Every (value, index) comparison is lexicographic, so the victim is the
// first index of the minimum, as jnp.argmin's.  All int32.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 264;        // two per SM of an H100 SXM
constexpr int MAX_CHUNK = 32 * 8192;      // slots per block: a 32 KB bitmap
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void pick_min(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// (value, index) argmin over the block; thread 0 gets the result.
__device__ void block_argmin(int& v, int& i) {
  __shared__ int sv[THREADS / 32], si[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) {
    pick_min(v, i, __shfl_xor_sync(FULL, v, off), __shfl_xor_sync(FULL, i, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? sv[lane] : INT_MAX;
    i = lane < THREADS / 32 ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      pick_min(v, i, __shfl_xor_sync(FULL, v, off), __shfl_xor_sync(FULL, i, off));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    sweep_kernel(const int* __restrict__ ts, const int* __restrict__ accessed,
                 int* __restrict__ new_ts, int* __restrict__ part, int n_slots,
                 int n_acc, int now, int chunk) {
  extern __shared__ unsigned marked[];  // (ceil(chunk / 32)) bitmap
  const int lo = blockIdx.x * chunk;
  const int hi = min(n_slots, lo + chunk);
  const int words = (chunk + 31) / 32;
  for (int w = threadIdx.x; w < words; w += THREADS) marked[w] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < n_acc; k += THREADS) {
    const int a = accessed[k];
    if (a >= lo && a < hi) atomicOr(&marked[(a - lo) / 32], 1u << ((a - lo) % 32));
  }
  __syncthreads();
  int v = INT_MAX, idx = INT_MAX;
  for (int s = lo + threadIdx.x; s < hi; s += THREADS) {
    const int r = s - lo;
    const int t = (marked[r / 32] >> (r % 32)) & 1u ? now : ts[s];
    new_ts[s] = t;
    pick_min(v, idx, t, s);
  }
  block_argmin(v, idx);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = v;
    part[gridDim.x + blockIdx.x] = idx;
  }
}

__global__ void __launch_bounds__(THREADS)
    argmin_kernel(const int* __restrict__ part, int n_part, int* __restrict__ victim) {
  int v = INT_MAX, idx = INT_MAX;
  for (int b = threadIdx.x; b < n_part; b += THREADS) {
    pick_min(v, idx, part[b], part[n_part + b]);
  }
  block_argmin(v, idx);
  if (threadIdx.x == 0) *victim = idx;
}

// Slots per block for a cache of n_slots: about TARGET_BLOCKS blocks, at
// least THREADS slots each and at most MAX_CHUNK.
int chunk_of(int n_slots) {
  const int blocks = std::min((n_slots + THREADS - 1) / THREADS, TARGET_BLOCKS);
  const int chunk = (n_slots + blocks - 1) / blocks;
  return std::min(std::max(chunk, THREADS), MAX_CHUNK);
}

}  // namespace

// Blocks of the sweep for a cache of n_slots: the partials the caller
// allocates hold 2 ints per block.
extern "C" int lru_update_blocks(int n_slots) {
  const int chunk = chunk_of(n_slots);
  return (n_slots + chunk - 1) / chunk;
}

// new_ts (C) and victim (1) are outputs, part (2 * lru_update_blocks(C))
// scratch; every id must be < C (negative ids are skipped).  Launches both
// kernels on `stream` and returns the cudaError_t.
extern "C" int lru_update_launch(const int* ts, const int* accessed, int* new_ts,
                                 int* part, int* victim, int n_slots, int n_acc,
                                 int now, void* stream) {
  const int chunk = chunk_of(n_slots);
  const int blocks = (n_slots + chunk - 1) / chunk;
  const int bytes = (chunk + 31) / 32 * (int)sizeof(unsigned);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_kernel<<<blocks, THREADS, bytes, st>>>(ts, accessed, new_ts, part,
                                               n_slots, n_acc, now, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argmin_kernel<<<1, THREADS, 0, st>>>(part, blocks, victim);
  return (int)cudaGetLastError();
}
