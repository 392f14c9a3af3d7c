// Replay kernel: one (capacity, seed) lane's full trace replay per block.
//
// Replaces the TPU kernel src/repro/kernels/replay.py::_replay_kernel
// (launched by _pallas_grid, entry replay_grid_pallas).  Each block
// replays the whole request stream of one lane through one policy of the
// flat engine (repro_torch/cache/flat.py holds the plain version, step for
// step) and fuses the delayed-hit classifier through a per-key
// fetch-expiry table.  Per request it writes: hit, evicted key, packed
// op vector (delink | head<<1 | tail<<9 | scan<<12) and class.
//
// What bounds it on an H100: neither bytes nor operations, but the serial
// dependence between consecutive requests of a lane — request t+1 reads
// the cache state request t wrote, and each victim search is a block-wide
// reduction.  The design keeps the lane's whole state in shared memory
// (key2slot + expiry: key_space ints each; slot2key, ts, bit, aux, ghost:
// pad ints each; 8 registers) so nothing round-trips through device
// memory between requests, and runs lanes in parallel across SMs.
// Nothing more yet: one block per lane leaves most SMs idle at the
// main path's 5-lane grids.
//
// Execution model: all threads run the same scalar code on the same
// shared values (so every branch is uniform across the block), only
// thread 0 writes state, and a __syncthreads() separates every group of
// writes from the reads around it.  Masked argmin / any / sum over the
// padded slot axis are block reductions.
//
// Where bit-exactness with the JAX reference could break:
//   * argmin ties: jnp.argmin returns the FIRST index.  Every reduction
//     compares (value, index) pairs lexicographically, and an all-masked
//     argmin (every value INT_MAX) returns slot 0, as _min_slot does.
//     argmax(slot2key == NIL) is the argmin of (occupied ? 1 : 0).
//   * index semantics: JAX clamps out-of-range gathers and drops
//     out-of-range scatters; here an out-of-range index would corrupt
//     shared memory.  Keys are range-checked by the wrapper; every slot
//     index below is in range in the branch that uses it, and the NIL
//     guards of the reference (max(old_key, 0) in _clear_key and the
//     list step, max(slot, 0) on hits) are reproduced as written.
//   * wraparound: all state is int32, as in the reference, including the
//     SIEVE _WRAP_BIAS sum.
//   * float32 admission coin: prob_lru compares u >= q in float32, with q
//     rounded to float32 on the host.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NIL = -1;
constexpr int IMAX = INT_MAX;
constexpr int WRAP_BIAS = 1 << 30;
constexpr int FAR_PAST = -(1 << 30);

constexpr int R_SIZE = 0, R_NOW = 1, R_SIZET = 2, R_SIZES = 3, R_SIZEM = 4,
              R_GPOS = 5, R_HAND = 6, N_REGS = 8;
constexpr int P_CAP = 0, P_MAX_SCAN = 1, P_PROT_CAP = 2, P_S_CAP = 3,
              P_M_CAP = 4, P_GHOST_CAP = 5, N_PARAMS = 6;
// policy ids: the order of repro_torch.cache.flat.POLICY_IDS
constexpr int LRU = 0, FIFO = 1, PROB_LRU = 2, CLOCK = 3, SLRU = 4,
              S3FIFO = 5, SIEVE = 6;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Lane {
  int* k2s;    // (key_space) slot of each key, NIL when absent
  int* exp;    // (key_space) fetch expiry (fused classifier)
  int* s2k;    // (pad) key in each slot, NIL when free
  int* ts;     // (pad) push timestamp
  int* bit;    // (pad) reference bit
  int* aux;    // (pad) second membership bit
  int* ghost;  // (pad) S3-FIFO ghost ring
  int* regs;   // (N_REGS)
  int* red_v;  // (WARPS + 1) reduction scratch
  int* red_i;  // (WARPS + 1)
  int pad;
};

struct Out {
  int hit, evicted;
  int ops[4];
};

__device__ __forceinline__ bool leader() { return threadIdx.x == 0; }

__device__ __forceinline__ void pick_min(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// First index of the minimum of key(i) over [0, n) (jnp.argmin).
template <class F>
__device__ int block_argmin(const Lane& L, int n, F key) {
  int v = IMAX, idx = IMAX;
  for (int i = threadIdx.x; i < n; i += THREADS) pick_min(v, idx, key(i), i);
  for (int off = 16; off > 0; off >>= 1) {
    int v2 = __shfl_down_sync(FULL, v, off);
    int i2 = __shfl_down_sync(FULL, idx, off);
    pick_min(v, idx, v2, i2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    L.red_v[warp] = v;
    L.red_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? L.red_v[lane] : IMAX;
    idx = lane < WARPS ? L.red_i[lane] : IMAX;
    for (int off = 16; off > 0; off >>= 1) {
      int v2 = __shfl_down_sync(FULL, v, off);
      int i2 = __shfl_down_sync(FULL, idx, off);
      pick_min(v, idx, v2, i2);
    }
    if (lane == 0) L.red_i[WARPS] = idx;
  }
  __syncthreads();
  return L.red_i[WARPS];
}

__device__ int block_sum(const Lane& L, int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) L.red_v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? L.red_v[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) L.red_v[WARPS] = v;
  }
  __syncthreads();
  return L.red_v[WARPS];
}

// Slot with minimum ts among mask(i): the masked list's tail.
template <class M>
__device__ int min_slot(const Lane& L, M mask) {
  return block_argmin(L, L.pad, [&](int i) { return mask(i) ? L.ts[i] : IMAX; });
}

template <class M>
__device__ bool block_any(const Lane& L, M pred) {
  int any = 0;
  for (int i = threadIdx.x; i < L.pad; i += THREADS) any |= pred(i) ? 1 : 0;
  return __syncthreads_or(any) != 0;
}

// The guarded mapping clear of _clear_key (no-op when old_key is NIL).
__device__ __forceinline__ void clear_key(const Lane& L, int old_key) {
  if (old_key != NIL) L.k2s[max(old_key, 0)] = NIL;
}

// CLOCK/S3-M eviction scan over a fixed membership mask: reinsert slots
// whose bit is set (at most max_scan of them), evict the first that is
// not.  Updates `now`; returns the victim and sets n_re = scans - 1.
template <class M>
__device__ int clock_scan_evict(const Lane& L, M mask, int max_scan, int& now,
                                int& n_re) {
  int scans = 0, victim = NIL;
  bool done = false;
  while (!done && scans <= max_scan) {
    const int s = min_slot(L, mask);
    const bool give = L.bit[s] != 0 && scans < max_scan;
    __syncthreads();
    if (give && leader()) {
      L.ts[s] = now;
      L.bit[s] = 0;
    }
    __syncthreads();
    now += give ? 1 : 0;
    scans += 1;
    done = !give;
    if (!give) victim = s;
  }
  n_re = scans - 1;
  return victim;
}

// ---- LRU / FIFO / Prob-LRU: branch-free, one argmin on a full miss.
template <int POL>
__device__ Out list_step(const Lane& L, const int* p, float q, int key,
                         float u) {
  const int slot = L.k2s[key];
  const bool hit = slot != NIL;
  const bool reorder = POL == LRU ? true : POL == FIFO ? false : (u >= q);
  const bool miss = !hit;
  const int size = L.regs[R_SIZE], now = L.regs[R_NOW], cap = p[P_CAP];
  const bool full = size >= cap;
  const bool evict = miss && full;
  int victim = 0;
  if (evict) victim = min_slot(L, [&](int i) { return L.s2k[i] != NIL; });
  const int s = hit ? slot : (full ? victim : size);
  const int old_key = L.s2k[s];
  const bool act = miss || (hit && reorder);
  __syncthreads();
  if (leader()) {
    if (miss) {
      L.k2s[evict ? max(old_key, 0) : key] = NIL;
      L.k2s[key] = s;
      L.s2k[s] = key;
    }
    if (act) L.ts[s] = now;
    L.regs[R_SIZE] = min(size + (miss ? 1 : 0), cap);
    L.regs[R_NOW] = now + (act ? 1 : 0);
  }
  return Out{hit, evict ? old_key : NIL,
             {hit && reorder, act, evict, 0}};
}

// Place a missed key into new_slot (the shared tail of every miss path).
__device__ void place(const Lane& L, int key, int new_slot, int now) {
  L.k2s[key] = new_slot;
  L.s2k[new_slot] = key;
  L.ts[new_slot] = now;
  L.bit[new_slot] = 0;
}

// ---- CLOCK
__device__ Out clock_step(const Lane& L, const int* p, int key) {
  const int slot = L.k2s[key];
  if (slot != NIL) {
    __syncthreads();
    if (leader()) L.bit[max(slot, 0)] = 1;
    return Out{1, NIL, {0, 0, 0, 0}};
  }
  const int cap = p[P_CAP], size = L.regs[R_SIZE];
  int now = L.regs[R_NOW];
  Out o{0, NIL, {0, 1, 0, 0}};
  int new_slot = size;
  if (size >= cap) {
    int n_re;
    new_slot = clock_scan_evict(L, [&](int i) { return L.s2k[i] != NIL; },
                                p[P_MAX_SCAN], now, n_re);
    o.evicted = L.s2k[new_slot];
    o.ops[1] += n_re;
    o.ops[2] = 1;
    o.ops[3] = n_re;
  }
  __syncthreads();
  if (leader()) {
    clear_key(L, o.evicted);
    place(L, key, new_slot, now);
    L.regs[R_NOW] = now + 1;
    L.regs[R_SIZE] = min(size + 1, cap);
  }
  return o;
}

// ---- SLRU: probationary (aux=0) and protected (aux=1) over one ts.
__device__ Out slru_step(const Lane& L, const int* p, int key) {
  const int slot0 = L.k2s[key];
  const bool hit = slot0 != NIL;
  const int slot = max(slot0, 0);
  const bool hit_t = hit && L.aux[slot] != 0;
  const int cap = p[P_CAP], prot_cap = p[P_PROT_CAP];
  int now = L.regs[R_NOW], size_t = L.regs[R_SIZET];
  const int size = L.regs[R_SIZE];
  auto occ = [&](int i) { return L.s2k[i] != NIL; };
  if (hit_t) {
    __syncthreads();
    if (leader()) {
      L.ts[slot] = now;
      L.regs[R_NOW] = now + 1;
    }
    return Out{1, NIL, {1, 1, 0, 0}};
  }
  if (hit) {
    __syncthreads();
    if (leader()) {
      L.aux[slot] = 1;
      L.ts[slot] = now;
    }
    __syncthreads();
    now += 1;
    size_t += 1;
    // the promoted slot carries the newest ts, so it is never T's tail
    const bool demote = size_t > prot_cap;
    if (demote) {
      const int t_tail =
          min_slot(L, [&](int i) { return occ(i) && L.aux[i] != 0; });
      if (leader()) {
        L.aux[t_tail] = 0;
        L.ts[t_tail] = now;
      }
      now += 1;
      size_t -= 1;
    }
    if (leader()) {
      L.regs[R_NOW] = now;
      L.regs[R_SIZET] = size_t;
    }
    return Out{1, NIL, {1, 1 + (demote ? 1 : 0), demote ? 1 : 0, 0}};
  }
  Out o{0, NIL, {0, 1, 0, 0}};
  int new_slot = size;
  if (size >= cap) {
    // evict B's tail, falling back to T's tail only when B is empty
    const bool any_b = block_any(L, [&](int i) { return occ(i) && L.aux[i] == 0; });
    new_slot = any_b ? min_slot(L, [&](int i) { return occ(i) && L.aux[i] == 0; })
                     : min_slot(L, [&](int i) { return occ(i) && L.aux[i] != 0; });
    o.evicted = L.s2k[new_slot];
    o.ops[2] = 1;
  }
  // the victim may have come from T: shrink sizeT by its pre-clear bit
  const int was_t = L.aux[new_slot] != 0 ? 1 : 0;
  __syncthreads();
  if (leader()) {
    clear_key(L, o.evicted);
    L.k2s[key] = new_slot;
    L.s2k[new_slot] = key;
    L.ts[new_slot] = now;
    L.aux[new_slot] = 0;
    L.regs[R_NOW] = now + 1;
    L.regs[R_SIZET] = size_t - was_t;
    L.regs[R_SIZE] = min(size + 1, cap);
  }
  return o;
}

// ---- S3-FIFO: small (aux=0) + main (aux=1) + ghost ring.
__device__ void s3_evict_m(const Lane& L, const int* p, Out& o) {
  int now = L.regs[R_NOW];
  const int size_m = L.regs[R_SIZEM];
  int n_re;
  const int victim = clock_scan_evict(
      L, [&](int i) { return L.s2k[i] != NIL && L.aux[i] != 0; },
      p[P_MAX_SCAN], now, n_re);
  const int old_key = L.s2k[victim];
  __syncthreads();
  if (leader()) {
    clear_key(L, old_key);
    L.s2k[victim] = NIL;
    L.aux[victim] = 0;
    L.regs[R_NOW] = now;
    L.regs[R_SIZEM] = size_m - 1;
  }
  __syncthreads();
  o.evicted = old_key;
  o.ops[1] += n_re;
  o.ops[2] += 1;
  o.ops[3] += n_re;
}

__device__ Out s3fifo_step(const Lane& L, const int* p, int key) {
  const int slot = L.k2s[key];
  if (slot != NIL) {
    __syncthreads();
    if (leader()) L.bit[max(slot, 0)] = 1;
    return Out{1, NIL, {0, 0, 0, 0}};
  }
  const int cap = p[P_CAP];
  Out o{0, NIL, {0, 0, 0, 0}};
  const bool in_ghost = block_any(L, [&](int i) { return L.ghost[i] == key; });
  if (in_ghost && L.regs[R_SIZEM] >= p[P_M_CAP]) s3_evict_m(L, p, o);
  if (!in_ghost && L.regs[R_SIZES] >= p[P_S_CAP]) {
    const int s_tail = min_slot(
        L, [&](int i) { return L.s2k[i] != NIL && L.aux[i] == 0; });
    if (L.bit[s_tail] != 0) {
      // promote S's tail to M, making room in M first
      if (L.regs[R_SIZEM] >= p[P_M_CAP]) s3_evict_m(L, p, o);
      const int now = L.regs[R_NOW], size_s = L.regs[R_SIZES],
                size_m = L.regs[R_SIZEM];
      __syncthreads();
      if (leader()) {
        L.ts[s_tail] = now;
        L.aux[s_tail] = 1;
        L.bit[s_tail] = 0;
        L.regs[R_NOW] = now + 1;
        L.regs[R_SIZES] = size_s - 1;
        L.regs[R_SIZEM] = size_m + 1;
      }
      __syncthreads();
      o.ops[1] += 1;
      o.ops[2] += 1;
    } else {
      // evict S's tail into the ghost ring
      const int old_key = L.s2k[s_tail], gpos = L.regs[R_GPOS],
                size_s = L.regs[R_SIZES];
      __syncthreads();
      if (leader()) {
        clear_key(L, old_key);
        L.s2k[s_tail] = NIL;
        L.ghost[gpos] = old_key;
        L.regs[R_GPOS] = (gpos + 1) % p[P_GHOST_CAP];
        L.regs[R_SIZES] = size_s - 1;
      }
      __syncthreads();
      o.ops[2] += 1;
      o.evicted = old_key;
    }
  }
  // place: next warmup slot while filling, else the first free slot
  const int size = L.regs[R_SIZE];
  const int new_slot =
      size < cap ? size
                 : block_argmin(L, L.pad, [&](int i) { return L.s2k[i] == NIL ? 0 : 1; });
  const int now = L.regs[R_NOW], size_s = L.regs[R_SIZES],
            size_m = L.regs[R_SIZEM];
  __syncthreads();
  if (leader()) {
    place(L, key, new_slot, now);
    L.aux[new_slot] = in_ghost ? 1 : 0;
    L.regs[R_NOW] = now + 1;
    L.regs[R_SIZES] = size_s + (in_ghost ? 0 : 1);
    L.regs[R_SIZEM] = size_m + (in_ghost ? 1 : 0);
    L.regs[R_SIZE] = min(size + 1, cap);
  }
  o.ops[1] += 1;
  return o;
}

// ---- SIEVE: the hand walk as one cyclic argmin (see flat.py).
__device__ Out sieve_step(const Lane& L, const int* p, int key) {
  const int slot = L.k2s[key];
  if (slot != NIL) {
    __syncthreads();
    if (leader()) L.bit[max(slot, 0)] = 1;
    return Out{1, NIL, {0, 0, 0, 0}};
  }
  const int cap = p[P_CAP], size = L.regs[R_SIZE], now = L.regs[R_NOW];
  auto occ = [&](int i) { return L.s2k[i] != NIL; };
  Out o{0, NIL, {0, 1, 0, 0}};
  int new_slot = size;
  if (size >= cap) {
    const int tail = min_slot(L, occ);
    const int hand = L.regs[R_HAND];
    const int start = hand == NIL ? tail : hand;
    const int ts_start = L.ts[start];
    // int32, as the reference: ts stays far below the bias
    auto ck = [&](int i) { return L.ts[i] + (L.ts[i] < ts_start ? WRAP_BIAS : 0); };
    const int idx = block_argmin(
        L, L.pad, [&](int i) { return (occ(i) && L.bit[i] == 0) ? ck(i) : IMAX; });
    const bool found = occ(idx) && L.bit[idx] == 0;
    const int victim = found ? idx : start;
    const int ts_v = L.ts[victim], ck_v = ck(victim);
    __syncthreads();
    // cleared set: the cyclic prefix strictly before the victim (all of
    // the occupied slots after a full clearing cycle)
    int cnt = 0;
    for (int i = threadIdx.x; i < L.pad; i += THREADS) {
      if (occ(i) && (!found || ck(i) < ck_v)) {
        L.bit[i] = 0;
        cnt += 1;
      }
    }
    const int scans = block_sum(L, cnt);
    // the hand moves one step toward the head (NIL at the head)
    const int nh = min_slot(L, [&](int i) { return occ(i) && L.ts[i] > ts_v; });
    const int new_hand = (occ(nh) && L.ts[nh] > ts_v) ? nh : NIL;
    o.evicted = L.s2k[victim];
    o.ops[2] = 1;
    o.ops[3] = scans;
    new_slot = victim;
    __syncthreads();
    if (leader()) L.regs[R_HAND] = new_hand;
  }
  __syncthreads();
  if (leader()) {
    clear_key(L, o.evicted);
    place(L, key, new_slot, now);
    L.regs[R_NOW] = now + 1;
    L.regs[R_SIZE] = min(size + 1, cap);
  }
  return o;
}

template <int POL>
__device__ __forceinline__ Out policy_step(const Lane& L, const int* p,
                                           float q, int key, float u) {
  if constexpr (POL == LRU || POL == FIFO || POL == PROB_LRU) {
    return list_step<POL>(L, p, q, key, u);
  } else if constexpr (POL == CLOCK) {
    return clock_step(L, p, key);
  } else if constexpr (POL == SLRU) {
    return slru_step(L, p, key);
  } else if constexpr (POL == S3FIFO) {
    return s3fifo_step(L, p, key);
  } else {
    return sieve_step(L, p, key);
  }
}

__host__ __device__ constexpr int shared_ints(int key_space, int pad) {
  return 2 * key_space + 5 * pad + N_REGS + 2 * (WARPS + 1);
}

template <int POL>
__global__ void __launch_bounds__(THREADS)
    replay_kernel(const int* __restrict__ pvecs, const float* __restrict__ qs,
                  const int* __restrict__ keys, const float* __restrict__ us,
                  const int* __restrict__ wins, int* __restrict__ hits,
                  int* __restrict__ evicted, int* __restrict__ ops,
                  int* __restrict__ cls, int n_t, int key_space, int pad) {
  extern __shared__ int sm[];
  Lane L;
  L.k2s = sm;
  L.exp = L.k2s + key_space;
  L.s2k = L.exp + key_space;
  L.ts = L.s2k + pad;
  L.bit = L.ts + pad;
  L.aux = L.bit + pad;
  L.ghost = L.aux + pad;
  L.regs = L.ghost + pad;
  L.red_v = L.regs + N_REGS;
  L.red_i = L.red_v + WARPS + 1;
  L.pad = pad;

  for (int i = threadIdx.x; i < key_space; i += THREADS) {
    L.k2s[i] = NIL;
    L.exp[i] = FAR_PAST;
  }
  for (int i = threadIdx.x; i < pad; i += THREADS) {
    L.s2k[i] = NIL;
    L.ts[i] = 0;
    L.bit[i] = 0;
    L.aux[i] = 0;
    L.ghost[i] = NIL;
  }
  if (threadIdx.x < N_REGS) L.regs[threadIdx.x] = threadIdx.x == R_HAND ? NIL : 0;
  __syncthreads();

  const size_t lane = blockIdx.x;
  int p[N_PARAMS];
  for (int i = 0; i < N_PARAMS; ++i) p[i] = pvecs[lane * N_PARAMS + i];
  const float q = qs[lane];
  const size_t row = lane * (size_t)n_t;
  for (int t = 0; t < n_t; ++t) {
    const int key = keys[row + t];
    const Out o = policy_step<POL>(L, p, q, key, us[row + t]);
    if (leader()) {
      // fused delayed-hit classification (classify_inflight)
      const bool outstanding = t <= L.exp[key];
      if (!outstanding && !o.hit) L.exp[key] = t + wins[row + t];
      hits[row + t] = o.hit;
      evicted[row + t] = o.evicted;
      ops[row + t] = o.ops[0] | (o.ops[1] << 1) | (o.ops[2] << 9) | (o.ops[3] << 12);
      cls[row + t] = outstanding ? 2 : (o.hit ? 1 : 0);
    }
    __syncthreads();
  }
}

template <int POL>
int launch(const int* pvecs, const float* qs, const int* keys, const float* us,
           const int* wins, int* hits, int* evicted, int* ops, int* cls,
           int lanes, int n_t, int key_space, int pad, cudaStream_t stream) {
  const int bytes = shared_ints(key_space, pad) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      replay_kernel<POL>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 0 || n_t == 0) return 0;
  replay_kernel<POL><<<lanes, THREADS, bytes, stream>>>(
      pvecs, qs, keys, us, wins, hits, evicted, ops, cls, n_t, key_space, pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int replay_shared_bytes(int key_space, int pad) {
  return shared_ints(key_space, pad) * (int)sizeof(int);
}

// Launch one block per lane on `stream`; returns the cudaError_t.
extern "C" int replay_launch(int policy, const int* pvecs, const float* qs,
                             const int* keys, const float* us, const int* wins,
                             int* hits, int* evicted, int* ops, int* cls,
                             int lanes, int n_t, int key_space, int pad,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case LRU:
      return launch<LRU>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case FIFO:
      return launch<FIFO>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case PROB_LRU:
      return launch<PROB_LRU>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case CLOCK:
      return launch<CLOCK>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case SLRU:
      return launch<SLRU>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case S3FIFO:
      return launch<S3FIFO>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    case SIEVE:
      return launch<SIEVE>(pvecs, qs, keys, us, wins, hits, evicted, ops, cls, lanes, n_t, key_space, pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
