// The streaming sketch of one lane, run by one warp: the device side of
// repro_torch/obs/streaming.py (the reference's src/repro/obs/streaming.py
// stream_tick, stream_arrival, stream_done, stream_done_many, stream_key).
//
// Included by event_sim_sketch.cu (the sketched instantiations of the
// event-sim kernel) and by sketch_trace.cu, so the sketch_trace kernel
// runs the code the simulator runs (but for the SpaceSaving table, which
// sketch_trace.cu keeps in registers: RegTable, at the end).
//
// Where the state lives: the SketchState tensors in device memory, the
// lane's rows at lane * row length.  The current window's four counters
// (completions, hits, delayed hits, arrivals) are registers, the same in
// every thread, loaded when the ring enters a window (zero if its row was
// stale) and stored back when it leaves it and at the end; the
// per-branch window row and the count-min rows take reductions to device
// memory (atomicAdd whose result is unused compiles to RED: the warp does
// not wait for it, but on an H100 each costs a lone warp some 50 cycles,
// in shared memory as in device memory, tools/sketch_trace_ablation.py's
// adds probe; so staging the rows in shared memory gains nothing, and
// sketch_trace.cu makes fewer adds instead).  The count-min row r is
// written only by thread r (here; sketch_trace.cu's batched adds come
// from every thread, atomically), and SpaceSaving slot i only by thread
// i % 32: it reads its own slots' keys and counts, the warp reduces the
// lowest matching slot
// (or the lowest slot of the least count) by redux.sync, and the slot's
// owner writes it.  So no word passes between threads through memory,
// except at a window change, which zeroes a stale branch row: a
// __syncwarp() orders the row's earlier adds, from any thread, before
// the zeroing.  The EWMA scalars, the key count, the current window id
// and its span of elapsed times, [lo, hi), are registers too: an event
// inside the span needs two compares, and only an event outside it
// computes its window (the division) and the new span.
//
// Float32: the EWMA step s * decay + x is one __fmaf_rn, as XLA's CPU
// backend fuses the reference's; the norm's s * decay a __fmul_rn; the
// window id floorf(__fdiv_rn(elapsed, window_us)); the batch decay
// (1 - alpha)^n is read from the host's table.  Hashes are uint32 with
// wraparound, as the reference's.  The span's ends are the least floats
// whose window id reaches the window's and the next one's, found by
// stepping from k * window_us a float at a time: IEEE division is
// monotone, so the span holds exactly the elapsed times of the window.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// The SketchState tensors of every lane (lanes, ...), and the sketch's
// sizes; the layout of repro_torch.kernels.sketch._SketchArgs.
struct SketchArgs {
  int* win_id;      // (lanes, W + 1)
  int* win_done;    // (lanes, W + 1)
  int* win_hit;     // (lanes, W + 1)
  int* win_dly;     // (lanes, W + 1)
  int* win_arr;     // (lanes, W + 1)
  int* win_br;      // (lanes, W + 1, B)
  float* ewma_hit;  // (lanes)
  float* ewma_dly;  // (lanes)
  float* ewma_norm; // (lanes)
  int* cm;          // (lanes, CM_DEPTH, width + 1)
  int* ss_key;      // (lanes, K + 1)
  int* ss_count;    // (lanes, K + 1)
  int* ss_err;      // (lanes, K + 1)
  int* key_count;   // (lanes)
  const float* decay;  // (n_decay) float32 (1 - alpha)^n
  const int* bmiss;    // (lanes, B) simulator: 1 if the branch is a miss
  float window_us;
  int n_windows, n_b, cap, width, n_decay;
};

namespace sketch {

constexpr int CM_DEPTH = 4;
constexpr uint32_t CM_MULT = 0x9E3779B1u;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t cm_salt(int r) {
  return r == 0 ? 0x9E3779B9u : r == 1 ? 0x85EBCA6Bu : r == 2 ? 0xC2B2AE35u : 0x27D4EB2Fu;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// stream_key's count-min half: the offset of key k's column in row r of a
// lane's count-min rows (Lane::observe's), and its +1 by thread r (a RED:
// nothing waits for it)
__device__ __forceinline__ int cm_offset(int k, int r, int width) {
  const uint32_t h = mix32(static_cast<uint32_t>(k) * CM_MULT + cm_salt(r));
  return r * (width + 1) + static_cast<int>(h % static_cast<uint32_t>(width));
}
__device__ __forceinline__ void cm_add(int* cm, int width, int me, int k) {
  if (me < CM_DEPTH) atomicAdd(&cm[cm_offset(k, me, width)], 1);
}

// One lane's sketch, held by every thread of its warp.
struct Lane {
  int *win_id, *done, *hit, *dly, *arr, *br, *cm, *key, *cnt, *err;
  const float* decay;
  float window_us, s_hit, s_dly, s_norm, lo, hi;
  int W, B, K, width, key_count, wid, slot, me;
  int c_done, c_hit, c_dly, c_arr;  // the current window's counters
  float alpha, one_minus;

  __device__ void init(const SketchArgs& s, int lane, int thread) {
    const size_t w1 = static_cast<size_t>(s.n_windows) + 1;
    const size_t k1 = static_cast<size_t>(s.cap) + 1;
    win_id = s.win_id + lane * w1;
    done = s.win_done + lane * w1;
    hit = s.win_hit + lane * w1;
    dly = s.win_dly + lane * w1;
    arr = s.win_arr + lane * w1;
    br = s.win_br + lane * w1 * s.n_b;
    cm = s.cm + static_cast<size_t>(lane) * CM_DEPTH * (s.width + 1);
    key = s.ss_key + lane * k1;
    cnt = s.ss_count + lane * k1;
    err = s.ss_err + lane * k1;
    decay = s.decay;
    window_us = s.window_us;
    W = s.n_windows;
    B = s.n_b;
    K = s.cap;
    width = s.width;
    me = thread;
    s_hit = s.ewma_hit[lane];
    s_dly = s.ewma_dly[lane];
    s_norm = s.ewma_norm[lane];
    key_count = s.key_count[lane];
    wid = -1;  // no tick yet: an empty span
    lo = __int_as_float(0x7f800000);  // +inf
    hi = -lo;
    slot = 0;
    c_done = c_hit = c_dly = c_arr = 0;
    alpha = 0.01f;
    one_minus = 1.0f - alpha;
  }

  // the window id of elapsed time e (the reference's, clamped at 0)
  __device__ __forceinline__ int window_of(float e) const {
    return max(static_cast<int>(floorf(__fdiv_rn(e, window_us))), 0);
  }

  // the least float whose window id is at least k (k >= 1)
  __device__ float edge(int k) const {
    float c = __fmul_rn(static_cast<float>(k), window_us);
    const float inf = __int_as_float(0x7f800000);
    while (window_of(c) >= k) c = nextafterf(c, -inf);
    while (window_of(c) < k) c = nextafterf(c, inf);
    return c;
  }

  // stream_tick: the ring row of the window holding elapsed_us, zeroed
  // if it holds an older window.  An event in the same window as the
  // last tick's needs nothing (its row holds it).
  __device__ __forceinline__ void tick(float elapsed_us) {
    if (elapsed_us >= lo && elapsed_us < hi) return;
    const int w = window_of(elapsed_us);
    lo = w == 0 ? -__int_as_float(0x7f800000) : edge(w);
    hi = edge(w + 1);
    if (w == wid) return;
    store_window();  // the window the ring leaves
    wid = w;
    slot = w % W;
    __syncwarp();  // every add to the ring so far is done
    if (win_id[slot] == w) {  // the window again (time went back)
      c_done = done[slot];
      c_hit = hit[slot];
      c_dly = dly[slot];
      c_arr = arr[slot];
    } else {
      c_done = c_hit = c_dly = c_arr = 0;
      for (int b = me; b < B; b += 32) br[slot * B + b] = 0;
    }
    __syncwarp();  // every thread read win_id before thread 0 writes it
    if (me == 0) win_id[slot] = w;
  }

  // the current window's counters to its row (thread 0)
  __device__ __forceinline__ void store_window() {
    if (wid >= 0 && me == 0) {
      done[slot] = c_done;
      hit[slot] = c_hit;
      dly[slot] = c_dly;
      arr[slot] = c_arr;
    }
  }

  // stream_arrival
  __device__ __forceinline__ void arrival() { c_arr += 1; }

  // stream_done: one completion on branch b (a branch past the table is
  // not counted per branch, as JAX drops the scatter)
  __device__ __forceinline__ void completion(int b, bool is_hit, bool delayed) {
    c_done += 1;
    c_hit += is_hit ? 1 : 0;
    c_dly += delayed ? 1 : 0;
    if (me == 0 && b < B) atomicAdd(&br[slot * B + b], 1);
    s_hit = __fmaf_rn(s_hit, one_minus, is_hit ? alpha : 0.0f);
    s_dly = __fmaf_rn(s_dly, one_minus, delayed ? alpha : 0.0f);
    s_norm = __fmul_rn(s_norm, one_minus);
  }

  // stream_done_many, in two parts: each woken job's owner counts its
  // branch (many_branch), then the warp counts the n of them (many)
  __device__ __forceinline__ void many_branch(int b) {
    if (b < B) atomicAdd(&br[slot * B + b], 1);
  }
  __device__ __forceinline__ void many(int n) {
    c_done += n;
    c_dly += n;
    const float d = decay[n];
    s_hit = __fmul_rn(s_hit, d);
    s_dly = __fmaf_rn(s_dly, d, 1.0f - d);
    s_norm = __fmul_rn(s_norm, d);
  }

  // stream_key: count-min row r by thread r; SpaceSaving slot i by
  // thread i % 32 (its key and count read by it alone)
  __device__ __forceinline__ void observe(int k) {
    const uint32_t ku = static_cast<uint32_t>(k);
    if (me < CM_DEPTH) {
      const uint32_t h = mix32(ku * CM_MULT + cm_salt(me));
      atomicAdd(&cm[me * (width + 1) + static_cast<int>(h % static_cast<uint32_t>(width))], 1);
    }
    int my_match = INT_MAX, my_min = INT_MAX, my_arg = INT_MAX;
    for (int i = me; i < K; i += 32) {
      const int c = cnt[i];
      if (my_match == INT_MAX && key[i] == k) my_match = i;
      if (c < my_min) {
        my_min = c;
        my_arg = i;
      }
    }
    const int match = __reduce_min_sync(FULL_MASK, my_match);
    int j = match;
    if (match == INT_MAX) {
      const int least = __reduce_min_sync(FULL_MASK, my_min);
      j = __reduce_min_sync(FULL_MASK, my_min == least ? my_arg : INT_MAX);
    }
    if (me == (j & 31)) {
      const int c = cnt[j];
      const int e = err[j];
      key[j] = k;
      cnt[j] = c + 1;
      err[j] = match == INT_MAX ? c : e;
    }
    key_count += 1;
  }

  // the registers back to the state (thread 0), after the last event
  __device__ __forceinline__ void finish(const SketchArgs& s, int lane) {
    store_window();
    if (me == 0) {
      s.ewma_hit[lane] = s_hit;
      s.ewma_dly[lane] = s_dly;
      s.ewma_norm[lane] = s_norm;
      s.key_count[lane] = key_count;
    }
  }
};

// The SpaceSaving table in registers, for sketch_trace.cu alone (the
// event-sim kernel keeps Lane::observe).  Slot i belongs to thread i % 32
// at register index i / 32, as in Lane::observe, so S slots a thread hold
// caps up to 32 * S (the host's ladder: 1, 2, 4, 8, 16).  Slots at or past
// K never match and are never least.  The arrays are indexed only by
// unrolled constants: no stack, no local memory.
//
// PACKED: each slot's count is kept as the word a miss offers the warp,
// PACK_MISS | count << PACK_SLOT_BITS | slot, and a match offers its slot
// alone, so one redux.sync.min gives the lowest matching slot, or else the
// lowest slot of the least count, with that count: stream_key's choice.
// It needs every count below 2^PACK_COUNT_BITS, which a stream of fewer
// keys than that keeps (the host chooses).  Unpacked: the count itself and
// Lane::observe's three reductions (match; least; its lowest slot).
//
// Per key the owner of the chosen slot writes nothing to device memory
// but err on a replacement; keys and counts are written back by store().
constexpr int PACK_SLOT_BITS = 9;  // slots < 512
constexpr int PACK_COUNT_BITS = 31 - PACK_SLOT_BITS;
constexpr uint32_t PACK_MISS = 0x80000000u;
constexpr uint32_t PACK_NONE = 0xffffffffu;  // a slot past K

template <int S, bool PACKED>
struct RegTable {
  static_assert(S >= 1 && 32 * S <= (1 << PACK_SLOT_BITS), "S in 1..16");
  static constexpr int LOG2_S = S >= 16 ? 4 : S >= 8 ? 3 : S >= 4 ? 2 : S >= 2 ? 1 : 0;
  static constexpr uint32_t NONE = PACKED ? PACK_NONE : static_cast<uint32_t>(INT_MAX);
  int key[S];
  uint32_t word[S];  // PACKED: the miss word; else the count (INT_MAX past K)
  uint32_t slot[S];  // what a match offers: the slot, NONE past K

  __device__ __forceinline__ void load(const Lane& sk) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int i = sk.me + 32 * r;
      const bool in = i < sk.K;
      slot[r] = in ? static_cast<uint32_t>(i) : NONE;
      key[r] = in ? sk.key[i] : 0;
      const uint32_t c = in ? static_cast<uint32_t>(sk.cnt[i]) : 0u;
      word[r] = !in ? NONE : PACKED ? PACK_MISS | c << PACK_SLOT_BITS | slot[r] : c;
    }
  }

  static constexpr bool kCountsMin = false;  // the caller counts key k

  // stream_key's SpaceSaving half and the key count
  __device__ __forceinline__ void search(Lane& sk, int k) {
    int j, least;
    bool miss;
    if constexpr (PACKED) {
      uint32_t w[S];
#pragma unroll
      for (int r = 0; r < S; ++r) w[r] = key[r] == k ? slot[r] : word[r];
#pragma unroll
      for (int lg = 0; lg < LOG2_S; ++lg) {  // a tree: log2 S deep
#pragma unroll
        for (int r = 0; r + (1 << lg) < S; r += 2 << lg) w[r] = min(w[r], w[r + (1 << lg)]);
      }
      const uint32_t got = __reduce_min_sync(FULL_MASK, w[0]);
      miss = got >= PACK_MISS;
      j = static_cast<int>(got & ((1u << PACK_SLOT_BITS) - 1));
      least = static_cast<int>((got >> PACK_SLOT_BITS) & ((1u << PACK_COUNT_BITS) - 1));
    } else {
      uint32_t my_match = NONE, my_min = NONE, my_arg = NONE;
#pragma unroll
      for (int r = S - 1; r >= 0; --r) {  // down, so the lowest slot wins
        if (key[r] == k) my_match = slot[r];
        if (word[r] <= my_min) {
          my_min = word[r];
          my_arg = slot[r];
        }
      }
      const int match = __reduce_min_sync(FULL_MASK, static_cast<int>(my_match));
      j = match;
      miss = match == INT_MAX;
      least = 0;
      if (miss) {
        least = __reduce_min_sync(FULL_MASK, static_cast<int>(my_min));
        j = __reduce_min_sync(FULL_MASK, static_cast<int>(my_min) == least
                                             ? static_cast<int>(my_arg) : INT_MAX);
      }
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (slot[r] == static_cast<uint32_t>(j)) {  // the chosen slot's owner
        key[r] = k;
        word[r] += PACKED ? 1u << PACK_SLOT_BITS : 1u;
      }
    }
    // the evicted count, by the slot's owner: a predicated store, not a
    // branch the warp would reconverge from on every key
    const unsigned owner = miss && sk.me == (j & 31);
    asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.u32 [%0], %1;\n}"
                 ::"l"(sk.err + j), "r"(least), "r"(owner) : "memory");
    sk.key_count += 1;
  }

  // keys and counts back to the state
  __device__ __forceinline__ void store(const Lane& sk) const {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (slot[r] != NONE) {
        const int i = sk.me + 32 * r;
        sk.key[i] = key[r];
        sk.cnt[i] = PACKED ? static_cast<int>(word[r] >> PACK_SLOT_BITS &
                                              ((1u << PACK_COUNT_BITS) - 1))
                           : static_cast<int>(word[r]);
      }
    }
  }
};

}  // namespace sketch
