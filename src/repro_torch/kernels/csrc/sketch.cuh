// The streaming sketch of one lane, run by one warp: the device side of
// repro_torch/obs/streaming.py (the reference's src/repro/obs/streaming.py
// stream_tick, stream_arrival, stream_done, stream_done_many, stream_key).
//
// Included by event_sim_sketch.cu (the sketched instantiations of the
// event-sim kernel) and by sketch_trace.cu, so the sketch_trace kernel
// runs the code the simulator runs.
//
// Where the state lives: the SketchState tensors in device memory, the
// lane's rows at lane * row length (a variant staging the SpaceSaving
// table and the count-min rows in shared memory gained nothing on the
// card, so it was not kept).  The current window's four counters
// (completions, hits, delayed hits, arrivals) are registers, the same in
// every thread, loaded when the ring enters a window (zero if its row was
// stale) and stored back when it leaves it and at the end; the
// per-branch window row and the count-min rows take reductions to device
// memory (atomicAdd whose result is unused compiles to RED, which the
// warp does not wait for).  The count-min row r is written only by
// thread r, and SpaceSaving slot i only by thread i % 32: it reads its
// own slots' keys and counts, the warp reduces the lowest matching slot
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

}  // namespace sketch
