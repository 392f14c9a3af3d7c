// The streaming sketch of one lane, run by one warp: the device side of
// repro_torch/obs/streaming.py (the reference's src/repro/obs/streaming.py
// stream_tick, stream_arrival, stream_done, stream_done_many, stream_key).
//
// Included by event_sim.cuh (the sketched instantiations of the event-sim
// kernel: Lane in place, or SimLane, at the end) and by sketch_trace.cu,
// so the sketch_trace kernel runs the code the simulator runs (but for the
// SpaceSaving table, which sketch_trace.cu keeps in registers: RegTable).
//
// Where the state lives: the SketchState tensors in device memory, the
// lane's rows at lane * row length.  The current window's four counters
// (completions, hits, delayed hits, arrivals) are registers, the same in
// every thread, loaded when the ring enters a window (zero if its row was
// stale) and stored back when it leaves it and at the end.  Lane::
// completion and Lane::observe add to the per-branch window row and the
// count-min rows in device memory by reductions (atomicAdd whose result is
// unused compiles to RED): the warp does not wait for them, but on an H100
// each costs a lone warp some 50 cycles, in shared memory as in device
// memory (tools/sketch_trace_ablation.py's adds probe), so both kernels
// make fewer of them: sketch_trace.cu batches a block's keys, and
// SimLane keeps the window's per-branch completions in registers and
// batches its keys' count-min adds (see there).  The count-min row r is
// written only by thread r in Lane::observe; the batched adds come from
// every thread, atomically.  SpaceSaving slot i belongs to thread i % 32:
// it reads its own slots' keys and counts, the warp reduces the lowest
// matching slot (or the lowest slot of the least count) by redux.sync,
// and the slot's owner writes it.  So no word passes between threads
// through memory, except at a window change, which zeroes a stale branch
// row: a __syncwarp() orders the row's earlier adds, from any thread,
// before the zeroing.  The EWMA scalars, the key count, the current window
// id and its span of elapsed times, [lo, hi), are registers too: an event
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

// One lane's sketch, held by every thread of its warp.  The event-sim
// kernel calls it in place, at the reference's sites, in the modes that
// observe no key (kLog false; SimLane, at the end, logs the others).
struct Lane {
  static constexpr bool kLog = false;
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
    int w;
    if (leaves_window(elapsed_us, w)) enter_window(w);
  }

  // tick's test: false while elapsed_us lies in the current window, else
  // its window w and span [lo, hi), and whether the ring must move
  __device__ __forceinline__ bool leaves_window(float elapsed_us, int& w) {
    if (elapsed_us >= lo && elapsed_us < hi) return false;
    w = window_of(elapsed_us);
    lo = w == 0 ? -__int_as_float(0x7f800000) : edge(w);
    hi = edge(w + 1);
    return w != wid;
  }

  // the ring's move to window w: the window it leaves stored, w's row
  // reloaded (time went back) or zeroed
  __device__ __forceinline__ void enter_window(int w) {
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

  // stream_key: count-min row r by thread r, then the SpaceSaving search
  __device__ __forceinline__ void observe(int k) {
    cm_add(cm, width, me, k);
    search(k);
  }

  // stream_key's SpaceSaving half on the table in device memory, and the
  // key count: slot i by thread i % 32 (its key and count read by it
  // alone), three warp reductions (match; least; its lowest slot)
  __device__ __forceinline__ void search(int k) {
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

// The SpaceSaving table in registers (sketch_trace.cu).  Slot i belongs
// to thread i % 32 at register index i / 32, as in Lane::search, so S
// slots a thread hold caps up to 32 * S
// (the host's ladder: 1, 2, 4, 8, 16).  Slots at or past K never match
// and are never least.  The arrays are indexed only by unrolled
// constants: no stack, no local memory.
//
// PACKED: each slot's count is kept as the word a miss offers the warp,
// PACK_MISS | count << PACK_SLOT_BITS | slot, and a match offers its slot
// alone, so one redux.sync.min gives the lowest matching slot, or else the
// lowest slot of the least count, with that count: stream_key's choice.
// It needs every count below 2^PACK_COUNT_BITS, which a stream of fewer
// keys than that keeps (the host chooses).  Unpacked: the count itself and
// Lane::search's three reductions (match; least; its lowest slot).
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

// The table in device memory, searched by Lane::search (three reductions):
// SimLane's, at every cap.
struct DeviceTable {
  static constexpr bool kCountsMin = false;
  __device__ __forceinline__ void load(const Lane&) {}
  __device__ __forceinline__ void search(Lane& sk, int k) { sk.search(k); }
  __device__ __forceinline__ void store(const Lane&) const {}
};

// The event-sim kernel's sketch in the modes that observe keys or wake
// jobs (coalescing, the open loop, the tiers; traced or not): Lane, with
// its work off the event's chain.
//
// What bounds the sketched kernel: the event sim's serial chain (each
// event's argmin reads the ready times the last one wrote; event_sim.cu's
// header), which the sketch lengthens by whatever it makes the warp issue
// or wait for between two events.  On an H100 a lone warp pays for every
// instruction it issues: some 50 cycles for an atomic add, ~28 for a
// store (tools/sketch_trace_ablation.py's adds probe), and the code of
// the sketch's rare paths, a window change's above all (a division,
// loops, __syncwarp, the row's zeroing), costs the long loops of these
// modes by its mere presence between the argmin and the owner's shuffles
// (tools/event_sim_sketch_ablation.py times each step).  So:
//
// * each event only logs what the sketch needs, in registers of thread
//   n % 32 for the n-th event of the log (event_sim.cuh EventLog: its
//   time, whether it is an arrival, how many jobs it wakes, the key it
//   observes, and j's completion as the word 2 b + hit, which j's owner
//   shuffles at the end of the event and the thread takes at the top of
//   the next one); the woken jobs' branches go to a log in shared memory,
//   each at its owner's place (a ballot prefix).  The kernel leaves its
//   event loop when 32 events are logged (or the woken log fills), and
//   replay_block() runs Lane over them, in the reference's order where it
//   matters, outside the loop.  The closed, counting and traced closed
//   modes, whose short loops a log costs more than it saves, keep Lane in
//   place at the reference's sites.
// * the window's completions per branch are registers, branch b in thread
//   b (every path runs at most 32 branches: fig_cluster's 16 shards); each
//   thread adds its count to the row when the ring leaves the window
//   (tick) and at the end, by one atomic add, so a window that comes back
//   to a slot keeps its row.  A branch past 32 keeps thread 0's add, and
//   the woken jobs' branches one atomic add per 32 of them.
// * the n-th observed key of a block of 32 waits in thread n % 32; a full
//   block, and the partial one at the end, makes four warp-wide atomic
//   adds (row r's column of each thread's key).
// * Table: the SpaceSaving table, DeviceTable at every cap (Lane::search,
//   three reductions a key).  In the replay the table in registers
//   (RegTable, sketch_trace.cu's) gains little on lanes that observe keys
//   and nothing on lanes that observe none, such as fig_drift D's open
//   loop, so the kernel keeps one form (the ablation times the others).
template <class Table = DeviceTable>
struct SimLane : Lane {
  static constexpr bool kLog = true;
  Table tab;
  int br_n;          // completions on branch me not in the row
  int cm_key, cm_n;  // this thread's waiting key; keys waiting

  __device__ __forceinline__ void init(const SketchArgs& s, int lane, int thread) {
    Lane::init(s, lane, thread);
    tab.load(*this);
    br_n = 0;
    cm_key = 0;
    cm_n = 0;
  }

  // this window's counts of branch me to its row
  __device__ __forceinline__ void flush_branch() {
    if (br_n != 0 && me < B) atomicAdd(&br[slot * B + me], br_n);
    br_n = 0;
  }

  // Lane::tick, this window's per-branch counts to its row first
  __device__ __forceinline__ void tick(float elapsed_us) {
    int w;
    if (leaves_window(elapsed_us, w)) {
      flush_branch();
      enter_window(w);
    }
  }

  // the waiting keys' count-min columns, four adds of the warp
  __device__ __forceinline__ void flush_cm() {
    if (me < cm_n) {
#pragma unroll
      for (int r = 0; r < CM_DEPTH; ++r) atomicAdd(&cm[cm_offset(cm_key, r, width)], 1);
    }
    cm_n = 0;
  }

  // stream_key
  __device__ __forceinline__ void observe(int k) {
    if constexpr (!Table::kCountsMin) {
      if (me == cm_n) cm_key = k;
      if (++cm_n == 32) flush_cm();
    }
    tab.search(*this, k);
  }

  // 32 logged events in order, thread i holding event i's record (in: an
  // event there): rt its elapsed time, ra its arrival (bit 0) and the jobs
  // it woke (ra >> 1), rk the key it observed (-1: none), rw its
  // completion word; the woken jobs' branches lie in wlog, event by event.
  // The reference's order per event (tick, arrival, the woken batch, j's
  // completion, the key) holds where it matters: the events are cut into
  // runs of one window with a tick at the head of each (an event outside
  // the span of the ring's current window, [lo, hi), heads a run: two
  // compares of each event by its own thread); a run's integer counts are
  // added at once (popcounts of ballots; its completions per branch by one
  // ballot per branch present); its EWMA steps, which do not commute, are
  // made event by event; the keys, whose counts do not depend on the
  // window, after the runs, in order.
  __device__ __forceinline__ void replay_block(bool in, float rt, int ra, int rk,
                                               int rw, const int* wlog) {
    const unsigned present = __ballot_sync(FULL_MASK, in);
    const int nw = in ? ra >> 1 : 0;
    const bool done_i = in && rw >= 0;
    const int b_i = rw >> 1;
    const unsigned arr_m = __ballot_sync(FULL_MASK, in && (ra & 1) != 0);
    const unsigned done_m = __ballot_sync(FULL_MASK, done_i);
    const unsigned hit_m = __ballot_sync(FULL_MASK, done_i && (rw & 1) != 0);
    const unsigned many_m = __ballot_sync(FULL_MASK, nw > 0);
    const float my_d = nw > 0 ? decay[nw] : 1.0f;
    int wp = 0;  // the next woken job's place in wlog
    // runs of one window: the events from `at` on in the span of the
    // ring's current window, up to the first that is not, which ticks
    const int end_all = 32 - __clz(present);
    for (int at = __ffs(present) - 1; at < end_all;) {
      const unsigned from = ~((1u << at) - 1u);
      const unsigned out =
          __ballot_sync(FULL_MASK, in && !(rt >= lo && rt < hi)) & from;
      const int end = out ? __ffs(out) - 1 : end_all;
      const unsigned below = end >= 32 ? FULL_MASK : (1u << end) - 1u;
      const unsigned run = present & below & from;
      const bool mine = (run >> me & 1u) != 0;
      // its integer counts
      const int woken = __reduce_add_sync(FULL_MASK, mine ? nw : 0);
      c_arr += __popc(arr_m & run);
      c_done += woken + __popc(done_m & run);
      c_hit += __popc(hit_m & run);
      c_dly += woken;
      for (int q = me; q < woken; q += 32) {  // the woken jobs' branches
        const int b = wlog[wp + q];
        if (b < B) atomicAdd(&br[slot * B + b], 1);
      }
      wp += woken;
      // the completions per branch: b < 32 to thread b, past it by an add
      const bool reg = mine && done_i && b_i < min(B, 32);
      if (mine && done_i && b_i >= 32 && b_i < B) atomicAdd(&br[slot * B + b_i], 1);
      for (unsigned todo = __ballot_sync(FULL_MASK, reg); todo != 0u;) {
        const int b = __shfl_sync(FULL_MASK, b_i, __ffs(todo) - 1);
        const unsigned same = __ballot_sync(FULL_MASK, reg && b_i == b);
        if (me == b) br_n += __popc(same);
        todo &= ~same;
      }
      // the EWMA steps, event by event
      for (unsigned ew = (done_m | many_m) & run; ew != 0u; ew &= ew - 1u) {
        const int i = __ffs(ew) - 1;
        if (many_m >> i & 1u) {
          const float d = __shfl_sync(FULL_MASK, my_d, i);
          s_hit = __fmul_rn(s_hit, d);
          s_dly = __fmaf_rn(s_dly, d, 1.0f - d);
          s_norm = __fmul_rn(s_norm, d);
        }
        if (done_m >> i & 1u) {
          s_hit = __fmaf_rn(s_hit, one_minus, (hit_m >> i & 1u) ? alpha : 0.0f);
          s_dly = __fmaf_rn(s_dly, one_minus, 0.0f);
          s_norm = __fmul_rn(s_norm, one_minus);
        }
      }
      if (end < end_all) tick(__shfl_sync(FULL_MASK, rt, end));
      at = end;
    }
    // the keys, in order
    for (unsigned km = __ballot_sync(FULL_MASK, in && rk >= 0); km != 0u; km &= km - 1u)
      observe(__shfl_sync(FULL_MASK, rk, __ffs(km) - 1));
  }

  // the registers back to the state, after the last event (and its
  // replay)
  __device__ __forceinline__ void finish(const SketchArgs& s, int lane) {
    flush_branch();
    flush_cm();
    tab.store(*this);
    Lane::finish(s, lane);
  }
};

}  // namespace sketch
