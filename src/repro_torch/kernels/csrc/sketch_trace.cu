// sketch_trace: the streaming estimators over replayed key streams, one
// warp per stream.
//
// Replaces src/repro/obs/streaming.py::_sketch_trace, a jitted lax.scan
// (the reference has no Pallas kernel for it).  Per event, in the
// reference's order: tick, arrival, key, completion (branch 0, a hit as
// the stream says, never delayed).  The tick, window counters and EWMA
// steps are sketch.cuh's Lane, which the event-sim kernel's sketched
// instantiations run too, and the count-min columns its cm_offset (Lane::
// observe's hash); repro_torch/kernels/sketch.py holds the plain version
// (sketch_trace_plain), event for event.
//
// What bounds it: the serial dependence between a stream's events (each
// SpaceSaving search reads the table the last event left), not bytes or
// operations.  With the table spread over the warp, choosing a key's slot
// takes at least one warp-wide reduction, so a stream of n keys takes at
// least n of them in a row: chip_smoke.py's chain bound.  The design keeps
// that chain short:
//
// * the table lives in registers (sketch::RegTable<S, PACKED>: S slots a
//   thread, caps up to 32 * S); a cap over 512 keeps it in device memory
//   (GlobalTable: Lane::observe, the S = 0 instantiation);
// * PACKED: one redux.sync.min per key, on a word that orders a match
//   before any miss and misses by (count, slot); the host takes it when
//   the stream is short enough for every count to fit;
// * the stream's keys, times and hits are read 32 events at a time, one
//   per thread (kAhead: the next 32 are loaded while these are consumed,
//   so the load's latency hides behind 32 keys of work);
// * no memory operation a key but the search's (kBatch): a block's
//   count-min adds are made at once by its 32 threads, the branch row is
//   the done counter's, and only a key whose window changes ticks.

#include "sketch.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The S = 0 table: the state's SpaceSaving rows in device memory, searched
// by Lane::observe, which counts the key's count-min columns too.
struct GlobalTable {
  static constexpr bool kCountsMin = true;
  __device__ __forceinline__ void load(const sketch::Lane&) {}
  __device__ __forceinline__ void search(sketch::Lane& sk, int k) { sk.observe(k); }
  __device__ __forceinline__ void store(const sketch::Lane&) const {}
};

// kAhead: block b + 1 of the events is loaded while block b is consumed.
//
// kBatch: no memory operation a key but the search's.  On an H100 a lone
// warp's atomic add costs it some 50 cycles, to device or shared memory
// alike (tools/sketch_trace_ablation.py's adds probe), and the keys' adds
// wait on no key:
// - the count-min rows take a block's adds at once, four atomic adds of
//   32 threads (row r's column of each thread's key: stream_key's, in
//   another order, which the integer sums do not see);
// - the branch row takes none: every event completes on branch 0, so that
//   row holds the window's completions, which the done counter holds too;
//   thread 0 writes it when the ring leaves the window and at the end,
//   and completion is told a branch past the table (which it does not
//   count per branch);
// - only the events whose window differs from the last one's tick (the
//   tick leaves the state as it is otherwise): the block is cut into runs
//   of one window, a tick at the head of each; a block's hits are a
//   ballot, and the next key is shuffled while this one is searched.
template <class Table, bool kAhead, bool kBatch>
__global__ void __launch_bounds__(32)
    sketch_trace_kernel(const SketchArgs s, const int* __restrict__ keys,
                        const float* __restrict__ t_us,
                        const int* __restrict__ hits, int n) {
  const int lane = blockIdx.x;
  const int me = threadIdx.x;
  sketch::Lane sk;
  sk.init(s, lane, me);
  Table tab;
  tab.load(sk);
  const size_t row = static_cast<size_t>(lane) * n;
  int my_key = 0, my_hit = 0, nx_key = 0, nx_hit = 0;
  float my_t = 0.0f, nx_t = 0.0f;
  int last_w = -1;  // the window of the event before the block (none yet)
  const auto fetch = [&](int base, int& k, float& t, int& h) {
    const int e = base + me;
    if (e < n) {
      k = keys[row + e];
      t = t_us[row + e];
      h = hits[row + e];
    }
  };
  // kBatch: the window the ring leaves gets its branch-0 count
  const auto store_branch = [&] {
    if (me == 0 && sk.wid >= 0 && sk.B > 0) sk.br[sk.slot * sk.B] = sk.c_done;
  };
  if (kAhead) fetch(0, nx_key, nx_t, nx_hit);
  for (int base = 0; base < n; base += 32) {
    if (kAhead) {
      my_key = nx_key;
      my_t = nx_t;
      my_hit = nx_hit;
      fetch(base + 32, nx_key, nx_t, nx_hit);  // used by the next block
    } else {
      fetch(base, my_key, my_t, my_hit);
    }
    const int m = min(32, n - base);
    if constexpr (kBatch) {
      const bool in = me < m;
      const int my_w = in ? sk.window_of(my_t) : 0;
      int prev = __shfl_up_sync(FULL, my_w, 1);
      if (me == 0) prev = last_w;
      const unsigned moved = __ballot_sync(FULL, in && my_w != prev);
      const unsigned hit = __ballot_sync(FULL, in && my_hit > 0);
      last_w = __shfl_sync(FULL, my_w, m - 1);
      if constexpr (!Table::kCountsMin) {
        if (in) {
#pragma unroll
          for (int r = 0; r < sketch::CM_DEPTH; ++r)
            atomicAdd(&sk.cm[sketch::cm_offset(my_key, r, sk.width)], 1);
        }
      }
      // runs of events in one window: a tick at the head of each run
      int k = __shfl_sync(FULL, my_key, 0);
      for (int at = 0; at < m;) {
        if (moved >> at & 1u) {
          store_branch();
          sk.tick(__shfl_sync(FULL, my_t, at));
        }
        const unsigned later = moved & ~((2u << at) - 1u);
        const int end = later ? __ffs(later) - 1 : m;
#pragma unroll 4
        for (; at < end; ++at) {
          const int k_next = __shfl_sync(FULL, my_key, (at + 1) & 31);
          sk.arrival();
          tab.search(sk, k);
          sk.completion(sk.B, (hit >> at & 1u) != 0, false);
          k = k_next;
        }
      }
    } else {
      for (int at = 0; at < m; ++at) {
        const int k = __shfl_sync(FULL, my_key, at);
        const float t = __shfl_sync(FULL, my_t, at);
        const int h = __shfl_sync(FULL, my_hit, at);
        sk.tick(t);
        sk.arrival();
        if constexpr (!Table::kCountsMin) sketch::cm_add(sk.cm, sk.width, me, k);
        tab.search(sk, k);
        sk.completion(0, h > 0, false);
      }
    }
  }
  if (kBatch) store_branch();
  tab.store(sk);
  sk.finish(s, lane);
}

// the library's instantiations: every step
template <class Table>
int launch(const SketchArgs& s, const int* keys, const float* t_us,
           const int* hits, int lanes, int n, cudaStream_t stream) {
  sketch_trace_kernel<Table, true, true><<<lanes, 32, 0, stream>>>(s, keys, t_us, hits, n);
  return (int)cudaGetLastError();
}

template <int S>
int launch_slots(const SketchArgs& s, const int* keys, const float* t_us,
                 const int* hits, int lanes, int n, int packed, cudaStream_t stream) {
  return packed ? launch<sketch::RegTable<S, true>>(s, keys, t_us, hits, lanes, n, stream)
                : launch<sketch::RegTable<S, false>>(s, keys, t_us, hits, lanes, n, stream);
}

}  // namespace

// One warp per stream on `stream`: the (lanes, n) keys, float32 times (us)
// and hits update the lanes' SketchState in place (the caller's
// sketch_init).  `slots` is S (0: the table in device memory, unpacked
// only), `packed` the one-reduction form (the caller keeps n under
// 2^PACK_COUNT_BITS); the host's sketch_trace_form chooses both.  Returns
// the cudaError_t (cudaErrorInvalidValue for a form there is no
// instantiation of).
extern "C" int sketch_trace_launch(const SketchArgs* s, const int* keys,
                                   const float* t_us, const int* hits, int lanes,
                                   int n, int slots, int packed, void* stream) {
  if (lanes == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (slots > 0 && s->cap > 32 * slots) return (int)cudaErrorInvalidValue;
  if (packed && (slots == 0 || n >= (1 << sketch::PACK_COUNT_BITS)))
    return (int)cudaErrorInvalidValue;
  switch (slots) {
    case 0: return launch<GlobalTable>(*s, keys, t_us, hits, lanes, n, st);
    case 1: return launch_slots<1>(*s, keys, t_us, hits, lanes, n, packed, st);
    case 2: return launch_slots<2>(*s, keys, t_us, hits, lanes, n, packed, st);
    case 4: return launch_slots<4>(*s, keys, t_us, hits, lanes, n, packed, st);
    case 8: return launch_slots<8>(*s, keys, t_us, hits, lanes, n, packed, st);
    case 16: return launch_slots<16>(*s, keys, t_us, hits, lanes, n, packed, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
