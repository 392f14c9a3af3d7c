// sketch_trace: the streaming estimators over replayed key streams, one
// warp per stream.
//
// Replaces src/repro/obs/streaming.py::_sketch_trace, a jitted lax.scan
// (the reference has no Pallas kernel for it).  Per event, in the
// reference's order: tick, arrival, key, completion (branch 0, a hit as
// the stream says, never delayed).  The sketch's device code is
// sketch.cuh's, which the event-sim kernel's sketched instantiations run
// too; repro_torch/kernels/sketch.py holds the plain version
// (sketch_trace_plain), event for event.
//
// What bounds it: the serial dependence between a stream's events (each
// SpaceSaving search reads the table the last event wrote), not bytes
// or operations.  The stream's keys, times and hits are read 32 events
// at a time, one per thread, and reach the warp by __shfl_sync.

#include "sketch.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
    sketch_trace_kernel(const SketchArgs s, const int* keys, const float* t_us,
                        const int* hits, int n) {
  const int lane = blockIdx.x;
  const int me = threadIdx.x;
  sketch::Lane sk;
  sk.init(s, lane, me);
  const size_t row = static_cast<size_t>(lane) * n;
  int my_key = 0, my_hit = 0;
  float my_t = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int at = i & 31;
    if (at == 0) {
      const int e = i + me;
      if (e < n) {
        my_key = keys[row + e];
        my_t = t_us[row + e];
        my_hit = hits[row + e];
      }
    }
    const int k = __shfl_sync(FULL, my_key, at);
    const float t = __shfl_sync(FULL, my_t, at);
    const int h = __shfl_sync(FULL, my_hit, at);
    sk.tick(t);
    sk.arrival();
    sk.observe(k);
    sk.completion(0, h > 0, false);
  }
  sk.finish(s, lane);
}

}  // namespace

// One warp per stream on `stream`: the (lanes, n) keys, float32 times (us)
// and hits update the lanes' SketchState in place (the caller's
// sketch_init); returns the cudaError_t.
extern "C" int sketch_trace_launch(const SketchArgs* s, const int* keys,
                                   const float* t_us, const int* hits, int lanes,
                                   int n, void* stream) {
  if (lanes == 0) return 0;
  sketch_trace_kernel<<<lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      *s, keys, t_us, hits, n);
  return (int)cudaGetLastError();
}
