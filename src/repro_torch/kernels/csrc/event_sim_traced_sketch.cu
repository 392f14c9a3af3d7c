// The traced coalescing, open-loop and tiered instantiations of the
// event-sim kernel (event_sim_traced.cu) with the streaming sketch: their
// parameters Sketched<Ext, LoggedLane> and Sketched<TierExt, LoggedLane>,
// the sketch at the sites of event_sim_sketch.cu, logged and replayed as
// there.  Replaces the reference's threefry engines run with trace_cap and
// sketch_cap together (src/repro/core/simulator.py _simulate,
// _simulate_tiered, _simulate_open).  The sketch and the rings read one
// miss-class table.  A source of its own, so that nvcc compiles it beside
// the others.

#include "event_sim.cuh"

int traced_sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream) {
  return launch_traced_mode(p, sketched_ext<LoggedLane>(p, s),
                            sketched_tiers<LoggedLane>(p, s), stream);
}
