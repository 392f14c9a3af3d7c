// The traced coalescing, open-loop and tiered instantiations of the
// event-sim kernel (event_sim_traced.cu) with the streaming sketch: their
// parameters Sketched<Ext> and Sketched<TierExt>, the sketch at the sites
// of event_sim_sketch.cu.  Replaces the reference's threefry engines run
// with trace_cap and sketch_cap together (src/repro/core/simulator.py
// _simulate, _simulate_tiered, _simulate_open).  The sketch and the rings
// read one miss-class table.  A source of its own, so that nvcc compiles
// it beside the others.

#include "event_sim.cuh"

int traced_sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream) {
  Sketched<Ext> ex;
  static_cast<Ext&>(ex) = ext_of(p);
  ex.sk = s;
  auto tx = tiers_of<Sketched<TierExt>>(p);
  tx.sk = s;
  return launch_traced_mode(p, ex, tx, stream);
}
