// The event-sim kernel with the streaming sketch: the instantiations of
// event_sim.cuh's sim_kernel whose parameters are Sketched<Ext> (or
// Sketched<TierExt>), for the closed loop (untraced and traced), the
// counting, coalescing, open-loop and tiered modes, at every register-
// slot count.
//
// Replaces the sketch_cap threading of the reference's threefry engines
// (src/repro/core/simulator.py _simulate, _simulate_tiered,
// _simulate_open, none of them a Pallas kernel) and, for the traced
// closed loop, src/repro/kernels/event_sim.py::_sim_kernel_traced with the
// sketch beside it.  The sketch's device code is sketch.cuh's (one warp
// per lane; see there), called at the reference's sites, in its order:
// every event ticks the ring at the new clock; an open-loop arrival is
// counted, dropped or not; the jobs a fill (or a tiered cascade) wakes
// complete as one batch of delayed hits under the branch they parked on;
// j's completion is a hit unless its branch is a miss route; a miss at a
// disk observes its flow as a key (kTiers: a request's flow, once, at its
// first acquire).  The sketch draws no random numbers and writes no state
// the simulation reads, so every simulation output is the unsketched
// instantiation's bit for bit.  repro_torch/kernels/event_sim.py holds the
// plain versions (sim_lanes_plain and sim_open_lanes_plain with sketch=).
//
// A source of its own, so that nvcc compiles these instantiations beside
// event_sim.cu's, in parallel; the instantiations without the sketch are
// untouched (their parameter types are not Sketched<...>).

#include "event_sim.cuh"

// event_sim_ext_launch with the sketch s: launch_mode on the sketched
// parameter types.
int sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream) {
  Sketched<Ext> ex;
  static_cast<Ext&>(ex) = ext_of(p);
  ex.sk = s;
  auto tx = tiers_of<Sketched<TierExt>>(p);
  tx.sk = s;
  return launch_mode(p, ex, tx, stream);
}
