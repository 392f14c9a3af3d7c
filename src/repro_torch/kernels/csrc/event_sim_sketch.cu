// The event-sim kernel with the streaming sketch: the instantiations of
// event_sim.cuh's sim_kernel whose parameters are Sketched<Ext, L> (or
// Sketched<TierExt, L>), for the closed loop (untraced and traced), the
// counting, coalescing, open-loop and tiered modes, at every register-
// slot count.
//
// Replaces the sketch_cap threading of the reference's threefry engines
// (src/repro/core/simulator.py _simulate, _simulate_tiered,
// _simulate_open, none of them a Pallas kernel) and, for the traced
// closed loop, src/repro/kernels/event_sim.py::_sim_kernel_traced with the
// sketch beside it.  The sketch's device code is sketch.cuh's (one warp
// per lane; see there), at the reference's sites and in its order: every
// event ticks the ring at the new clock; an open-loop arrival is counted,
// dropped or not; the jobs a fill (or a tiered cascade) wakes complete as
// one batch of delayed hits under the branch they parked on; j's
// completion is a hit unless its branch is a miss route; a miss at a disk
// observes its flow as a key (kTiers: a request's flow, once, at its
// first acquire).  The sketch draws no random numbers and writes no state
// the simulation reads, so every simulation output is the unsketched
// instantiation's bit for bit.  repro_torch/kernels/event_sim.py holds
// the plain versions (sim_lanes_plain and sim_open_lanes_plain with
// sketch=).
//
// What bounds these instantiations is the unsketched kernel's serial
// chain (event_sim.cu's header) plus whatever the sketch makes the warp
// issue or wait for between two events.  Where counts live and what the
// design does about it: the current window's counters, the EWMAs and the
// key count in registers of every thread; the ring's rows, the count-min
// rows and the SpaceSaving table in device memory.  In the coalescing,
// open-loop and tiered modes (LoggedLane, sketch.cuh SimLane) an event
// only logs its record in registers (its time, its arrival, the jobs it
// woke, its key, j's completion as one shuffled word) and its woken jobs'
// branches in shared memory; every 32 events, outside the event loop, the
// sketch replays them in order, with the window's per-branch completions
// in registers, a block of 32 keys' count-min adds at once, and no atomic
// add per event.  The closed, counting and traced closed modes keep the
// sketch in place (InPlaceLane, sketch.cuh Lane: a RED to the branch row
// per completion), since a log costs their short loops more than it
// saves (tools/event_sim_sketch_ablation.py times each step).
//
// A source of its own, so that nvcc compiles these instantiations beside
// event_sim.cu's, in parallel; the instantiations without the sketch are
// untouched (their parameter types are not Sketched<...>).

#include "event_sim.cuh"

// event_sim_ext_launch with the sketch s: the mode's launch on its
// sketched parameter types.
int sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream) {
  if (!observes(ext_mode(p))) return launch_closed(p, sketched_ext<InPlaceLane>(p, s), stream);
  return launch_observing(p, sketched_ext<LoggedLane>(p, s),
                          sketched_tiers<LoggedLane>(p, s), stream);
}
