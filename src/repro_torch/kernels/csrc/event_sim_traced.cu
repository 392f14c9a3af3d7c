// The traced event-sim kernel in the coalescing, open-loop and tiered
// modes: the instantiations of event_sim.cuh's sim_kernel with kTrace = 2
// and kMode kFlows, kOpen or kTiers, at every register-slot count, without
// the streaming sketch (event_sim_traced_sketch.cu holds them with it).
//
// Replaces the trace_cap threading of the reference's threefry engines
// (src/repro/core/simulator.py _simulate with n_flows: the woken jobs'
// records at :273-290, j's at :338-349; _simulate_tiered: :631-640,
// :695-700; _simulate_open: an admitted request's stamp at :1008-1015, the
// woken jobs' records at :1051-1062, j's at :1116-1125), none of them a
// Pallas kernel.  repro_torch/kernels/event_sim.py holds the plain
// versions (sim_lanes_plain and sim_open_lanes_plain with trace_cap).
//
// The design is the traced closed kernel's (event_sim.cu): per-job enter
// and leave stamps in shared memory, stamp slot v of every job thread
// v % 32's; j's record and stamps held in registers and stored at the top
// of the next event.  What coalescing adds:
//   * a fill wakes up to mpl jobs, and each completes as a delayed hit
//     before j, at req = completed + its rank among the woken in job
//     order.  Job i is slot i / 32 of thread i % 32, so the rank is taken
//     one slot round at a time: a __ballot_sync of the round's woken jobs,
//     its set bits in turn, a running count across rounds;
//   * each woken record is written by the whole warp in the event itself
//     (nothing on the chain waits for a global store): thread u % 32
//     copies stamp slot u of the job's row to the ring, stamping its park
//     visit left now, thread 0 the record's other fields, with the parked
//     time shuffled from the thread that owns the park visit's slot.  These
//     are the threads that store those words of j's deferred record, so
//     when more records than the ring holds land on one row, the last is
//     stored last;
//   * the ring row is completed % cap (the woken move it by more than one);
//   * the open loop: an admitted arrival stamps its slot's visit 0 (thread
//     0), an arrival or a toggle stores no record and no stamp, and a
//     completing job leaves its slot without entering a visit.
// Every route length takes kTrace = 2, whose loops over stamp slots past
// the warp run no iteration on routes of 32 visits or fewer.  Tracing
// draws no random numbers and writes nothing the simulation reads, so
// every other output is the untraced instantiation's bit for bit.  A
// source of its own, so that nvcc compiles it beside the others.

#include "event_sim.cuh"

int traced_launch(const ExtArgs& p, void* stream) {
  return launch_traced_mode(p, ext_of(p), tiers_of<TierExt>(p), stream);
}
