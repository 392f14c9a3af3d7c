// Event-sim kernel: one lane of the closed network per warp.
//
// Replaces the TPU kernels src/repro/kernels/event_sim.py::_sim_kernel and,
// as the kTrace > 0 instantiations, ::_sim_kernel_traced (both launched
// by _pallas_grid, entry simulate_grid_pallas).  Each lane runs the
// closed-loop event simulation of `mpl` jobs: per event it draws three
// murmur3 counter uniforms, takes the argmin of the job ready times,
// hands a c-server FIFO station to its successor by enqueue sequence,
// advances the route (resampling the branch when a request completes)
// and takes the warmup snapshot.  repro_torch/kernels/event_sim.py holds
// the plain version (sim_lanes_plain), event for event.
//
// What bounds it on an H100: neither bytes nor operations, but the serial
// dependence between consecutive events of a lane: each event's argmin
// reads the ready times the previous event wrote.  So the design shortens
// that chain and keeps everything else off it:
//   * the lane's spec tables are staged in shared memory once, before the
//     loop; no global read remains inside it;
//   * job i = me + 32 r lives in slot r of thread me, in registers
//     (R = 1, 2, 4, 8 slots: mpl <= 256); only the owner updates a job,
//     and the warp learns job j's place by one __shfl_sync from its owner,
//     so no job state crosses threads through memory and needs no fence.
//     Larger mpl keeps the same layout in shared memory (R = 0), each
//     thread still touching only its own jobs;
//   * the argmins are __reduce_min_sync (redux.sync): the value, then the
//     lowest index among the threads holding it;
//   * ready times are absolute, modulo 2**32 (clock + service); a job's
//     remaining time is ready - clock, exact because it never exceeds one
//     service (< 2**31), so no pass rewrites the ready times;
//   * a queue station's busy servers are not stored: they are the jobs in
//     service there, counted by one __reduce_add_sync;
//   * an event's uniforms, its service draw at every station and its
//     branch draw depend on the event counter only.  So every 32 events
//     the warp draws the next 32 at once, one event per thread: the
//     stations are visited in the same order by every thread, so only
//     the laws present are computed (a warp-uniform branch), and the
//     draws go to a shared table that the chain reads by (event,
//     station); the branch draws stay in the drawing thread's registers
//     and reach the chain by __shfl_sync.  One __syncwarp() on each side
//     of a batch orders the table.
// One block of one warp per lane; lanes run in parallel across SMs, and a
// grid may hold networks of different shapes (padded by stack_specs, with
// a per-lane event budget).
//
// Tracing (kTrace 1; kTrace 2 for routes over 32 visits, whose extra stamp
// slots cost the common case time even as a branch never taken): the
// per-job enter/leave stamps of the current request (mpl x L floats each)
// sit in shared memory; stamp slot v of every job is read and written only
// by thread v % 32, so it needs no fence either.  A completed request's
// record goes to the lane's ring in global memory at row req % cap.  The
// record and the stamps are held in registers and stored at the top of
// the next event, where nothing they need is still in flight (stored at
// once, they stalled the chain: 1.33x the untraced time); each field of a
// record has one writing thread, the others store to the ring's scrap row,
// where the reference parks its masked writes (decode drops it).  Tracing
// draws no random numbers, so all instantiations simulate the same
// events; the untraced one compiles no trace code.
//
// Coalescing and the open loop (kMode kFlows and kOpen): the reference
// runs them only on its threefry engine (src/repro/core/simulator.py
// _simulate with n_flows, _simulate_open), which has no Pallas kernel;
// these instantiations are the port's counterpart on this kernel's
// engine, event for event those of sim_lanes_plain(n_flows=...) and
// sim_open_lanes_plain.  They keep the design above and add:
//   * a second keyed stream (base2 = mix(seed + 2 GOLDEN)) whose counter
//     is a pure function of the event and the job: event e owns
//     (e + 1)(2n + 4) + {2i, 2i + 1: job i's wake branch and service;
//     2n: a miss's flow; 2n + 1: the next interarrival; 2n + 2, 2n + 3: a
//     toggle's interarrival and phase}.  So the owner of a woken job draws
//     for it with no shared table, and the three draws of the first
//     stream keep their counters;
//   * a parked job has station PARKED and no enqueue sequence: it is
//     neither in service (the argmin and the busy count skip it) nor a
//     waiter, and holds no server.  A fill wakes the jobs whose flow is
//     the filled one: each owner scans its own slots, one reduction
//     counts them; per-branch counts go to shared memory by atomics;
//   * the leader table (n_disks * F entries) sits in shared memory.  All
//     threads read it (a broadcast) before thread 0 writes it, once per
//     event, and a __syncwarp() orders the writes before the next read;
//     the read of an entry the same event clears is answered by logic;
//   * the open loop's slots are the job slots: the lowest free one is a
//     ballot per register slot and __ffs; each owner ages its own live
//     slots by the event's time; sojourns and classes go to device memory
//     at the completion index, the woken jobs' in job order (a ballot
//     prefix).  Arrivals win ties against departures and toggles, toggles
//     against departures, as in the reference.
//
// Per-branch counts in the closed loop (kMode kCount): the reference's
// threefry engine counts every closed run's completions per branch (the
// cluster prong reads them per shard); the closed kernel does not, so
// that its instantiations keep their code.  kCount is the closed loop
// with those counts and nothing of coalescing: the owner of a completing
// job adds one to its branch's count in shared memory by an atomic, and
// the warmup snapshot copies the counts as kFlows does.  Its events are
// the closed kernel's, draw for draw.
//
// Tiered MSHR tables (kMode kTiers): the reference runs its hierarchy's
// cross-tier coalescing only on its threefry engine (src/repro/core/
// simulator.py _simulate_tiered); this instantiation is the port's
// counterpart, event for event sim_lanes_plain(tiers=...).  Acquire and
// release points come from three (B, Lr) tables, staged in shared memory
// as int8, in place of the disk ranks; the leader table holds n_groups * F
// entries.  Each job keeps, in its owner's registers, its request's flow
// (drawn at its first acquire, from the second stream's flow counter),
// its held entry per level (kMaxHeld levels, a compile-time bound) and
// the entry and level it is parked on.  When j completes a visit that
// releases a level it holds, the fill cascades in at most max_held waves
// over a bitmap of freed entries in shared memory (n_groups * F + 1 bits):
// each owner marks its parked jobs whose entry is in the bitmap (one
// reduction counts them), the bitmap is cleared, and the marked jobs'
// held entries are set in it (shared atomics) and their leaders cleared;
// a __syncwarp() orders each write before the next read.  So an entry the
// cascade frees reads free at j's placement in the same event.  The woken
// jobs keep their marks until the FIFO successor and the busy count are
// taken from the state before the cascade, as the reference takes them;
// then they complete as delayed hits (per-branch and per-level counts by
// shared atomics) and start fresh requests from the second stream.
//
// The streaming sketch (sketch_cap > 0): the kernel template lives in
// event_sim.cuh; this source instantiates it without the sketch, and
// event_sim_sketch.cu with it (parameters Sketched<Ext, L>,
// Sketched<TierExt, L>: L the sketch's device code, sketch.cuh's Lane in
// place or SimLane, which logs each event and replays every 32), so nvcc
// builds the two sets in parallel and these instantiations keep their
// parameters and their code.
//
// Where bit-exactness with the JAX reference could break:
//   * argmin ties: jnp.argmin returns the FIRST index.  Each thread keeps
//     its lowest index among equal remaining times, and the second
//     reduction takes the lowest of those.  A job's remaining time is the
//     reference's relative ready time exactly, so t, j and every later
//     integer are the reference's.
//   * index semantics: count_below may return B when u > branch_cum[B-1]
//     (float32 rounding of the cumulative law); JAX clamps the gather
//     visits[B, .] to row B-1, and so does every visits read below.
//   * RNG: mix is native uint32 arithmetic with wraparound, as in JAX.
//   * float32 rounding: u01 uses the float32 constants of the reference
//     (2^-24 and the clip to [float32(1e-7), float32(1 - 1e-7)]);
//     jnp.round is round-half-to-even, which is rintf here, not roundf;
//     the clock update elapsed_us + t * 1e-3 is one fused multiply-add
//     (__fmaf_rn), as XLA's CPU backend compiles the reference's, and
//     -fmad=false keeps every other multiply and add unfused.  The
//     Pareto constants 1 - (lo/hi)^alpha and -1/alpha are folded per
//     station with the same float32 operations.  logf/powf may differ
//     from XLA's float32 log/pow in the last ulp, so exponential and
//     Pareto service draws are held statistically against the reference;
//     deterministic service is exact.

#include "event_sim.cuh"

// Register slots per thread of the instantiation that runs mpl jobs (0:
// job state in shared memory).
extern "C" int event_sim_slots(int mpl) { return reg_slots(mpl); }

// Shared memory of one block of the launch *p describes (sketched: with
// the sketch).
extern "C" int event_sim_ext_shared_bytes(const ExtArgs* p, int sketched) {
  return ext_shared_bytes(*p, sketched != 0);
}

// Every launch: the closed loop (closed), the coalescing (open == 0,
// n_flows > 0), open-loop (open == 1), tiered (tiers == 1, n_flows > 0,
// max_held <= kMaxHeld) or counting (open == 0, n_flows == 0) loop, one
// warp per lane on `stream`, traced when cap > 0 (every mode but the
// counting one), into the rings the caller allocates with req = -1; with
// the sketch *s when s is not null (its instantiations are
// event_sim_sketch.cu's; traced, those of the closed loop too, and
// event_sim_traced.cu's and event_sim_traced_sketch.cu's the other traced
// ones).  Returns the cudaError_t.
extern "C" int event_sim_ext_launch(const ExtArgs* p, const SketchArgs* s,
                                    void* stream) {
  if (p->cap > 0 && ext_mode(*p) != kClosed) {
    return s != nullptr ? traced_sketched_launch(*p, *s, stream)
                        : traced_launch(*p, stream);
  }
  if (s != nullptr) return sketched_launch(*p, *s, stream);
  return launch_mode(*p, ext_of(*p), tiers_of<TierExt>(*p), stream);
}
