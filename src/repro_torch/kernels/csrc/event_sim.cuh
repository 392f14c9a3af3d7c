// The event-sim kernel template and its launch helpers, shared by
// event_sim.cu (the instantiations without the streaming sketch),
// event_sim_sketch.cu (those with it), event_sim_traced.cu and
// event_sim_traced_sketch.cu (the traced coalescing, open-loop and tiered
// instantiations, without and with it): four sources, so that nvcc builds
// them in parallel.  The design is event_sim.cu's header comment.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "sketch.cuh"

namespace {

constexpr int BIG_SEQ = INT_MAX;       // enq of a job in service
constexpr int NO_JOB = -1;             // station and enq of an unused slot
constexpr uint32_t NEVER = 0xffffffffu;  // remaining time of a waiting job
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int CLS_MISS = 0;
constexpr int CLS_HIT = 1;
constexpr int CLS_DELAYED = 2;
constexpr int PARKED = -2;               // station of a job parked on a fetch
constexpr uint32_t INF_REL = 0x7fffffffu;  // INF_NS: a time that never comes
// kernel modes: the closed loop, the closed loop with coalescing, the
// open loop (coalescing and bursts as runtime switches), the closed loop
// with per-branch counts
constexpr int kClosed = 0;
constexpr int kFlows = 1;
constexpr int kOpen = 2;
constexpr int kCount = 3;
constexpr int kTiers = 4;
// kTiers: held entries per job, and the marks of a job the cascade wakes
// (this wave; an earlier wave)
constexpr int kMaxHeld = 2;
constexpr int WAKING = -3;
constexpr int WOKEN = -4;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float u01(uint32_t base, uint32_t ctr) {
  const uint32_t z = mix(base + ctr * GOLDEN);
  const float u = static_cast<float>(z >> 8) * static_cast<float>(1.0 / (1 << 24));
  return fminf(fmaxf(u, static_cast<float>(1e-7)), static_cast<float>(1.0 - 1e-7));
}

// A station's service law, with the Pareto constants folded.
struct Law {
  float mean, lo, ratio, neg_inv, raw;
  int dist;  // 0 det, 1 exp, 2 bounded pareto
};

__device__ Law make_law(const float* svc, const int* did, const float* dpar,
                        int k) {
  const float alpha = dpar[4 * k], lo = dpar[4 * k + 1], hi = dpar[4 * k + 2];
  Law w;
  w.mean = svc[k];
  w.dist = did[k];
  w.lo = lo;
  w.raw = dpar[4 * k + 3];
  w.ratio = 1.0f - powf(lo / hi, alpha);
  w.neg_inv = -1.0f / alpha;
  return w;
}

// _service_ns: ns, int >= 1, from the uniform u.
__device__ __forceinline__ int service_ns(float u, const Law& w) {
  float unit = 0.0f;  // jnp.select's default
  if (w.dist == 0) {
    unit = 1.0f;
  } else if (w.dist == 1) {
    unit = -logf(u);
  } else if (w.dist == 2) {
    unit = w.lo * powf(1.0f - u * w.ratio, w.neg_inv) / w.raw;
  }
  return static_cast<int>(fmaxf(rintf(unit * w.mean), 1.0f));
}

// An exponential time in ns (>= 1) of mean `mean` (the reference's exp_ns).
__device__ __forceinline__ int exp_ns(float u, float mean) {
  return static_cast<int>(fmaxf(rintf(-logf(u) * mean), 1.0f));
}

// The flow a miss fetches: floor(u F) for uniform flows (cdf null), else
// searchsorted-left over the CDF; at most F - 1.
__device__ __forceinline__ int flow_of(float u, int n_flows, const float* cdf) {
  int f;
  if (cdf == nullptr) {
    f = static_cast<int>(u * static_cast<float>(n_flows));
  } else {
    int lo = 0, hi = n_flows;  // the first f with cdf[f] >= u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] < u) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    f = lo;
  }
  return min(f, n_flows - 1);
}

// searchsorted-left over the cumulative branch law (may return n_b).
__device__ int count_below(const float* cum, int n_b, float u) {
  int n = 0;
  for (int b = 0; b < n_b; ++b) n += cum[b] < u ? 1 : 0;
  return n;
}

// Inputs and outputs; spec arrays are (lanes, ...) as _LaneSpec.
struct Args {
  const int* isq;        // (K) is_queue
  const float* svc;      // (K) mean service, ns
  const int* did;        // (K)
  const float* dpar;     // (K, 4) alpha, lo, hi, raw_mean
  const float* bcum;     // (B) cumulative branch law
  const int* visits;     // (B, Lr) station ids, -1 padded
  const int* servers;    // (K)
  const int* seeds;      // lane seeds
  const int* max_events; // lane event budgets
  float* x;
  int* completed;
  int* events;
  float* tmeas;
  int n_k, n_b, n_l, mpl, n_requests, warmup;
};

// The traced kernel's extra input and outputs; rows are (lanes, cap + 1)
// and stamp rows (lanes, cap + 1, L), as TraceRings in repro_torch.
struct Rings {
  const int* bmiss;  // (lanes, B) 1 if the branch's route touches a disk
  int* n_count;      // (lanes) records emitted
  int* req;
  int* branch;
  int* cls;
  int* nvis;
  float* parked;
  float* enter;
  float* leave;
  int cap;
};

// The coalescing and open-loop instantiations' extra inputs and outputs.
struct Ext {
  const int* disk_rank;   // (lanes, K) backing-store rank, -1: not a disk
  const float* flow_cum;  // (F) Zipf flow CDF; null: uniform flows
  const int* bmiss;       // (lanes, B) open loop: 1 if the route has a disk
  const float* ia_mean;   // (lanes) open loop: mean interarrival, ns
  float* delayed_frac;    // (lanes)
  int* branch_done;       // (lanes, B) kFlows, kCount: measured completions
  int* branch_delayed;    // (lanes, B) kFlows, kCount: measured delayed hits
  int* dropped;           // (lanes) open: arrivals that found no slot
  float* soj;             // (lanes, rec_len) open: sojourn, us
  signed char* cls;       // (lanes, rec_len) open: class
  int n_flows, n_lead, burst, rec_len;
  float on_mean, off_mean;  // open with burst: ON and OFF phase means, ns
};

// kTiers' inputs and outputs beyond Ext's: its own parameter type, so that
// the other instantiations keep their parameters (and their code; a larger
// Ext changes their register allocation)
struct TierExt : Ext {
  const int* acq_group;   // (lanes, B, Lr) group acquired on arrival
  const int* acq_slot;    // (lanes, B, Lr) level it is held at
  const int* rel_slot;    // (lanes, B, Lr) level released on completion
  float* delayed_tier;    // (lanes, max_held) delayed hits per level
  int max_held;
};

// The sketched instantiations' parameters: the mode's own (Ext or
// TierExt) and the streaming sketch's, a type of its own, so that the
// instantiations without it keep their parameters and their code; L is
// the sketch's device code (sketch::Lane in place, or sketch::SimLane,
// which logs each event: LoggedLane, InPlaceLane, at the end).
template <class Base, class L>
struct Sketched : Base {
  SketchArgs sk;
  using SkLane = L;
};
template <class E>
struct is_sketched : std::false_type {};
template <class Base, class L>
struct is_sketched<Sketched<Base, L>> : std::true_type {};
struct NoSketch {
  static constexpr bool kLog = false;
};
template <class E, bool = is_sketched<E>::value>
struct lane_of {
  using type = NoSketch;
};
template <class E>
struct lane_of<E, true> {
  using type = typename E::SkLane;
};

// Register slots per thread for mpl jobs; 0: job state in shared memory.
__host__ __device__ constexpr int reg_slots(int mpl) {
  return mpl <= 32 ? 1 : mpl <= 64 ? 2 : mpl <= 128 ? 4 : mpl <= 256 ? 8 : 0;
}

// Events drawn at once, one per thread of the warp.
constexpr int kBatch = 32;
// The sketched instantiations' woken log: replayed once it holds more than
// kWlogFlush branches (an event adds at most mpl)
constexpr int kWlogFlush = 64;

// Byte offsets of a lane's shared memory: (K) queue info {is_queue,
// servers}, (K) laws, (kBatch events, 2 draws, K) service draws, (B, Lr)
// visits, (B) branch law; traced, (B) miss classes, the (mpl, Lr) enter
// and leave stamps and a word per thread for stores that go nowhere; with
// R = 0, six (mpl) job arrays.
// With coalescing or the open loop, also: (K) disk ranks, the leader
// table, the flow CDF and (kFlows) the per-branch counts and their warmup
// snapshots; the open loop keeps (B) miss classes; R = 0 job slots hold
// two more arrays (flow, age).  kCount keeps the per-branch counts only.
// kTiers keeps the leader table, the flow CDF, the per-branch counts, the
// per-level delayed counts and their snapshots, the freed-entry bitmap,
// R = 0 job slots with kMaxHeld + 2 more arrays (held entries, parked
// entry and level), and last the three (B, Lr) int8 tables.  A sketched
// instantiation keeps the (B) miss classes in every mode, and the woken
// log of its sketch (kWlogFlush + mpl + 1 branches).
struct Layout {
  int q, law, draw, vis, cum, miss, enter, leave, trash, rank, lead, fcum,
      bcnt, dlv, freed, wlog, jobs, tab, bytes;
};

__host__ __device__ inline Layout layout(int n_k, int n_b, int n_l, int mpl,
                                         bool trace, bool smem_jobs,
                                         int mode = kClosed, int n_lead = 0,
                                         int n_cdf = 0, bool sketch = false) {
  Layout s;
  int o = 0;
  s.q = o;
  o += 8 * n_k;
  s.law = o;
  o += static_cast<int>(sizeof(Law)) * n_k;
  s.draw = o;
  o += 4 * kBatch * 2 * n_k;
  s.vis = o;
  o += 4 * n_b * n_l;
  s.cum = o;
  o += 4 * n_b;
  s.miss = o;
  o += trace || mode == kOpen || sketch ? 4 * n_b : 0;
  s.enter = o;
  o += trace ? 4 * mpl * n_l : 0;
  s.leave = o;
  o += trace ? 4 * mpl * n_l : 0;
  s.trash = o;
  o += trace ? 4 * 32 : 0;
  const bool ext = mode == kFlows || mode == kOpen;
  const bool tiers = mode == kTiers;
  s.rank = o;
  o += ext ? 4 * n_k : 0;
  s.lead = o;
  o += ext || tiers ? 4 * n_lead : 0;
  s.fcum = o;
  o += ext || tiers ? 4 * n_cdf : 0;
  s.bcnt = o;
  o += mode == kFlows || mode == kCount || tiers ? 16 * n_b : 0;
  s.dlv = o;
  o += tiers ? 8 * kMaxHeld : 0;
  s.freed = o;
  o += tiers ? 4 * ((n_lead + 32) / 32) : 0;
  s.wlog = o;
  o += sketch ? 4 * (kWlogFlush + mpl + 1) : 0;
  s.jobs = o;
  o += smem_jobs ? (tiers ? 4 * (10 + kMaxHeld) : ext ? 32 : 24) * mpl : 0;
  s.tab = o;
  o += tiers ? 3 * n_b * n_l : 0;
  s.bytes = o;
  return s;
}

// The sketched kernel's log of events (kLog, sketch.cuh SimLane): event n
// of a log of 32 logs its record in registers of thread n (t its time, a
// its arrival bit and woken count, k its key, w j's completion word, which
// j's owner shuffles into `word` at the end of the event and which is
// logged at the top of the next), and the jobs' owners the woken jobs'
// branches in the shared-memory log wlog, wpos of them.  The unsketched
// instantiations hold none of it (NoLog).
struct EventLog {
  float t = 0.0f;
  int a = 0, k = 0, w = 0;
  int* wlog;
  int n = 0, word = -1, wpos = 0;

  // event n's record, by thread n
  __device__ __forceinline__ void event(int me, float te, int ae, int ke) {
    if (me == n) {
      t = te;
      a = ae;
      k = ke;
    }
    ++n;
  }
  // the last event's completion word to its record
  __device__ __forceinline__ void take_word(int me) {
    if (me == n - 1) w = word;
    word = -1;
  }
  __device__ __forceinline__ bool full() const { return n == 32; }

  // the branches of the n jobs an event wakes, in job order (a ballot per
  // slot round; is_woken(r): this thread's slot r holds one)
  template <class J, class F>
  __device__ __forceinline__ void woken(J& jobs, int me, int nw, F is_woken) {
    const unsigned lower = (1u << me) - 1u;
    int at = wpos;
#pragma unroll
    for (int r = 0; r < jobs.max_slots(); ++r) {
      const bool wk = r < jobs.slots() && is_woken(r);
      const unsigned m = __ballot_sync(FULL, wk);
      if (wk) wlog[at + __popc(m & lower)] = jobs.br(r);
      at += __popc(m);
    }
    wpos += nw;
  }
};
struct NoLog {};

// A logged event's own values: j's completion word (its owner's view) and
// the jobs the event wakes
struct SketchEvent {
  int o_word = 0, nw = 0;
};

// A thread's jobs: slot r holds job me + 32 r.  Fields: absolute ready
// time (mod 2**32), station, next station on the route (-1: the request
// completes there), branch, position, enqueue sequence (BIG_SEQ in
// service, NO_JOB for an unused slot).
// With coalescing, also the flow the job fetches or parks on (-1: none);
// in the open loop, the slot's time in system (us).
template <int R>
struct Jobs {
  uint32_t ready_[R];
  int st_[R], nx_[R], br_[R], pos_[R], enq_[R], fl_[R];
  float age_[R];
  __device__ __forceinline__ void bind(unsigned char*, int, int) {}
  __device__ __forceinline__ int slots() const { return R; }
  __device__ __forceinline__ int max_slots() const { return R; }
  __device__ __forceinline__ int& fl(int r) { return fl_[r]; }
  __device__ __forceinline__ float& age(int r) { return age_[r]; }
  __device__ __forceinline__ uint32_t& ready(int r) { return ready_[r]; }
  __device__ __forceinline__ int& st(int r) { return st_[r]; }
  __device__ __forceinline__ int& nx(int r) { return nx_[r]; }
  __device__ __forceinline__ int& br(int r) { return br_[r]; }
  __device__ __forceinline__ int& pos(int r) { return pos_[r]; }
  __device__ __forceinline__ int& enq(int r) { return enq_[r]; }
  // f(rj) on slot rj (none for rj < 0), through constant indices: the
  // slots stay registers
  template <class F>
  __device__ __forceinline__ void at(int rj, F f) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == rj) f(r);
  }
};

// mpl > 256: the same slots in shared memory, arrays indexed by job.
template <>
struct Jobs<0> {
  uint32_t* ready_;
  int *st_, *nx_, *br_, *pos_, *enq_, *fl_;
  float* age_;
  int n_, max_;
  // fl_ and age_ lie past the closed loop's six arrays: only the modes
  // that allocate them (layout) touch them
  __device__ void bind(unsigned char* p, int mpl, int me) {
    int* a = reinterpret_cast<int*>(p) + me;
    ready_ = reinterpret_cast<uint32_t*>(a);
    st_ = a + mpl;
    nx_ = a + 2 * mpl;
    br_ = a + 3 * mpl;
    pos_ = a + 4 * mpl;
    enq_ = a + 5 * mpl;
    fl_ = a + 6 * mpl;
    age_ = reinterpret_cast<float*>(a + 7 * mpl);
    n_ = me < mpl ? (mpl - 1 - me) / 32 + 1 : 0;
    max_ = (mpl + 31) / 32;
  }
  __device__ __forceinline__ int slots() const { return n_; }
  __device__ __forceinline__ int max_slots() const { return max_; }
  __device__ __forceinline__ int& fl(int r) { return fl_[32 * r]; }
  __device__ __forceinline__ float& age(int r) { return age_[32 * r]; }
  __device__ __forceinline__ uint32_t& ready(int r) { return ready_[32 * r]; }
  __device__ __forceinline__ int& st(int r) { return st_[32 * r]; }
  __device__ __forceinline__ int& nx(int r) { return nx_[32 * r]; }
  __device__ __forceinline__ int& br(int r) { return br_[32 * r]; }
  __device__ __forceinline__ int& pos(int r) { return pos_[32 * r]; }
  __device__ __forceinline__ int& enq(int r) { return enq_[32 * r]; }
  template <class F>
  __device__ __forceinline__ void at(int rj, F f) {
    if (rj >= 0 && rj < n_) f(rj);
  }
};

// kTiers: the job slots with, per job, the entry held at each level and
// the entry and level it is parked on (-1: none); the other modes keep
// Jobs<R> as it is.
template <int R>
struct TierJobs : Jobs<R> {
  int hd_[kMaxHeld][R], po_[R], pl_[R];
  __device__ __forceinline__ int& hd(int r, int l) { return hd_[l][r]; }
  __device__ __forceinline__ int& po(int r) { return po_[r]; }
  __device__ __forceinline__ int& pl(int r) { return pl_[r]; }
};

// mpl > 256: those arrays in shared memory too, past the eight of Jobs<0>.
template <>
struct TierJobs<0> : Jobs<0> {
  int *hd_, *po_, *pl_;
  int mpl_;
  __device__ void bind(unsigned char* p, int mpl, int me) {
    Jobs<0>::bind(p, mpl, me);
    int* a = reinterpret_cast<int*>(p) + me;
    hd_ = a + 8 * mpl;
    po_ = a + (8 + kMaxHeld) * mpl;
    pl_ = a + (9 + kMaxHeld) * mpl;
    mpl_ = mpl;
  }
  __device__ __forceinline__ int& hd(int r, int l) { return hd_[l * mpl_ + 32 * r]; }
  __device__ __forceinline__ int& po(int r) { return po_[32 * r]; }
  __device__ __forceinline__ int& pl(int r) { return pl_[32 * r]; }
};

// One warp a block; the logged sketched instantiations at least one block
// a multiprocessor too, so that ptxas may give the sketch's replay
// registers (up to 255) rather than spill the simulation's around it (0:
// no bound)
template <class E>
constexpr int kMinBlocks = lane_of<E>::type::kLog ? 1 : 0;

template <int kTrace, int R, int kMode, class E = Ext>
__global__ void __launch_bounds__(32, kMinBlocks<E>)
    sim_kernel(const Args a, const Rings rings, const E ex) {
  constexpr bool kExt = kMode == kFlows || kMode == kOpen;  // coalescing state
  constexpr bool kOp = kMode == kOpen;
  constexpr bool kTi = kMode == kTiers;  // tiered tables
  constexpr bool kCnt = kMode == kFlows || kMode == kCount || kTi;  // per-branch counts
  constexpr bool kSk = is_sketched<E>::value;  // the streaming sketch
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane_id = blockIdx.x;
  const int me = threadIdx.x;
  const int n_k = a.n_k, n_b = a.n_b, n_l = a.n_l, mpl = a.mpl;
  const bool zipf = (kExt || kTi) && ex.flow_cum != nullptr;
  const Layout lay = layout(n_k, n_b, n_l, mpl, kTrace > 0, R == 0, kMode,
                            ex.n_lead, zipf ? ex.n_flows : 0, kSk);
  int2* q = reinterpret_cast<int2*>(smem + lay.q);
  Law* law = reinterpret_cast<Law*>(smem + lay.law);
  int* draw = reinterpret_cast<int*>(smem + lay.draw);
  int* vis = reinterpret_cast<int*>(smem + lay.vis);
  float* cum = reinterpret_cast<float*>(smem + lay.cum);
  int* miss = reinterpret_cast<int*>(smem + lay.miss);
  float* enter_s = reinterpret_cast<float*>(smem + lay.enter);
  float* leave_s = reinterpret_cast<float*>(smem + lay.leave);
  float* trash = reinterpret_cast<float*>(smem + lay.trash);
  int* rank = reinterpret_cast<int*>(smem + lay.rank);
  int* lead = reinterpret_cast<int*>(smem + lay.lead);
  float* fcum = reinterpret_cast<float*>(smem + lay.fcum);
  int* bcnt = reinterpret_cast<int*>(smem + lay.bcnt);  // done, delayed, warm x2
  int* dlv = reinterpret_cast<int*>(smem + lay.dlv);    // per level, warm
  unsigned* freed = reinterpret_cast<unsigned*>(smem + lay.freed);
  signed char* tab = reinterpret_cast<signed char*>(smem + lay.tab);  // ag, as, rel

  // stage the lane's spec
  {
    const int ok = lane_id * n_k;
    for (int k = me; k < n_k; k += 32) {
      q[k] = make_int2(a.isq[ok + k], a.servers[ok + k]);
      law[k] = make_law(a.svc + ok, a.did + ok, a.dpar + 4 * ok, k);
    }
    for (int i = me; i < n_b * n_l; i += 32) vis[i] = a.visits[lane_id * n_b * n_l + i];
    for (int b = me; b < n_b; b += 32) {
      cum[b] = a.bcum[lane_id * n_b + b];
      if constexpr (kTrace > 0) miss[b] = rings.bmiss[lane_id * n_b + b];
      if constexpr (kOp) miss[b] = ex.bmiss[lane_id * n_b + b];
      if constexpr (kSk && kTrace == 0 && !kOp) miss[b] = ex.sk.bmiss[lane_id * n_b + b];
    }
    if constexpr (kTrace > 0) {
      for (int i = me; i < 2 * mpl * n_l; i += 32) enter_s[i] = 0.0f;
    }
    if constexpr (kExt) {
      for (int k = me; k < n_k; k += 32) rank[k] = ex.n_flows > 0 ? ex.disk_rank[ok + k] : -1;
      for (int i = me; i < ex.n_lead; i += 32) lead[i] = -1;
      if (zipf) {
        for (int f = me; f < ex.n_flows; f += 32) fcum[f] = ex.flow_cum[f];
      }
    }
    if constexpr (kCnt) {
      for (int i = me; i < 4 * n_b; i += 32) bcnt[i] = 0;
    }
    if constexpr (kTi) {
      for (int i = me; i < ex.n_lead; i += 32) lead[i] = -1;
      if (zipf) {
        for (int f = me; f < ex.n_flows; f += 32) fcum[f] = ex.flow_cum[f];
      }
      for (int i = me; i < 2 * kMaxHeld; i += 32) dlv[i] = 0;
      const int nt = n_b * n_l, ot = lane_id * nt;
      for (int i = me; i < nt; i += 32) {
        tab[i] = static_cast<signed char>(ex.acq_group[ot + i]);
        tab[nt + i] = static_cast<signed char>(ex.acq_slot[ot + i]);
        tab[2 * nt + i] = static_cast<signed char>(ex.rel_slot[ot + i]);
      }
    }
  }
  __syncwarp();

  // visits[b, p] with JAX's clamped gather on the branch index, and the
  // station after position p (-1 past the route's end)
  auto visit = [&](int b, int p) { return vis[min(b, n_b - 1) * n_l + p]; };
  auto after = [&](int b, int p) { return p + 1 < n_l ? visit(b, p + 1) : -1; };

  const uint32_t base = mix(static_cast<uint32_t>(a.seeds[lane_id]) + GOLDEN);
  const int max_events = a.max_events[lane_id];
  // the second stream and its per-event block of counters
  const uint32_t base2 = mix(static_cast<uint32_t>(a.seeds[lane_id]) + 2u * GOLDEN);
  const uint32_t blk = 2u * static_cast<uint32_t>(mpl) + 4u;
  const float* flow_cdf = zipf ? fcum : nullptr;

  // init: every job starts a request at its (think) first station; the
  // open loop starts with every slot free
  typename std::conditional<kTi, TierJobs<R>, Jobs<R>>::type jobs;
  jobs.bind(smem + lay.jobs, mpl, me);
#pragma unroll
  for (int r = 0; r < jobs.slots(); ++r) {
    const int i = me + 32 * r;
    if (!kOp && i < mpl) {
      const int b = count_below(cum, n_b, u01(base, i));
      const int st = visit(b, 0);
      jobs.ready(r) = static_cast<uint32_t>(service_ns(u01(base, mpl + i), law[st]));
      jobs.st(r) = st;
      jobs.nx(r) = after(b, 0);
      jobs.br(r) = b;
      jobs.pos(r) = 0;
      jobs.enq(r) = BIG_SEQ;
    } else {
      jobs.ready(r) = NEVER;
      jobs.st(r) = NO_JOB;
      jobs.nx(r) = NO_JOB;
      jobs.br(r) = 0;
      jobs.pos(r) = 0;
      jobs.enq(r) = NO_JOB;
    }
    if constexpr (kExt) {
      jobs.fl(r) = -1;
      jobs.age(r) = 0.0f;
    }
    if constexpr (kTi) {
      jobs.fl(r) = -1;
#pragma unroll
      for (int l = 0; l < kMaxHeld; ++l) jobs.hd(r, l) = -1;
      jobs.po(r) = -1;
      jobs.pl(r) = -1;
    }
  }

  // the lane's streaming sketch (kSk), in every thread.  kLog: the event
  // loop logs each event (EventLog lg) and is left when the log is full
  // (or its woken log past kWlogFlush); the sketch replays the log outside
  // the loop, so that no memory operation and none of its code lies in it
  typename lane_of<E>::type skl;
  if constexpr (kSk) skl.init(ex.sk, lane_id, me);
  constexpr bool kLog = kSk && lane_of<E>::type::kLog;
  typename std::conditional<kLog, EventLog, NoLog>::type lg;
  if constexpr (kLog) lg.wlog = reinterpret_cast<int*>(smem + lay.wlog);
  typename std::conditional<kLog, SketchEvent, NoLog>::type ske;

  uint32_t clock = 0;
  int seq_ctr = 0, completed = 0, warm_completed = -1, events = 0;
  float elapsed_us = 0.0f, warm_elapsed_us = 0.0f;
  int delayed = 0, warm_delayed = 0;  // kExt
  // kOp: the next arrival (absolute; none while OFF), the burst phase and
  // its end, the arrivals dropped
  const float ia_mean = kOp ? ex.ia_mean[lane_id] : 0.0f;
  bool arr_on = true, ph_on = true;
  uint32_t arr_at = 0, ph_at = 0;
  int dropped = 0;
  if constexpr (kOp) {
    arr_at = static_cast<uint32_t>(exp_ns(u01(base2, 2u * mpl + 1u), ia_mean));
    if (ex.burst) ph_at = static_cast<uint32_t>(exp_ns(u01(base2, 2u * mpl + 3u), ex.on_mean));
  }
  // this thread's event of the batch: its branch draw, the branch's first
  // station and the station after it
  int my_branch = 0, my_first = 0, my_first_nx = 0;
  int slot = kBatch;  // the current event's place in its batch
  int ring_row = 0;   // kTrace: completed % cap
  // kTrace: one event's trace stores, made at the top of the next event
  // (and after the last), where nothing they need is still in flight
  struct {
    bool done = false;
    size_t row = 0;
    int req = 0, branch = 0, miss = 0, nvis = 0;
    float enter = 0.0f, leave = 0.0f;  // this thread's slot of the record
    float *enter_at, *leave_at;         // this thread's stamp slot of job j
    float enter_stamp = 0.0f, leave_stamp = 0.0f;
  } tr;
  tr.enter_at = tr.leave_at = trash + me;
  auto store_trace = [&]() {
    if constexpr (kTrace > 0) {
      *tr.leave_at = tr.leave_stamp;
      *tr.enter_at = tr.enter_stamp;
      if (tr.done) {  // threads other than 0 and past the route: scrap row
        const size_t scrap = static_cast<size_t>(lane_id) * (rings.cap + 1) + rings.cap;
        const size_t row0 = me == 0 ? tr.row : scrap;
        rings.req[row0] = tr.req;
        rings.branch[row0] = tr.branch;
        rings.cls[row0] = tr.miss ? CLS_MISS : CLS_HIT;
        rings.nvis[row0] = tr.nvis;
        rings.parked[row0] = 0.0f;
        const size_t row_v = (me < n_l ? tr.row : scrap) * n_l + min(me, n_l - 1);
        rings.enter[row_v] = tr.enter;
        rings.leave[row_v] = tr.leave;
      }
    }
  };
  const size_t rec0 = static_cast<size_t>(lane_id) * (kOp ? ex.rec_len : 0);
  // kOp: a completed request's sojourn and class at completion index idx
  auto record = [&](int idx, float soj, int c) {
    if constexpr (kOp) {
      if (idx < ex.rec_len) {
        ex.soj[rec0 + idx] = soj;
        ex.cls[rec0 + idx] = static_cast<signed char>(c);
      }
    }
  };
  // kTrace, every mode but the closed loop: the records of the jobs a fill
  // wakes, stored in the event itself, in job order (a ballot per slot
  // round, its set bits in turn; the warp writes each record: stamp slot u
  // by thread u % 32, which alone reads and writes it, the other fields by
  // thread 0, as the deferred stores do, so a later record on the same row
  // is stored after).  is_woken(r): this thread's slot r holds a woken job.
  // Each leaves its park visit now, parked since it entered it; in the
  // closed modes its fresh request enters visit 0 now.
  auto trace_woken = [&](auto is_woken) {
    if constexpr (kTrace > 0 && kMode != kClosed) {
      int req = completed;
      const size_t lane0 = static_cast<size_t>(lane_id) * (rings.cap + 1);
#pragma unroll
      for (int r = 0; r < jobs.max_slots(); ++r) {
        const bool w = r < jobs.slots() && is_woken(r);
        const int pw = w ? jobs.pos(r) : 0, bw = w ? jobs.br(r) : 0;
        unsigned m = __ballot_sync(FULL, w);
        while (m != 0u) {
          const int src = __ffs(m) - 1;
          m &= m - 1u;
          const int p = __shfl_sync(FULL, pw, src);
          const int b = __shfl_sync(FULL, bw, src);
          const size_t row = lane0 + req % rings.cap;
          float* ej = enter_s + (32 * r + src) * n_l;
          float* lj = leave_s + (32 * r + src) * n_l;
          float parked = 0.0f;
          for (int u = me; u < n_l; u += 32) {
            const float ev = ej[u];
            rings.enter[row * n_l + u] = ev;
            rings.leave[row * n_l + u] = u == p ? elapsed_us : lj[u];
            if (u == p) {
              lj[u] = elapsed_us;
              parked = elapsed_us - ev;
            }
            if (!kOp && u == 0) ej[0] = elapsed_us;
          }
          parked = __shfl_sync(FULL, parked, p & 31);
          if (me == 0) {
            rings.req[row] = req;
            rings.branch[row] = b;
            rings.cls[row] = CLS_DELAYED;
            rings.nvis[row] = p + 1;
            rings.parked[row] = parked;
          }
          ++req;
        }
      }
    }
  };
  do {
  while (completed < a.n_requests && events < max_events) {
    store_trace();
    if constexpr (kTrace > 0 && kOp) {
      // an arrival or a toggle writes no record and no stamp of j
      tr.done = false;
      tr.enter_at = tr.leave_at = trash + me;
    }
    if constexpr (kLog) lg.take_word(me);
    if (slot == kBatch) {
      // draw the next kBatch events, event e = events + me here (its
      // counters 2 mpl + 3 e + {0, 1, 2})
      __syncwarp();  // the last batch's table reads are done
      const int ctr = 2 * mpl + 3 * (events + me);
      const float u1 = u01(base, ctr), u2 = u01(base, ctr + 1);
      my_branch = count_below(cum, n_b, u01(base, ctr + 2));
      my_first = visit(my_branch, 0);
      my_first_nx = after(my_branch, 0);
      int* dm = draw + me * 2 * n_k;
      for (int k = 0; k < n_k; ++k) {
        const Law w = law[k];
        dm[k] = service_ns(u1, w);
        dm[n_k + k] = service_ns(u2, w);
      }
      __syncwarp();
      slot = 0;
    }
    const int new_branch = __shfl_sync(FULL, my_branch, slot);
    const int first = __shfl_sync(FULL, my_first, slot);
    const int first_nx = __shfl_sync(FULL, my_first_nx, slot);
    const int* d = draw + slot * 2 * n_k;
    const uint32_t c0 = static_cast<uint32_t>(events + 1) * blk;  // kExt

    // t = the least remaining time, j = the first job with it
    uint32_t lv = NEVER;
    int li = INT_MAX;
#pragma unroll
    for (int r = 0; r < jobs.slots(); ++r) {
      const uint32_t left = jobs.enq(r) == BIG_SEQ ? jobs.ready(r) - clock : NEVER;
      if (left < lv) {
        lv = left;
        li = me + 32 * r;
      }
    }
    const uint32_t t = __reduce_min_sync(FULL, lv);
    const int j = __reduce_min_sync(FULL, lv == t ? li : INT_MAX);
    if constexpr (!kOp) {
      clock += t;
      elapsed_us = __fmaf_rn(static_cast<float>(static_cast<int>(t)),
                             static_cast<float>(1e-3), elapsed_us);
      if constexpr (kSk && !kLog) skl.tick(elapsed_us);
    } else {
      // the next event: an arrival, a burst toggle or j's departure
      const uint32_t t_dep = t == NEVER ? INF_REL : t;
      const uint32_t rel_arr = arr_on ? arr_at - clock : INF_REL;
      const uint32_t rel_ph = ex.burst ? ph_at - clock : INF_REL;
      const bool is_arr = rel_arr <= min(t_dep, rel_ph);
      const bool is_tog = ex.burst && !is_arr && rel_ph <= t_dep;
      const uint32_t tt = min(min(rel_arr, t_dep), rel_ph);
      clock += tt;
      const float dt = static_cast<float>(static_cast<int>(tt)) * static_cast<float>(1e-3);
      elapsed_us = elapsed_us + dt;
      if constexpr (kSk && !kLog) skl.tick(elapsed_us);
#pragma unroll
      for (int r = 0; r < jobs.slots(); ++r) {
        if (jobs.st(r) != NO_JOB) jobs.age(r) += dt;
      }
      if (is_arr) {
        if constexpr (kSk && !kLog) skl.arrival();  // every offered arrival
        // the lowest free slot takes the request, or it is dropped
        int free_slot = -1;
#pragma unroll
        for (int r = 0; r < jobs.max_slots(); ++r) {
          const bool fr = r < jobs.slots() && me + 32 * r < mpl && jobs.st(r) == NO_JOB;
          const unsigned m = __ballot_sync(FULL, fr);
          if (m != 0u) {
            free_slot = 32 * r + __ffs(m) - 1;
            break;
          }
        }
        if (free_slot >= 0) {
          // traced: the admitted request enters visit 0 now (stamp slot 0
          // is thread 0's)
          if constexpr (kTrace > 0) {
            if (me == 0) enter_s[free_slot * n_l] = elapsed_us;
          }
          const uint32_t ready0 = clock + static_cast<uint32_t>(d[n_k + first]);
          jobs.at(me == (free_slot & 31) ? free_slot >> 5 : -1, [&](int r) {
            jobs.ready(r) = ready0;
            jobs.st(r) = first;
            jobs.nx(r) = first_nx;
            jobs.br(r) = new_branch;
            jobs.pos(r) = 0;
            jobs.enq(r) = BIG_SEQ;
            jobs.fl(r) = -1;
            jobs.age(r) = 0.0f;
          });
        } else {
          dropped += 1;
        }
        arr_at = clock + static_cast<uint32_t>(exp_ns(u01(base2, c0 + 2u * mpl + 1u), ia_mean));
      } else if (is_tog) {
        // ON -> OFF: arrivals pause; OFF -> ON: a fresh arrival clock
        ph_on = !ph_on;
        arr_on = ph_on;
        if (ph_on) {
          arr_at = clock + static_cast<uint32_t>(exp_ns(u01(base2, c0 + 2u * mpl + 2u), ia_mean));
        }
        ph_at = clock + static_cast<uint32_t>(exp_ns(u01(base2, c0 + 2u * mpl + 3u),
                                                     ph_on ? ex.on_mean : ex.off_mean));
      }
      if (is_arr || is_tog) {
        events += 1;
        ++slot;
        if constexpr (kLog) {  // the arrival's or the toggle's record
          lg.event(me, elapsed_us, is_arr ? 1 : 0, -1);
          if (lg.full()) break;  // the logged events to the sketch
        }
        continue;
      }
    }

    // job j's place, from its owner
    const int owner = j & 31;
    int o_st = 0, o_nx = 0, o_br = 0, o_pos = 0, o_fl = -1;  // meaningful in the owner
    float o_age = 0.0f;
    int o_fill = -1;  // kTiers: the entry j's visit releases (-1: none)
    jobs.at(j >> 5, [&](int r) {
      o_st = jobs.st(r);
      o_nx = jobs.nx(r);
      o_br = jobs.br(r);
      o_pos = jobs.pos(r);
      if constexpr (kExt) {
        o_fl = jobs.fl(r);
        o_age = jobs.age(r);
      }
    });
    // kLog: j's completion word, a hit unless its branch is a miss route
    // (owner's view; read now, shuffled at the end of the event)
    if constexpr (kLog) ske.o_word = 2 * o_br + (miss[min(o_br, n_b - 1)] == 0 ? 1 : 0);
    if constexpr (kTi) {
      // the fill: completing this visit frees the entry j holds at the
      // level it releases (the cascade never touches j, which is live).
      // Through constant slot indices, outside the lambda, so that the
      // slots stay registers
#pragma unroll
      for (int r = 0; r < jobs.max_slots(); ++r) {
        if (r == (j >> 5) && r < jobs.slots()) {
          o_fl = jobs.fl(r);
          const int rel = tab[2 * n_b * n_l + min(o_br, n_b - 1) * n_l + o_pos];
#pragma unroll
          for (int l = 0; l < kMaxHeld; ++l) {
            if (l == rel) {
              o_fill = jobs.hd(r, l);
              if (me == owner) jobs.hd(r, l) = -1;
            }
          }
        }
      }
    }
    const int k_cur = __shfl_sync(FULL, o_st, owner);
    const int route_next = __shfl_sync(FULL, o_nx, owner);
    // kTrace: j's branch and position, and this thread's stamp slot of
    // j's request, read now so that the record's stores wait on nothing
    int bj = 0, pos_j = 0;
    float enter_v = 0.0f, leave_v = 0.0f;
    if constexpr (kTrace > 0) {
      bj = __shfl_sync(FULL, o_br, owner);
      pos_j = __shfl_sync(FULL, o_pos, owner);
      enter_v = enter_s[j * n_l + min(me, n_l - 1)];
      leave_v = leave_s[j * n_l + min(me, n_l - 1)];
    }
    // kExt: j's flow; a fill when j ends service at a disk with one
    int f_cur = -1;
    bool fill = false;
    if constexpr (kExt) {
      bj = __shfl_sync(FULL, o_br, owner);
      f_cur = __shfl_sync(FULL, o_fl, owner);
      fill = f_cur >= 0 && rank[k_cur] >= 0;
    }
    // j parks (kExt, kTiers) behind the leader of its flow f_new (kExt) or
    // of entry slot_new (kTiers) at k_next
    bool at_disk = false, parks = false;
    int f_new = -1;
    // kTiers: the fill's cascade, then j's placement at k_next
    int n_woken_t = 0, acq_lvl = -1, slot_new = -1;
    bool at_acq = false;
    if constexpr (kTi) {
      bj = __shfl_sync(FULL, o_br, owner);
      pos_j = __shfl_sync(FULL, o_pos, owner);
      f_cur = __shfl_sync(FULL, o_fl, owner);
      const int slot0 = __shfl_sync(FULL, o_fill, owner);
      if (slot0 >= 0) {
        const int n_words = (ex.n_lead + 32) >> 5;  // n_lead + 1 bits
        for (int w = me; w < n_words; w += 32) freed[w] = w == (slot0 >> 5) ? 1u << (slot0 & 31) : 0u;
        if (me == 0) lead[slot0] = -1;
        __syncwarp();
        for (int wave = 0; wave < ex.max_held; ++wave) {
          // the parked jobs whose entry the last wave freed wake
          int lnew = 0;
#pragma unroll
          for (int r = 0; r < jobs.slots(); ++r) {
            if (jobs.st(r) == PARKED) {
              const int e = jobs.po(r);
              if ((freed[e >> 5] >> (e & 31)) & 1u) {
                jobs.st(r) = WAKING;
                ++lnew;
              }
            }
          }
          const int nw = __reduce_add_sync(FULL, lnew);
          if (nw == 0) break;
          n_woken_t += nw;
          __syncwarp();  // the bitmap's reads are done
          for (int w = me; w < n_words; w += 32) freed[w] = 0u;
          __syncwarp();
          // their held entries are fills that landed too
#pragma unroll
          for (int r = 0; r < jobs.slots(); ++r) {
            if (jobs.st(r) == WAKING) {
#pragma unroll
              for (int l = 0; l < kMaxHeld; ++l) {
                const int h = jobs.hd(r, l);
                if (h >= 0) {
                  atomicOr(&freed[h >> 5], 1u << (h & 31));
                  lead[h] = -1;
                }
              }
              jobs.st(r) = WOKEN;
            }
          }
          __syncwarp();
        }
      }
      // the placement: at an acquire j takes its request's flow (drawn now
      // if it has none) and parks behind the entry's leader or leads it
      const int ti = min(route_next < 0 ? new_branch : bj, n_b - 1) * n_l +
                     (route_next < 0 ? 0 : pos_j + 1);
      const int g = tab[ti];
      at_acq = g >= 0;
      if (at_acq) {
        acq_lvl = tab[n_b * n_l + ti];
        const int f_req = f_cur >= 0
                              ? f_cur
                              : flow_of(u01(base2, c0 + 2u * mpl), ex.n_flows, flow_cdf);
        slot_new = g * ex.n_flows + f_req;
        f_new = f_req;
        parks = lead[slot_new] >= 0;
      }
    }

    // the station after j's next one, unless j completes (owner's view)
    const int nx_cont = after(o_br, o_pos + 1);

    // the FIFO successor of j at k_cur: the least enqueue sequence among
    // the jobs waiting there (none at a think station)
    int lseq = BIG_SEQ;
    // j's next station, and the servers busy there once j has left: the
    // other jobs in service at it, plus the successor if it starts there
    const bool done = route_next < 0;
    const int k_next = done ? (kOp ? 0 : first) : route_next;
    const int2 qn = q[k_next];
    const int svc_w = d[k_cur], svc_j = d[n_k + k_next];
    // kExt: arriving at a disk, j samples a flow and parks behind its
    // leader or leads it (the entry a fill clears this event reads free)
    if constexpr (kExt) {
      if (ex.n_flows > 0 && !(kOp && done)) {
        const int rk = rank[k_next];
        at_disk = rk >= 0;
        if (at_disk) {
          f_new = rk * ex.n_flows + flow_of(u01(base2, c0 + 2u * mpl), ex.n_flows, flow_cdf);
          parks = lead[f_new] >= 0 && !(fill && f_new == f_cur);
        }
      }
    }
    int lbusy = 0, lwoken = 0;
#pragma unroll
    for (int r = 0; r < jobs.slots(); ++r) {
      const int e = jobs.enq(r), st = jobs.st(r);
      if (e != BIG_SEQ && st == k_cur && e < lseq) lseq = e;
      lbusy += (e == BIG_SEQ && st == k_next && me + 32 * r != j) ? 1 : 0;
      if constexpr (kExt) lwoken += (fill && jobs.fl(r) == f_cur && me + 32 * r != j) ? 1 : 0;
    }
    const int seq = __reduce_min_sync(FULL, lseq);
    const bool handover = seq < BIG_SEQ;
    const int busy_next =
        __reduce_add_sync(FULL, lbusy) + (handover && k_next == k_cur ? 1 : 0);
    bool starts_now = !qn.x || busy_next < qn.y;
    bool waits = !starts_now;
    if constexpr (kExt || kTi) {
      starts_now = starts_now && !parks && !(kOp && done);
      waits = waits && !parks && !(kOp && done);
    }

    // kExt: the fill wakes every job parked on j's flow.  They complete
    // (as delayed hits) before j: in the closed loop each starts a fresh
    // request, counted under the branch it parked on; in the open loop
    // each leaves, recorded in job order.
    if constexpr (kLog) ske.nw = 0;
    if constexpr (kExt) {
      if (fill) {
        const int n_woken = __reduce_add_sync(FULL, lwoken);
        if (n_woken > 0) {
          trace_woken([&](int r) { return jobs.fl(r) == f_cur && me + 32 * r != j; });
          if constexpr (kLog) {
            lg.woken(jobs, me, n_woken,
                     [&](int r) { return jobs.fl(r) == f_cur && me + 32 * r != j; });
            ske.nw = n_woken;
          }
          int before = completed;  // the next woken job's record index
          const unsigned lower = (1u << me) - 1u;
#pragma unroll
          for (int r = 0; r < jobs.max_slots(); ++r) {
            const int i = me + 32 * r;
            const bool w = r < jobs.slots() && jobs.fl(r) == f_cur && i != j;
            if constexpr (kOp) {
              const unsigned m = __ballot_sync(FULL, w);
              if (w) {
                if constexpr (kSk && !kLog) skl.many_branch(jobs.br(r));
                record(before + __popc(m & lower), jobs.age(r), CLS_DELAYED);
                jobs.ready(r) = NEVER;
                jobs.st(r) = NO_JOB;
                jobs.enq(r) = NO_JOB;
                jobs.fl(r) = -1;
              }
              before += __popc(m);
            } else if (w) {
              const int b = jobs.br(r);
              if (b < n_b) {
                atomicAdd(&bcnt[b], 1);
                atomicAdd(&bcnt[n_b + b], 1);
              }
              if constexpr (kSk && !kLog) skl.many_branch(b);
              const uint32_t ci = c0 + 2u * static_cast<uint32_t>(i);
              const int wb = count_below(cum, n_b, u01(base2, ci));
              const int wst = visit(wb, 0);
              jobs.ready(r) = clock + static_cast<uint32_t>(service_ns(u01(base2, ci + 1u), law[wst]));
              jobs.st(r) = wst;
              jobs.nx(r) = after(wb, 0);
              jobs.br(r) = wb;
              jobs.pos(r) = 0;
              jobs.enq(r) = BIG_SEQ;
              jobs.fl(r) = -1;
            }
          }
          completed += n_woken;
          delayed += n_woken;
          if constexpr (kSk && !kLog) skl.many(n_woken);
        }
      }
    }

    // kTiers: the cascade's jobs complete as delayed hits, counted under
    // the branch and at the level they parked at, and start fresh requests
    if constexpr (kTi) {
      if (n_woken_t > 0) {
        trace_woken([&](int r) { return jobs.st(r) == WOKEN; });
        if constexpr (kLog) {
          lg.woken(jobs, me, n_woken_t, [&](int r) { return jobs.st(r) == WOKEN; });
          ske.nw = n_woken_t;
        }
#pragma unroll
        for (int r = 0; r < jobs.slots(); ++r) {
          if (jobs.st(r) == WOKEN) {
            const int i = me + 32 * r;
            const int b = jobs.br(r);
            if (b < n_b) {
              atomicAdd(&bcnt[b], 1);
              atomicAdd(&bcnt[n_b + b], 1);
            }
            if constexpr (kSk && !kLog) skl.many_branch(b);
            atomicAdd(&dlv[jobs.pl(r)], 1);
            const uint32_t ci = c0 + 2u * static_cast<uint32_t>(i);
            const int wb = count_below(cum, n_b, u01(base2, ci));
            const int wst = visit(wb, 0);
            jobs.ready(r) = clock + static_cast<uint32_t>(service_ns(u01(base2, ci + 1u), law[wst]));
            jobs.st(r) = wst;
            jobs.nx(r) = after(wb, 0);
            jobs.br(r) = wb;
            jobs.pos(r) = 0;
            jobs.enq(r) = BIG_SEQ;
            jobs.fl(r) = -1;
#pragma unroll
            for (int l = 0; l < kMaxHeld; ++l) jobs.hd(r, l) = -1;
            jobs.po(r) = -1;
            jobs.pl(r) = -1;
          }
        }
        completed += n_woken_t;
        delayed += n_woken_t;
        if constexpr (kSk && !kLog) skl.many(n_woken_t);
      }
    }

    // the owners' updates, predicated: a branch here costs more than
    // it skips.  The successor starts service, j moves on.
    {
      const uint32_t ready_w = clock + static_cast<uint32_t>(svc_w);
#pragma unroll
      for (int r = 0; r < jobs.slots(); ++r) {
        if (handover && jobs.enq(r) == seq) {
          jobs.ready(r) = ready_w;
          jobs.enq(r) = BIG_SEQ;
        }
      }
    }
    {  // slot -1 outside j's owner
      const uint32_t ready_j = clock + static_cast<uint32_t>(svc_j);
      const int enq_j = starts_now ? BIG_SEQ : waits ? seq_ctr : NO_JOB;
      const bool leaves = kOp && done;
      jobs.at(me == owner ? j >> 5 : -1, [&](int r) {
        jobs.ready(r) = leaves ? NEVER : ready_j;
        jobs.enq(r) = enq_j;
        jobs.st(r) = leaves ? NO_JOB : parks ? PARKED : k_next;
        jobs.nx(r) = done ? first_nx : nx_cont;
        jobs.br(r) = done ? new_branch : o_br;
        jobs.pos(r) = done ? 0 : o_pos + 1;
        if constexpr (kExt) jobs.fl(r) = at_disk ? f_new : -1;
      });
    }
    if constexpr (kTi) {
#pragma unroll
      for (int r = 0; r < jobs.max_slots(); ++r) {
        if (me == owner && r == (j >> 5) && r < jobs.slots()) {
          jobs.fl(r) = at_acq ? f_new : done ? -1 : o_fl;
#pragma unroll
          for (int l = 0; l < kMaxHeld; ++l) {
            if (l == acq_lvl && !parks) jobs.hd(r, l) = slot_new;
          }
          jobs.po(r) = parks ? slot_new : -1;
          jobs.pl(r) = parks ? acq_lvl : -1;
        }
      }
    }
    if constexpr (kTi) {
      // j leads its entry, and a completion is counted; thread 0 writes
      // after every read above
      __syncwarp();
      if (me == 0) {
        if (at_acq && !parks) lead[slot_new] = j;
        if (done && bj < n_b) atomicAdd(&bcnt[bj], 1);
      }
      __syncwarp();
    }
    if constexpr (kExt) {
      // the leader table: the fill frees j's entry, a leading miss takes
      // its own; thread 0 writes, in that order, after every read above
      if (me == 0) {
        if (fill) lead[f_cur] = -1;
        if (at_disk && !parks) lead[f_new] = j;
        if constexpr (kMode == kFlows) {
          if (done && bj < n_b) atomicAdd(&bcnt[bj], 1);
        }
      }
      __syncwarp();
    }
    if constexpr (kMode == kCount) {
      if (done && me == owner && o_br < n_b) atomicAdd(&bcnt[o_br], 1);
    }
    if constexpr (kOp) {
      // the leaving request's sojourn is its owner's age of the slot
      if (done && me == owner) record(completed, o_age, miss[min(bj, n_b - 1)] ? CLS_MISS : CLS_HIT);
    }

    if constexpr (kTrace > 0) {
      // the finished request's record, its last visit left just now, and
      // the stamps: held in registers, stored at the top of the next event
      // (with coalescing, after the woken jobs' records: req counts them)
      const int pos_next = done ? 0 : pos_j + 1;
      float* enter_j = enter_s + j * n_l;
      float* leave_j = leave_s + j * n_l;
      if constexpr (kMode != kClosed) ring_row = completed % rings.cap;
      const size_t row = static_cast<size_t>(lane_id) * (rings.cap + 1) + ring_row;
      tr.done = done;
      tr.row = row;
      tr.req = completed;
      tr.branch = bj;
      tr.miss = miss[min(bj, n_b - 1)];  // read here, used an event later
      tr.nvis = pos_j + 1;
      tr.enter = enter_v;
      tr.leave = me == pos_j ? elapsed_us : leave_v;
      ring_row = done ? (ring_row + 1 == rings.cap ? 0 : ring_row + 1) : ring_row;
      // stamp slot v belongs to thread v % 32: it rewrites its slot (the
      // new stamp or the value it read), threads past the route a trash word
      tr.leave_at = me < n_l ? leave_j + me : trash + me;
      tr.leave_stamp = me == pos_j ? elapsed_us : leave_v;
      // (kOp: a request that completes leaves its slot and enters nothing)
      tr.enter_at = me < n_l && !(kOp && done) ? enter_j + me : trash + me;
      tr.enter_stamp = me == pos_next ? elapsed_us : enter_v;
      if constexpr (kTrace == 2) {  // routes longer than a warp: slots 32..
        for (int u = me + 32; done && u < n_l; u += 32) {
          rings.enter[row * n_l + u] = enter_j[u];
          rings.leave[row * n_l + u] = u == pos_j ? elapsed_us : leave_j[u];
        }
        if (pos_j >= 32 && (pos_j & 31) == me) leave_j[pos_j] = elapsed_us;
        if (pos_next >= 32 && (pos_next & 31) == me) enter_j[pos_next] = elapsed_us;
      }
    }

    if constexpr (kLog) {
      // this event's record: its time, the jobs it woke, the key of a miss
      // at a disk (kTiers: a request's flow, at its first acquire); j's
      // completion word, logged at the top of the next event
      int key = -1;
      if constexpr (kExt) key = at_disk ? f_new : -1;
      if constexpr (kTi) key = at_acq && f_cur < 0 ? f_new : -1;
      lg.event(me, elapsed_us, ske.nw << 1, key);
      const int w_sk = __shfl_sync(FULL, ske.o_word, owner);
      lg.word = done ? w_sk : -1;
    } else if constexpr (kSk) {
      // j's completion, a hit unless its branch is a miss route; then the
      // key of a miss at a disk (kTiers: a request's flow, at its first
      // acquire)
      if (done) {
        const int b_sk = __shfl_sync(FULL, o_br, owner);
        skl.completion(b_sk, miss[min(b_sk, n_b - 1)] == 0, false);
      }
      if constexpr (kExt) {
        if (at_disk) skl.observe(f_new);
      }
      if constexpr (kTi) {
        if (at_acq && f_cur < 0) skl.observe(f_new);
      }
    }
    completed += done ? 1 : 0;
    seq_ctr += waits ? 1 : 0;
    // warmup bookkeeping
    if (completed >= a.warmup && warm_completed < 0) {
      warm_completed = completed;
      warm_elapsed_us = elapsed_us;
      if constexpr (kExt || kTi) warm_delayed = delayed;
      if constexpr (kCnt) {
        __syncwarp();  // the counts' atomics are done
        for (int i = me; i < 2 * n_b; i += 32) bcnt[2 * n_b + i] = bcnt[i];
        if constexpr (kTi) {
          if (me < kMaxHeld) dlv[kMaxHeld + me] = dlv[me];
        }
        __syncwarp();
      }
    }
    events += 1;
    ++slot;
    if constexpr (kLog) {
      if (lg.full() || lg.wpos > kWlogFlush) break;  // the events to the sketch
    }
  }
  if constexpr (kLog) {  // the logged events, replayed by the sketch
    lg.take_word(me);
    __syncwarp();  // the woken log's writes are done
    skl.replay_block(me < lg.n, lg.t, lg.a, lg.k, lg.w, lg.wlog);
    lg.n = 0;
    lg.wpos = 0;
    __syncwarp();  // its reads are done before it is written again
  }
  } while (kLog && completed < a.n_requests && events < max_events);
  store_trace();
  if constexpr (kSk) skl.finish(ex.sk, lane_id);
  if constexpr (kCnt) {
    __syncwarp();
    for (int b = me; b < n_b; b += 32) {
      ex.branch_done[lane_id * n_b + b] = bcnt[b] - bcnt[2 * n_b + b];
      ex.branch_delayed[lane_id * n_b + b] = bcnt[n_b + b] - bcnt[3 * n_b + b];
    }
  }
  if (me == 0) {
    const float t_meas = fmaxf(elapsed_us - warm_elapsed_us, static_cast<float>(1e-6));
    a.x[lane_id] = static_cast<float>(completed - warm_completed) / t_meas;
    a.completed[lane_id] = completed;
    a.events[lane_id] = events;
    a.tmeas[lane_id] = t_meas;
    if constexpr (kTrace > 0) rings.n_count[lane_id] = completed;  // one record each
    if constexpr (kExt || kCnt) {
      ex.delayed_frac[lane_id] = static_cast<float>(delayed - warm_delayed) /
                                 static_cast<float>(max(completed - warm_completed, 1));
    }
    if constexpr (kTi) {
      for (int l = 0; l < ex.max_held; ++l) {
        ex.delayed_tier[lane_id * ex.max_held + l] =
            static_cast<float>(dlv[l] - dlv[kMaxHeld + l]) /
            static_cast<float>(max(completed - warm_completed, 1));
      }
    }
    if constexpr (kOp) ex.dropped[lane_id] = dropped;
  }
}

template <int kTrace, int R, int kMode, class E>
int launch_slots(const Args& a, const Rings& rings, int lanes, void* stream,
                 const E& ex) {
  const int n_cdf = ex.flow_cum != nullptr ? ex.n_flows : 0;
  const int bytes = layout(a.n_k, a.n_b, a.n_l, a.mpl, kTrace > 0, R == 0, kMode,
                           ex.n_lead, n_cdf, is_sketched<E>::value).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sim_kernel<kTrace, R, kMode, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 0) return 0;
  sim_kernel<kTrace, R, kMode, E><<<lanes, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, rings, ex);
  return (int)cudaGetLastError();
}

template <int kMode, class E, int kTrace = 0>
int launch_ext(const Args& a, const E& ex, int lanes, void* stream,
               const Rings& rings = Rings{}) {
  switch (reg_slots(a.mpl)) {
    case 1: return launch_slots<kTrace, 1, kMode, E>(a, rings, lanes, stream, ex);
    case 2: return launch_slots<kTrace, 2, kMode, E>(a, rings, lanes, stream, ex);
    case 4: return launch_slots<kTrace, 4, kMode, E>(a, rings, lanes, stream, ex);
    case 8: return launch_slots<kTrace, 8, kMode, E>(a, rings, lanes, stream, ex);
    default: return launch_slots<kTrace, 0, kMode, E>(a, rings, lanes, stream, ex);
  }
}

}  // namespace

// Every launch's arguments, as one C struct (ctypes:
// repro_torch.kernels.event_sim._ExtArgs).
struct ExtArgs {
  const int* isq;
  const float* svc;
  const int* did;
  const float* dpar;
  const float* bcum;
  const int* visits;
  const int* servers;
  const int* seeds;
  const int* max_events;
  const int* disk_rank;
  const float* flow_cum;
  const int* bmiss;
  const float* ia_mean;
  float* x;
  int* completed;
  int* events;
  float* tmeas;
  float* delayed_frac;
  int* branch_done;
  int* branch_delayed;
  int* dropped;
  float* soj;
  signed char* cls;
  const int* acq_group;
  const int* acq_slot;
  const int* rel_slot;
  float* delayed_tier;
  int lanes, n_k, n_b, n_l, mpl, n_requests, warmup, n_flows, n_lead, open,
      burst, rec_len, tiers, max_held;
  float on_mean, off_mean;
  // the closed loop without counts (closed), and its rings when traced
  // (cap > 0; bmiss above is their miss classes)
  int closed, cap;
  int* n_count;
  int* req;
  int* rbranch;
  int* rcls;
  int* nvis;
  float* parked;
  float* enter;
  float* leave;
};

static inline Args args_of(const ExtArgs& p) {
  return Args{p.isq, p.svc, p.did, p.dpar, p.bcum, p.visits, p.servers,
              p.seeds, p.max_events, p.x, p.completed, p.events, p.tmeas,
              p.n_k, p.n_b, p.n_l, p.mpl, p.n_requests, p.warmup};
}

static inline Ext ext_of(const ExtArgs& p) {
  return Ext{p.disk_rank, p.flow_cum, p.bmiss, p.ia_mean, p.delayed_frac,
             p.branch_done, p.branch_delayed, p.dropped, p.soj, p.cls,
             p.n_flows, p.n_lead, p.burst, p.rec_len, p.on_mean, p.off_mean};
}

// The mode of an ExtArgs launch: the open loop, the tiered tables,
// coalescing (n_flows > 0), the closed loop (closed) or the closed loop
// with per-branch counts.
static inline int ext_mode(const ExtArgs& p) {
  return p.open ? kOpen : p.tiers ? kTiers : p.n_flows > 0 ? kFlows : p.closed ? kClosed : kCount;
}

// Shared memory of one block of the launch p describes, with the sketch or
// without it.
static inline int ext_shared_bytes(const ExtArgs& p, bool sketched) {
  return layout(p.n_k, p.n_b, p.n_l, p.mpl, p.cap > 0, reg_slots(p.mpl) == 0,
                ext_mode(p), p.n_lead, p.flow_cum != nullptr ? p.n_flows : 0,
                sketched)
      .bytes;
}

// TE (TierExt, or Sketched<TierExt>) filled from p, but for a sketch.
template <class TE>
static inline TE tiers_of(const ExtArgs& p) {
  TE tx;
  static_cast<Ext&>(tx) = ext_of(p);
  tx.acq_group = p.acq_group;
  tx.acq_slot = p.acq_slot;
  tx.rel_slot = p.rel_slot;
  tx.delayed_tier = p.delayed_tier;
  tx.max_held = p.max_held;
  return tx;
}

// The modes whose sketch observes keys or wakes jobs: coalescing, the open
// loop and the tiers (their sketched instantiations log each event).
static inline bool observes(int mode) {
  return mode == kFlows || mode == kOpen || mode == kTiers;
}

// The launch of the observing mode ext_mode(p) selects, one warp per lane
// on `stream`, with parameters ex (kTiers: tx).  Returns the cudaError_t.
template <class E, class TE>
static int launch_observing(const ExtArgs& p, const E& ex, const TE& tx,
                            void* stream) {
  const Args a = args_of(p);
  switch (ext_mode(p)) {
    case kOpen: return launch_ext<kOpen, E>(a, ex, p.lanes, stream);
    case kTiers:
      if (p.max_held > kMaxHeld || p.max_held < 1) return (int)cudaErrorInvalidValue;
      return launch_ext<kTiers, TE>(a, tx, p.lanes, stream);
    default: return launch_ext<kFlows, E>(a, ex, p.lanes, stream);
  }
}

// The launch of the counting mode, or of the closed loop, traced into the
// rings of p when p.cap > 0, with parameters ex.  Returns the cudaError_t.
template <class E>
static int launch_closed(const ExtArgs& p, const E& ex, void* stream) {
  const Args a = args_of(p);
  if (ext_mode(p) == kCount) return launch_ext<kCount, E>(a, ex, p.lanes, stream);
  if (p.cap <= 0) return launch_ext<kClosed, E>(a, ex, p.lanes, stream);
  const Rings rings{p.bmiss, p.n_count, p.req, p.rbranch, p.rcls,
                    p.nvis, p.parked, p.enter, p.leave, p.cap};
  return p.n_l > 32 ? launch_ext<kClosed, E, 2>(a, ex, p.lanes, stream, rings)
                    : launch_ext<kClosed, E, 1>(a, ex, p.lanes, stream, rings);
}

// The launch of the mode ext_mode(p) selects, one warp per lane on
// `stream`, with parameters ex (kTiers: tx); closed, traced when
// p.cap > 0.  Returns the cudaError_t.
template <class E, class TE>
static int launch_mode(const ExtArgs& p, const E& ex, const TE& tx,
                       void* stream) {
  return observes(ext_mode(p)) ? launch_observing(p, ex, tx, stream)
                               : launch_closed(p, ex, stream);
}

// The sketched parameters of launch p with the sketch s and device code L
// (E: Sketched<Ext, L>; TE: Sketched<TierExt, L>).
template <class L>
static inline Sketched<Ext, L> sketched_ext(const ExtArgs& p, const SketchArgs& s) {
  Sketched<Ext, L> ex;
  static_cast<Ext&>(ex) = ext_of(p);
  ex.sk = s;
  return ex;
}
template <class L>
static inline Sketched<TierExt, L> sketched_tiers(const ExtArgs& p, const SketchArgs& s) {
  auto tx = tiers_of<Sketched<TierExt, L>>(p);
  tx.sk = s;
  return tx;
}

// The sketch's device code: logged and replayed (sketch::SimLane, its
// SpaceSaving table in device memory) in the modes that observe keys or
// wake jobs; in place (sketch::Lane, at the reference's sites) in the
// closed, counting and traced closed modes, which observe no key and wake
// no job, and whose short loops a log costs more than it saves
// (tools/event_sim_sketch_ablation.py).
using LoggedLane = sketch::SimLane<>;
using InPlaceLane = sketch::Lane;

// event_sim_sketch.cu: launch_mode with the sketch s, every lane's state
// updated in place.
int sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream);

// The traced launch of the coalescing, open-loop or tiered mode that
// ext_mode(p) selects (p.cap > 0; the counting mode is not traced), with
// parameters ex (kTiers: tx), into the rings of p.  Every route length
// takes the kTrace = 2 instantiation: its loops over stamp slots past the
// warp run no iteration on shorter routes.  Returns the cudaError_t.
template <class E, class TE>
static int launch_traced_mode(const ExtArgs& p, const E& ex, const TE& tx,
                              void* stream) {
  const Args a = args_of(p);
  const Rings rings{p.bmiss, p.n_count, p.req, p.rbranch, p.rcls,
                    p.nvis, p.parked, p.enter, p.leave, p.cap};
  switch (ext_mode(p)) {
    case kOpen: return launch_ext<kOpen, E, 2>(a, ex, p.lanes, stream, rings);
    case kTiers:
      if (p.max_held > kMaxHeld || p.max_held < 1) return (int)cudaErrorInvalidValue;
      return launch_ext<kTiers, TE, 2>(a, tx, p.lanes, stream, rings);
    case kFlows: return launch_ext<kFlows, E, 2>(a, ex, p.lanes, stream, rings);
    default: return (int)cudaErrorInvalidValue;
  }
}

// event_sim_traced.cu and event_sim_traced_sketch.cu: launch_traced_mode
// without the sketch, and with the sketch s (LoggedLane).
int traced_launch(const ExtArgs& p, void* stream);
int traced_sketched_launch(const ExtArgs& p, const SketchArgs& s, void* stream);
