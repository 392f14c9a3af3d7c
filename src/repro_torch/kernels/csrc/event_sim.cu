// Event-sim kernel: one (p_hit, seed) lane of the closed network per warp.
//
// Replaces the TPU kernels src/repro/kernels/event_sim.py::_sim_kernel and,
// as the kTrace = true instantiation, ::_sim_kernel_traced (both launched
// by _pallas_grid, entry simulate_grid_pallas).  Each lane runs
// the closed-loop event simulation of `mpl` jobs: per event it draws three
// murmur3 counter uniforms, takes the argmin of the job ready times,
// hands a c-server FIFO station to its successor by enqueue sequence,
// advances the route (resampling the branch when a request completes)
// and takes the warmup snapshot.  repro_torch/kernels/event_sim.py holds
// the plain version (sim_lanes_plain), event for event.
//
// What bounds it on an H100: neither bytes nor operations, but the serial
// dependence between consecutive events of a lane — each event's argmin
// reads the ready times the previous event wrote.  The design keeps the
// lane's job state in shared memory, strides the mpl jobs over the 32
// threads of one warp (the two argmins are warp-shuffle reductions, no
// block barriers), and runs lanes in parallel across SMs.  Nothing more
// yet: at the main path's 7- and 1-lane grids most SMs sit idle.
//
// Execution model: all 32 threads run the scalar event logic on the same
// shared values; thread 0 writes the scalar-owned entries, and
// __syncwarp() separates writes from the reads around them.
//
// Tracing (kTrace): the per-job enter/leave stamps of the current request
// (mpl x L floats each) sit in shared memory after `busy`; a completed
// request's record goes straight to the lane's ring in global memory at
// row req % cap (thread 0 the scalars, threads 0..L-1 the two stamp rows),
// one write per completion.  The ring's scrap row is never written (the
// reference parks its masked writes there; decode drops it).  Tracing
// draws no random numbers, so both instantiations simulate the same events;
// the untraced one compiles no trace code.
//
// Where bit-exactness with the JAX reference could break:
//   * argmin ties: jnp.argmin returns the FIRST index; both shuffle
//     reductions compare (value, index) pairs lexicographically.
//   * index semantics: pick_branch may return B when u > branch_cum[B-1]
//     (float32 rounding of the cumulative law); JAX clamps the gather
//     visits[B, .] to row B-1, and so does every visits read below.
//   * RNG: _mix is native uint32 arithmetic with wraparound, as in JAX.
//   * float32 rounding: u01 uses the float32 constants of the reference
//     (2^-24 and the clip to [float32(1e-7), float32(1 - 1e-7)]);
//     jnp.round is round-half-to-even, which is rintf here, not roundf;
//     the clock update elapsed_us + t * 1e-3 is one fused multiply-add
//     (__fmaf_rn), as XLA's CPU backend compiles the reference's, and
//     -fmad=false keeps every other multiply and add unfused.  logf/powf
//     may differ from XLA's float32 log/pow in the last ulp, so
//     exponential and Pareto service draws are held statistically;
//     deterministic service is exact.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int IMAX = INT_MAX;
constexpr int INF_NS = INT_MAX;
constexpr int BIG_SEQ = INT_MAX;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int CLS_MISS = 0;
constexpr int CLS_HIT = 1;

struct Spec {
  const int* isq;     // (K) is_queue
  const float* svc;   // (K) mean service, ns
  const int* did;     // (K) 0 det, 1 exp, 2 bounded pareto
  const float* dpar;  // (K, 4) alpha, lo, hi, raw_mean
  const float* bcum;  // (B) cumulative branch law
  const int* visits;  // (B, Lr) station ids, -1 padded
  const int* servers; // (K)
  int n_b, n_l;
};

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float u01(uint32_t base, int ctr) {
  const uint32_t z = mix(base + static_cast<uint32_t>(ctr) * GOLDEN);
  const float u = static_cast<float>(z >> 8) * static_cast<float>(1.0 / (1 << 24));
  return fminf(fmaxf(u, static_cast<float>(1e-7)), static_cast<float>(1.0 - 1e-7));
}

// _service_ns: ns, int >= 1, with the uniform from the counter stream.
__device__ int service_ns(float u, const Spec& s, int k) {
  const float mean = s.svc[k];
  const int d = s.did[k];
  float unit = 0.0f;  // jnp.select's default
  if (d == 0) {
    unit = 1.0f;
  } else if (d == 1) {
    unit = -logf(u);
  } else if (d == 2) {
    const float alpha = s.dpar[4 * k], lo = s.dpar[4 * k + 1],
                hi = s.dpar[4 * k + 2], raw = s.dpar[4 * k + 3];
    const float ratio = 1.0f - powf(lo / hi, alpha);
    unit = lo * powf(1.0f - u * ratio, -1.0f / alpha) / raw;
  }
  return static_cast<int>(fmaxf(rintf(unit * mean), 1.0f));
}

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

// searchsorted-left over the cumulative branch law (may return n_b), for
// a uniform that differs per thread.
__device__ int count_below(const Spec& s, float u) {
  int n = 0;
  for (int b = 0; b < s.n_b; ++b) n += s.bcum[b] < u ? 1 : 0;
  return n;
}

// The same for a uniform shared by the warp: one ballot per 32 branches.
__device__ int pick_branch(const Spec& s, float u) {
  int n = 0;
  for (int b0 = 0; b0 < s.n_b; b0 += 32) {
    const int b = b0 + (threadIdx.x & 31);
    n += __popc(__ballot_sync(FULL, b < s.n_b && s.bcum[b] < u));
  }
  return n;
}

// visits[b, pos] with JAX's clamped gather on the branch index.
__device__ __forceinline__ int visit(const Spec& s, int b, int pos) {
  return s.visits[min(b, s.n_b - 1) * s.n_l + pos];
}

__device__ __forceinline__ void pick_min(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Butterfly (value, index) argmin: every lane gets the first minimum.
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    pick_min(v, i, v2, i2);
  }
}

template <bool kTrace>
__global__ void __launch_bounds__(32)
    sim_kernel(const int* __restrict__ isq, const float* __restrict__ svc,
               const int* __restrict__ did, const float* __restrict__ dpar,
               const float* __restrict__ bcum, const int* __restrict__ visits,
               const int* __restrict__ servers, const int* __restrict__ seeds,
               float* __restrict__ x_out, int* __restrict__ completed_out,
               int* __restrict__ events_out, float* __restrict__ tmeas_out,
               Rings rings, int n_k, int n_b, int n_l, int mpl,
               int n_requests, int warmup, int max_events) {
  extern __shared__ int sm[];
  int* ready = sm;             // (mpl) ns until done, INF_NS while waiting
  int* station = ready + mpl;  // (mpl)
  int* branch = station + mpl; // (mpl)
  int* pos = branch + mpl;     // (mpl)
  int* enq = pos + mpl;        // (mpl) enqueue sequence, BIG_SEQ if none
  int* busy = enq + mpl;       // (K) busy servers per station
  // kTrace only: (mpl, L) enter / leave stamps of each job's request, µs
  float* enter_s = reinterpret_cast<float*>(busy + n_k);
  float* leave_s = enter_s + mpl * n_l;

  const int lane_id = blockIdx.x;
  const int me = threadIdx.x;
  Spec s{isq + lane_id * n_k,     svc + lane_id * n_k,
         did + lane_id * n_k,     dpar + lane_id * n_k * 4,
         bcum + lane_id * n_b,    visits + lane_id * n_b * n_l,
         servers + lane_id * n_k, n_b, n_l};
  const uint32_t base = mix(static_cast<uint32_t>(seeds[lane_id]) + GOLDEN);

  // init: every job starts a request at its (think) first station
  for (int i = me; i < mpl; i += 32) {
    const int b = count_below(s, u01(base, i));
    const int st = visit(s, b, 0);
    ready[i] = service_ns(u01(base, mpl + i), s, st);
    station[i] = st;
    branch[i] = b;
    pos[i] = 0;
    enq[i] = BIG_SEQ;
  }
  for (int k = me; k < n_k; k += 32) busy[k] = 0;
  if constexpr (kTrace) {
    for (int i = me; i < 2 * mpl * n_l; i += 32) enter_s[i] = 0.0f;
  }
  __syncwarp();

  int seq_ctr = 0, completed = 0, warm_completed = -1, ctr = 2 * mpl,
      events = 0;
  float elapsed_us = 0.0f, warm_elapsed_us = 0.0f;
  while (completed < n_requests && events < max_events) {
    const float u_svc1 = u01(base, ctr), u_svc2 = u01(base, ctr + 1),
                u_branch = u01(base, ctr + 2);
    ctr += 3;

    int t = IMAX, j = IMAX;
    for (int i = me; i < mpl; i += 32) pick_min(t, j, ready[i], i);
    warp_argmin(t, j);
    elapsed_us = __fmaf_rn(static_cast<float>(t), static_cast<float>(1e-3), elapsed_us);
    const int k_cur = station[j];
    __syncwarp();
    for (int i = me; i < mpl; i += 32) {
      const int r = ready[i];
      ready[i] = r < INF_NS ? r - t : INF_NS;
    }
    __syncwarp();

    // hand the server job j held (if any) to its FIFO successor
    if (s.isq[k_cur]) {
      int seq = BIG_SEQ, w = IMAX;
      for (int i = me; i < mpl; i += 32) {
        const bool waiting = i != j && station[i] == k_cur && ready[i] == INF_NS;
        pick_min(seq, w, waiting ? enq[i] : BIG_SEQ, i);
      }
      warp_argmin(seq, w);
      const int svc_ns = service_ns(u_svc1, s, k_cur);
      const int busy_cur = busy[k_cur];
      __syncwarp();
      if (me == 0) {
        if (seq < BIG_SEQ) {
          ready[w] = svc_ns;
          enq[w] = BIG_SEQ;
        } else {
          busy[k_cur] = busy_cur - 1;
        }
      }
      __syncwarp();
    }

    // advance job j along its route (or complete and restart)
    const int nxt = pos[j] + 1;
    const int bj = branch[j];
    const int route_next = nxt < n_l ? visit(s, bj, nxt) : -1;
    const bool done = route_next < 0;
    const int new_branch = pick_branch(s, u_branch);
    const int k_next = done ? visit(s, new_branch, 0) : route_next;
    const int pos_j = nxt - 1;
    const int pos_next = done ? 0 : nxt;
    if constexpr (kTrace) {
      // the finished request's record, its last visit left just now
      if (done) {
        const size_t row =
            static_cast<size_t>(lane_id) * (rings.cap + 1) + completed % rings.cap;
        if (me == 0) {
          rings.req[row] = completed;
          rings.branch[row] = bj;
          rings.cls[row] =
              rings.bmiss[lane_id * s.n_b + min(bj, s.n_b - 1)] ? CLS_MISS : CLS_HIT;
          rings.nvis[row] = pos_j + 1;
          rings.parked[row] = 0.0f;
        }
        for (int v = me; v < n_l; v += 32) {
          rings.enter[row * n_l + v] = enter_s[j * n_l + v];
          rings.leave[row * n_l + v] = v == pos_j ? elapsed_us : leave_s[j * n_l + v];
        }
      }
    }
    completed += done ? 1 : 0;

    // place j at k_next
    const int svc_next = service_ns(u_svc2, s, k_next);
    const bool is_q = s.isq[k_next] != 0;
    const int busy_next = busy[k_next];
    const bool starts_now = !is_q || busy_next < s.servers[k_next];
    __syncwarp();
    if (me == 0) {
      ready[j] = starts_now ? svc_next : INF_NS;
      enq[j] = starts_now ? BIG_SEQ : seq_ctr;
      if (is_q && starts_now) busy[k_next] = busy_next + 1;
      station[j] = k_next;
      branch[j] = done ? new_branch : bj;
      pos[j] = pos_next;
      if constexpr (kTrace) {
        leave_s[j * n_l + pos_j] = elapsed_us;
        enter_s[j * n_l + pos_next] = elapsed_us;
      }
    }
    __syncwarp();
    seq_ctr += starts_now ? 0 : 1;

    // warmup bookkeeping
    if (completed >= warmup && warm_completed < 0) {
      warm_completed = completed;
      warm_elapsed_us = elapsed_us;
    }
    events += 1;
  }
  if (me == 0) {
    const float t_meas = fmaxf(elapsed_us - warm_elapsed_us, static_cast<float>(1e-6));
    x_out[lane_id] = static_cast<float>(completed - warm_completed) / t_meas;
    completed_out[lane_id] = completed;
    events_out[lane_id] = events;
    tmeas_out[lane_id] = t_meas;
    if constexpr (kTrace) rings.n_count[lane_id] = completed;  // one record each
  }
}

// 4-byte words of a lane's shared state: five (mpl) job arrays, (K) busy
// counts and, traced, the (mpl, L) enter and leave stamps.
__host__ __device__ constexpr int shared_ints(int n_k, int mpl, int n_l,
                                              bool trace) {
  return 5 * mpl + n_k + (trace ? 2 * mpl * n_l : 0);
}

template <bool kTrace>
int launch(const int* isq, const float* svc, const int* did, const float* dpar,
           const float* bcum, const int* visits, const int* servers,
           const int* seeds, float* x, int* completed, int* events,
           float* tmeas, const Rings& rings, int lanes, int n_k, int n_b,
           int n_l, int mpl, int n_requests, int warmup, int max_events,
           void* stream) {
  const int bytes = shared_ints(n_k, mpl, n_l, kTrace) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sim_kernel<kTrace>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 0) return 0;
  sim_kernel<kTrace><<<lanes, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      isq, svc, did, dpar, bcum, visits, servers, seeds, x, completed, events,
      tmeas, rings, n_k, n_b, n_l, mpl, n_requests, warmup, max_events);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int event_sim_shared_bytes(int n_k, int mpl, int n_l, int trace) {
  return shared_ints(n_k, mpl, n_l, trace != 0) * (int)sizeof(int);
}

// Launch one warp per lane on `stream`; returns the cudaError_t.
extern "C" int event_sim_launch(const int* isq, const float* svc, const int* did,
                                const float* dpar, const float* bcum,
                                const int* visits, const int* servers,
                                const int* seeds, float* x, int* completed,
                                int* events, float* tmeas, int lanes, int n_k,
                                int n_b, int n_l, int mpl, int n_requests,
                                int warmup, int max_events, void* stream) {
  return launch<false>(isq, svc, did, dpar, bcum, visits, servers, seeds, x,
                       completed, events, tmeas, Rings{}, lanes, n_k, n_b, n_l,
                       mpl, n_requests, warmup, max_events, stream);
}

// The traced kernel: as event_sim_launch, plus the (lanes, B) bmiss table
// and the rings (n_count, req, branch, cls, nvis, parked, enter, leave),
// which the caller allocates with req = -1 and cap = trace capacity.
extern "C" int event_sim_traced_launch(
    const int* isq, const float* svc, const int* did, const float* dpar,
    const float* bcum, const int* visits, const int* servers, const int* seeds,
    const int* bmiss, float* x, int* completed, int* events, float* tmeas,
    int* n_count, int* req, int* branch, int* cls, int* nvis, float* parked,
    float* enter, float* leave, int lanes, int n_k, int n_b, int n_l, int mpl,
    int n_requests, int warmup, int max_events, int cap, void* stream) {
  const Rings rings{bmiss, n_count, req, branch, cls, nvis, parked, enter,
                    leave, cap};
  return launch<true>(isq, svc, did, dpar, bcum, visits, servers, seeds, x,
                      completed, events, tmeas, rings, lanes, n_k, n_b, n_l,
                      mpl, n_requests, warmup, max_events, stream);
}
