#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  Phases, each printed with its seconds:

1. device: the card's name and power limit, and the port's provenance
   stamp (``repro_torch.obs.provenance.collect``: versions, the card);
2. build: ``nvcc`` builds every kernel under ``src/repro_torch/kernels/csrc``;
   ``cuobjdump -res-usage`` of the library reads the registers, stack and
   local memory of each of the event-sim kernel's 35 instantiations
   (closed, traced, traced for long routes, coalescing, open loop,
   counting, tiered; each must keep its registers of
   ``EVENT_SIM_REGISTERS``), of their 35 sketched twins
   (``event_sim_sketch.cu``), of the 15 traced coalescing, open-loop and
   tiered instantiations (``event_sim_traced.cu``) and their 15 sketched
   twins (``event_sim_traced_sketch.cu``) and of the sketch_trace kernel's
   11 (S register slots a thread, 1 to 16, packed and unpacked; S = 0, the
   table in device memory), none of which may use stack or local memory
   (but ``SKETCH_STACK_BEFORE``'s 16 bytes of stack, as before);
   beside the build ``nvcc -Xptxas -v`` reports the registers, stack and
   spills of the replay kernel's 14 (seven policies x two state layouts), of the
   chunked WKV kernel's nine (three type combinations x three head
   widths) and of the split-TF32 flash kernel's ten (float32 at d_head
   16, 32, 64, 80, 128, 168; bf16 at 16, 32, 80, 168); then
   ``cuobjdump --dump-sass`` of the library, in the background beside the
   checks below and read after them: the tensor-core flash
   kernel's instantiations must hold HGMMA (``wgmma``) instructions and
   every split-TF32 one HMMA (``mma.sync``);
   then the checks of 3, 4, 5, 6d, 6e, 6f, 6g, 6h, 6i and 6j, which time
   nothing, run at once in eight worker processes (``parallel_checks``),
   longest first, each check's seconds printed; 6, 6b and 6c after them;
3. replay kernel vs its plain PyTorch version on the card, bit for bit:
   every policy but LRU at the main path's lane shape (key space 4096,
   pad 3300, window 8) on a 5000-request trace that fills every size;
   the edge lanes of ``tests/test_torch_replay_cuda.py`` (capacity 0, 1,
   2, CLOCK's max_scan 0, SLRU's protected_frac 1.0, S3-FIFO's
   small_frac 1.0 and 2.0, Prob-LRU's q 0 and 1; one-key and
   all-distinct streams; pad 64) and key space 2**17, each in every
   state layout that fits (shared memory; device memory) and through the
   wrapper;
4. event-sim kernel vs its plain version on the card: a network with
   deterministic service, identical event counts; every instantiation
   (mpl 1, 24, 48, 72, 144: 1, 2, 4, 8 register slots per thread; mpl
   300: shared memory; a 41-visit route), untraced and traced, records
   included; padded
   grids of three networks of different shapes and of the LRU sweep's
   five measured networks;
5. traced event-sim kernel vs its traced plain version: the det network
   and the LRU network, 21 lanes x 2000 requests into 512-record rings
   (overflowing), decoded records field by field; the traced kernel's
   throughput, completions and events equal the untraced kernel's;
6. LRU-update kernel vs its plain version, bit for bit, at C 2048 / N 128,
   C 1000 with -1 padding and duplicates, and C 2**22 / N 4096 (timed on
   the device, with an empty batch, and per kernel);
6b. flash- and paged-attention kernels vs their plain versions within
   the reference's tolerances (2e-5 float32, 2e-2 bf16): the reference's
   FLASH_CASES, ragged bf16 cases (T = S = 100 at d_head 128 and 64),
   the full-width prefill shape (B 4, 16/8 heads, T = S = 2048, d_head
   128, causal, window 0 and 1024) in bf16 and in float32, and the head
   widths 80 and 168 in both types (ragged, windowed, bidirectional, and
   the full-width heads of qwen3-32b and gemma3-27b at 2048 tokens); every
   bf16 case at d_head 64/128 goes to the tensor-core kernel, exactly one
   launch, and is also held to mean |kernel - plain| <= 5e-3 mean |plain|
   (a dropped K/V tile goes over it where bf16's elementwise 2e-2 may not
   see it); every other case to the split-TF32 kernel, exactly one launch;
   PAGED_CASES, seq_len 0 and 1, a float32 table of 16 pages (up to four
   64-token steps), and a full-width decode batch (32 sequences x 128
   pages of 16 tokens over a 4096-page pool, ragged seq_lens) in bf16 and
   in float32;
6c. the WKV6 kernels vs their plain version (T >= 64 the chunked kernel,
   T < 64 the sequential one): the reference's WKV_CASES from a zero
   state (2e-4 float32, 2e-2 bf16, T = 100 its padding path), a random
   state in and out (y and the final state within 2e-4), one decode step
   (T = 1), the full-width prefill shape (B 2, T 2048, 64 heads of 64,
   the model's types) within 1e-4 of the largest |y| and |state|, and the
   chunked kernel's cases of ``tests/test_torch_wkv_cuda.py`` (every type
   combination and head width, ragged T up to 2047, model decays, decays
   of exactly 0 and 1 on both routes), each case's route asserted;
6d. the event-sim kernel's coalescing and open-loop instantiations vs
   their plain versions (``coalesce_vs_plain``, ``open_vs_plain``): the
   cases of ``tests/test_torch_event_sim_cuda.py`` (1 to 64 flows,
   uniform and Zipf(0.99), one and two disk ranks, every register-slot
   count and shared memory; pools of 4 to 300 slots, with and without
   bursts), every output identical on deterministic service;
6e. ``cluster_vs_plain``: the counting instantiation (the closed loop
   with per-branch completion counts) against its plain version and the
   closed kernel (``COUNT_CASES``: every register-slot count and shared
   memory; its events the closed kernel's), and lanes of the sharded
   cluster's composed networks (``CLUSTER_CASES``: 4 shards at mpl 48, 8
   shards at the default mpl 576) through the counting and coalescing
   instantiations, per-branch counts included: integers identical, the
   rest within 1e-6;
6f. ``tiers_vs_plain``: the tiered instantiation (cross-tier leader tables,
   cascading fills) against its plain version on lanes of composed
   hierarchies (``TIERS_CASES``: tests/test_hierarchy.py's 2 x 2 at mpl 16
   to 300, every register-slot count and shared memory, F 2 to 8, uniform
   and Zipf flows, p up to 0.8393; fig_hierarchy's 3 x 2 at mpl 96, F 4;
   one job refilling the entry it fills): integers identical, and every
   output on deterministic service;
6g. ``tiers_long_vs_plain``: the same on fig_hierarchy's network with
   deterministic service at fig_hierarchy's 8 000 requests, 3 p x 2
   seeds: every output identical;
6h. ``sketch_vs_plain``, ``sketch_ext_vs_plain`` and
   ``sketch_tiers_vs_plain``: the sketched instantiations (the streaming
   estimators in the launch) against their plain versions
   (``SKETCH_CASES``: closed, traced closed with a route over 32 visits,
   counting at 32 and 34 branches, windows that wrap the ring; then
   coalescing and open loop with bursts; then tiered; register slots and
   shared memory; caps up to 32 and past it; deterministic service):
   every field of the sketch state identical, the EWMAs bit for bit, and
   every simulation output identical to the unsketched kernel's;
6i. ``sketch_trace_vs_plain``: the sketch_trace kernel against its plain
   version on the card and the exact twin ``sketch_trace_py`` on
   fig_drift A's stream (24 000 keys over 512, theta 0.9, sketch_cap 96):
   the state identical, every windowed counter the twin's; and
   ``sketch_trace_bc_vs_plain``, the same at the other shapes fig_drift
   launches it at: B's seed-1 stream at sketch_cap 256 (8 SpaceSaving
   slots per thread) and C's two 12 000-key phases at 512 (16 slots; one
   two-lane launch) and its second phase at 256;
6j. ``trace_ext_vs_plain``: the traced coalescing, open-loop and tiered
   instantiations against their traced plain versions
   (``TRACE_EXT_CASES`` of ``tests/test_torch_event_sim_cuda.py``: every
   register-slot count and shared memory in each mode, routes of 34 and
   41 visits, rings that overflow and that do not, bursts, dropped
   arrivals; the tiered cases in ``trace_ext_tiers_vs_plain``) and, in
   ``trace_ext_fig_vs_plain``, the figures' networks
   (fig_delayed_hits B, fig_latency B's open loop and C's coalescing one,
   fig_hierarchy's network, fig_cluster C's 8 shards): records identical
   in req, branch, cls and nvis, the stamps on deterministic service;
   every other output the untraced kernel's, with the sketch off and on;
7. the main path at the benchmarks' sizes (``benchmarks/fig3_lru.py``):
   closed-loop simulations of the LRU network at three disk speeds and
   replay sweeps of every policy, with the LRU inversion and FIFO's
   monotone curve asserted, through the kernels (the event-sim kernel
   exactly 4 + 7 times, one launch per sweep; the replay kernel 7
   times), every throughput within 1e-6 of what the earlier event-sim
   kernel computed (``MAIN_PATH_X``) and every sweep's p_hit exactly the
   earlier replay kernel's hit counts (``MAIN_PATH_HITS``);
8. the traced path: the LRU network at 100 us over P_GRID x 3 seeds x 16k
   requests with lossless 16384-record rings, its records reconciled with
   the throughput, per-station utilization printed, one lane written as a
   Perfetto trace and read back (traced launch count > 0); then
   ``trace=K`` through the entry points at the figures' widths with
   lossless rings: ``simulate_network`` with coalescing (fig_delayed_hits
   B) and in the open loop (fig_latency B, C's coalescing, fig_cluster E's
   bursts), ``simulate_hierarchy`` (fig_hierarchy's tiered network) and
   ``simulate_cluster`` (fig_cluster C): the decoded records give one
   record per completion, per-branch counts equal to an untraced launch's
   and delayed records to its delayed hits (the open loop: each record's
   class the class buffer's), parked time only on delayed records, every
   visit left after it is entered, one lane of each through Perfetto and
   back, and rebuild the result's throughput, per-branch, per-level or
   per-shard rates and delayed fractions (the open loop: its class
   fractions and mean sojourn); the traced launch count > 0;
8b. the delayed-hits and latency path (``figures_path``): every
   assertion of ``benchmarks/table2_classify.py``, ``fig_delayed_hits.py``
   (the analytic p* shift, the simulated recovery on a bounded disk, the
   measured sweep's sigma and coalesced bound) and ``fig_latency.py`` (the
   analytic inversion, the open loop against Erlang-C, per-class
   sojourns under coalescing, the SLO optimum), ``fig_cluster.py``
   (routing imbalance, the cluster p* below the single node's, the
   simulated 8-shard cluster against the key-routing oracle, routed and
   rebalanced stability boundaries, bursts) and ``fig_hierarchy.py`` (the
   Che tier profile, the LRU-client inversion at the tier-aware p*, FIFO
   monotone, the MVA forecast, the tiered kernel against the oracle over
   16 seeds a side, starvation, the
   convoy effect and sigma1) and ``fig_drift.py`` (the sketch_trace
   kernel against the exact twin, the online profile sizing p*, drift
   detection after a popularity churn, the residual monitor and the
   burst detector on the sketched closed and open loops, D over
   FD_SEEDS simulation seeds) through the port at the benchmarks' sizes,
   each figure's and section's wall time printed; the coalescing,
   open-loop, tiered, sketched and sketch_trace kernels' launches are
   counted here; the
   delayed-hits sweep classifies every size in one pass, held bit for bit
   to each size classified alone;
8c. the hierarchy path (``hierarchy_differential``): tests/test_hierarchy.py's
   tiered simulations (twins, levels, sigma1) and tests/test_properties.py's
   tiered twins, with the case the reference fails there (p 0.8393), each
   the kernel against the port's oracle in those tests' bands (the twins
   over 8 seeds a side); the tiered
   kernel's launches are counted over this phase and fig_hierarchy;
8d. the cluster path (``cluster_differential``): ``tests/test_cluster.py``'s
   simulations through the port, the 12-case matrix (LRU, FIFO, CLOCK x
   Zipf 0 and 1 x 1 and 4 shards) and the 16-shard cases, each the kernel
   against the port's key-routing oracle within that file's bands, the
   analytic bound over an uncoalesced run, shard-local coalescing and the
   open-loop mixture; the counting kernel's launches are counted here;
9. the batched-LRU path: 64 Zipf batches of 4096 ids through
   ``ops.lru_batch_update`` on a 2**22-slot recency table, held against
   each slot's last access (launch count > 0);
9b. the model wing on full-width internlm2-1.8b (random weights, seed
   0): the prefill path (``forward`` with the flash kernel vs
   ``chunked_attention`` on 2 x 2048 tokens, in bf16 and float32; 24
   flash launches per forward, on the tensor-core kernel in bf16 and the
   split-TF32 kernel in float32; in float32 the logits agree within 1e-4
   of their scale and the next token at >= 99% of positions), the serve path (the ``Engine`` on
   ``launch/serve.py``'s stream: bf16 timed with its ``forecast_network``;
   float32 tokens equal with and without the prefix cache, ``stats()``
   equal to a model-free controller replay) and the paged kernel on every
   layer of the engine's page pool, against its plain version and dense
   attention over ``gather_pages`` (paged launch count > 0);
9c. the rwkv6 family on full-width rwkv6-7b (random weights, seed 0;
   the internlm2 models freed first, peak device memory printed after
   each phase): the prefill path (a timed bf16 ``forward`` on 2 x 2048
   tokens, 32 WKV launches per forward, all on the chunked kernel; in
   float32 on 1 x 256 tokens the
   logits through the kernel within 1e-4 of their scale of the same
   forward with ``_wkv_scan`` patched to the plain version, and of a
   240-token prefill followed by 16 ``decode_step``s) and the serve path
   (the ``Engine`` in bf16 on ``launch/serve.py``'s stream, timed per
   decode step and per admission, ``stats()`` equal to a model-free
   replay of the state-mode controller, and the hits that restored a
   snapshot holding another prompt's tail counted and held to the
   replay's count: the reference fault of ROADMAP queue 3; in float32 on
   whole-prefix prompts, whose hits are sound, tokens identical with the
   prefix cache on and off) (WKV launch count > 0);
10. the main path again under ``torch.profiler``: device time by kernel
   and the device's busy share;
11. full size: per-launch kernel times (CUDA events) at the main path's
   shapes, beside their plain versions' times and the work's bound; the
   plain versions' outputs are held against the kernels' (every policy's
   replay launch of 5 x 60k requests against py_ref, request by request,
   and its classes against ``classify_inflight``; each launch's chain
   bound, the dependent loads of its longest lane as ``py_ref`` replays
   it (one per request, one per hit that relinks, one per scan step)
   times one dependent shared-memory load, measured by a pointer chase
   (``CHASE_SRC``); LRU's also bit for bit against the
   plain version and the Mattson sweep; one
   measured-network lane at 16k requests with identical event counts;
   the LRU network's 21 lanes x 16k requests, untraced and traced with
   lossless 16384-record rings, against one run of the traced plain
   version, records field by field (the three plain runs side by side in
   worker processes, after the kernels are timed); the event-sim launch of one sweep,
   five measured networks x 16k requests, bit for bit its networks
   launched alone; ns per event of the 1-, 5- and 21-lane and traced
   launches); the attention kernels at their
   full-width shapes beside their plain versions, their bounds and
   ``F.scaled_dot_product_attention`` (a yardstick only; in the inputs'
   type; over K/V gathered beforehand for the paged kernel), the flash
   kernels each in its type (the tensor-core kernel in bf16, the
   split-TF32 kernel in float32, bound by its three products per product
   at the TF32 rate, the float32-unit rate's figure kept beside it) with
   and without the window, with the achieved TFLOP/s and the share of the
   bound; the WKV kernels at the
   prefill shape (the chunked kernel, and the sequential one on the same
   inputs) and the engine's decode step (B 4, T 1, the sequential kernel)
   beside their plain version and their bound (no library call computes
   WKV6); the chunked kernel must be the faster at the prefill shape;
12. the coalescing and open-loop instantiations timed on one lane of the
   figures' networks beside their plain versions (``ext_timing``), and
   the figures' own launches; the counting instantiation on one lane of
   fig_cluster C's 8-shard network, beside the closed and coalescing
   kernels on the same lane (ns per event at 8 shards); the tiered
   instantiation on one lane of fig_hierarchy's network (mpl 96, F 4),
   beside the closed, counting and coalescing kernels on the same lane;
   each mode's lane again with the sketch (ns per event on and off), and
   the coalescing, open-loop, tiered and 8-shard coalescing lanes traced
   into lossless rings (ns per event traced and not; the traced
   coalescing lane is the kernels line's ``event_sim_traced_ext``, held
   against its traced plain version, timed alone); the sketched closed
   kernel on fig_drift D's lane (its bound the chain of each event's
   warp collectives, ``CLOSED_CHAIN``, at the latencies of
   ``CHASE_SRC``'s ``redux_chain`` and ``shfl_chain``; the unsketched
   closed kernel's share of it beside)
   and the sketch_trace kernel on fig_drift A's stream beside their plain
   versions; the sketch_trace kernel at each of fig_drift's caps (96, 256,
   512: S 4, 8, 16) in turns with its S = 0 instantiation on the same
   inputs, held equal to it, in ns per key, beside its chain bound: one
   warp reduction a key, at the latency of ``REDUX_STEPS`` dependent
   ``redux.sync`` minima (``CHASE_SRC``'s ``redux_chain``, clock64 and
   CUDA events), which is its ``bound_ms``.

The line before the last two is the JSON ``kernels`` record; then the
card's name and power limit; the last line is the JSON result.  The
phases' total seconds are printed before them.  Details
go to ``chiprun_out/chip_smoke.json``.  Any failure raises: the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
P_GRID = (0.4, 0.55, 0.7, 0.8, 0.9, 0.95, 0.99)
DISKS = (500.0, 100.0, 5.0)
IMPL_CAPS = (96, 384, 1024, 2048, 3300)
POLICY_PARAMS = {
    "lru": {},
    "fifo": {},
    "prob_lru": {"q": 0.5},
    "clock": {"max_scan": 3},
    "slru": {"protected_frac": 0.5},
    "s3fifo": {"small_frac": 0.1, "max_scan": 3},
    "sieve": {},
}
# kernel and plain version draw the same uniforms through the same float32
# formulas: the same trajectory, throughput equal up to summation order
SIM_RTOL = 1e-6
CHECK_T, CHECK_FILL = 5000, 3400  # the replay check's trace and its fill
# the lane's state in device memory: key space 2**17, a short stream
REPLAY_BIG_KEYS, REPLAY_BIG_T = 1 << 17, 600
# the replay bound's unit: one thread follows next[] over a random cycle
# of CHASE_N ints for CHASE_STEPS dependent loads, timed by clock64; the
# sketch_trace bound's: REDUX_STEPS dependent warp reductions (the event
# sim's: those and as many dependent shuffles)
CHASE_N, CHASE_STEPS = 1024, 1 << 20
REDUX_STEPS = 1 << 20
# the warp collectives on one closed-loop event's dependent chain
# (csrc/event_sim.cuh): the argmin's two reductions (t, then the lowest j
# holding it), the owner's shuffles of j's station and next station (in
# parallel), then the successor's and the busy count's reductions (in
# parallel); the sketched closed instantiations add none to it (the
# shuffle of j's branch and the RED to its row feed no later event)
CLOSED_CHAIN = {"redux": 3, "shfl": 1}
# ext_timing's sketch rows: the modes whose sketch is logged and replayed
# every 32 events (csrc/sketch.cuh SimLane); the others keep it in place
SKETCH_DESIGN = {m: "logged, replayed every 32 events"
                 for m in ("coalescing", "open loop", "tiered")}
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* __restrict__ next, int n, int steps,
                      int shared, long long* cycles, int* sink) {
  extern __shared__ int s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = next[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int* p = shared ? s : next;
  int j = 0;
  for (int k = 0; k < n; ++k) j = p[j];  // one lap to warm L1
  const long long t0 = clock64();
  for (int k = 0; k < steps; ++k) j = p[j];
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *sink = j;
}
extern "C" int chase_launch(const int* next, int n, int steps, int shared,
                            long long* cycles, int* sink, void* stream) {
  chase<<<1, 32, n * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      next, n, steps, shared, cycles, sink);
  return (int)cudaGetLastError();
}
// the sketch_trace bound's unit: one warp's chain of redux.sync minima,
// each fed by the last (and one add)
__global__ void redux_chain(int steps, long long* cycles, unsigned* sink) {
  unsigned v = __reduce_min_sync(0xffffffffu, threadIdx.x);
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) v = __reduce_min_sync(0xffffffffu, v + threadIdx.x);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    *cycles = t1 - t0;
    *sink = v;
  }
}
extern "C" int redux_launch(int steps, long long* cycles, unsigned* sink,
                            void* stream) {
  redux_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(steps, cycles, sink);
  return (int)cudaGetLastError();
}
// the event sim's owner shuffle: one warp's chain of __shfl_sync, each
// reading the lane the last one's value names (and one add)
__global__ void shfl_chain(int steps, long long* cycles, unsigned* sink) {
  int v = threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) v = __shfl_sync(0xffffffffu, v + 1, v & 31);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    *cycles = t1 - t0;
    *sink = v;
  }
}
extern "C" int shfl_launch(int steps, long long* cycles, unsigned* sink,
                           void* stream) {
  shfl_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(steps, cycles, sink);
  return (int)cudaGetLastError();
}
"""
# the main path's hits over the 45 000 measured requests of each size
# (IMPL_CAPS), as commit 76fa561's replay kernel counted them on an NVIDIA
# H100 80GB HBM3 at 700.00 W: replay is exact, so each sweep's p_hit must
# be these counts over 45 000
MAIN_PATH_MEASURED = 45_000
MAIN_PATH_HITS = {
    "lru": (19288, 28007, 34716, 39763, 43129),
    "fifo": (17016, 25755, 32783, 38384, 42478),
    "prob_lru": (18515, 27337, 34241, 39437, 43093),
    "clock": (19915, 28486, 34972, 39751, 42913),
    "slru": (22231, 29765, 35631, 40085, 43139),
    "s3fifo": (23453, 30563, 35773, 39787, 42002),
    "sieve": (24889, 31250, 36347, 40320, 43162),
}
SIM_REQUESTS, SEEDS = 16_000, (0, 1, 2)
# one mpl per instantiation of the event-sim kernel: job state in 1, 2, 4
# and 8 register slots per thread (mpl <= 32, 64, 128, 256), then in
# shared memory; each held against the plain version at SIM_MPL_REQUESTS
SIM_MPLS = (1, 24, 48, 72, 144, 300)
SIM_MPL_REQUESTS = 500
# coalesce_vs_plain / open_vs_plain: requests per lane of each case of
# tests/test_torch_event_sim_cuda.py's COALESCE_CASES / OPEN_CASES
CO_REQUESTS, OPEN_REQUESTS = 300, 200
# the figures path: benchmarks/common.py's N_SIM_REQUESTS and the sizes of
# benchmarks/table2_classify.py, fig_delayed_hits.py and fig_latency.py
FIG_REQUESTS = 16_000
T2_REQUESTS, T2_KEYS, T2_CAPACITY = 20_000, 2048, 256
DH_FLOWS, DH_DISK_US, DH_IO_DEPTH = (8, 64), 100.0, 8
DH_P_SIM = (0.5, 0.8, 0.95)
DH_SWEEP_CAPS = (96, 384, 1024, 2048)
DH_REQUESTS = 40_000  # the measured sweep's requests
LAT_DISK_US, LAT_DISK_US_SIM = 100.0, 5.0
LAT_LOAD_FRAC, LAT_SIM_LOAD, LAT_SLO_US = 0.85, 0.838, 250.0
LAT_P_SIM = (0.70, 0.90, 0.98)
LAT_CO_IO_DEPTH, LAT_CO_LAMBDA, LAT_CO_FLOWS = 8, 0.12, 16
# the coalescing and open-loop rows: one lane of the figures' networks,
# short enough to time the plain version too
EXT_TIMING_REQUESTS = 1_500
# cluster_vs_plain: requests per lane of COUNT_CASES / CLUSTER_CASES of
# tests/test_torch_event_sim_cuda.py (at least; a cluster lane runs enough
# for two measured completions per job)
CLUSTER_PLAIN_REQUESTS = 300
# benchmarks/fig_cluster.py's sizes: key spaces of the analytic sections
# and of the simulated ones, the headline skew and shard count, the
# simulated global p_hits and the SLO
CL_KEYS, CL_SIM_KEYS, CL_THETA, CL_SHARDS = 4096, 1024, 1.0, 8
CL_SIM_P = (0.45, 0.6, 0.75)
CL_PSTAR_GRID, CL_SLO_US = 4001, 250.0
# tests/test_cluster.py's differential: the global operating point, the
# simulated and the oracle's requests (4 and 1 shards; 16 shards)
CL_P_OP = 0.6
CL_DIFF_REQUESTS = {1: (9_000, 7_000), 4: (9_000, 7_000), 16: (12_000, 9_000)}
# the oracle's seeds there: the reference's test runs seed 3 alone, whose
# throughput at 7k requests is the highest of seeds 3-18 on 4 shards
# (LRU, theta 1: 1.2635 against their mean 1.1653, sd 0.0634, by
# tools/cluster_long_run.py); the mean of four seeds, as fig_cluster C
# takes the mean of two
CL_ORACLE_SEEDS = (3, 4, 5, 6)
# the long-run check of that case (LRU, theta 1, 4 shards, mpl 48, 8
# flows): the kernel on seeds 0..15 and the oracle on seeds 3..18, each at
# 40k requests, whose mean throughputs must lie within CL_LONG_SE
# standard errors of their difference, the errors from this run's spread
CL_LONG_REQUESTS, CL_LONG_SEEDS, CL_LONG_SE = 40_000, 16, 4.0
# tiers_vs_plain: requests per lane of TIERS_CASES of
# tests/test_torch_event_sim_cuda.py (at least; two measured completions
# per job)
TIERS_PLAIN_REQUESTS = 300
# tiers_long_vs_plain: fig_hierarchy's network (3 x 2, mpl 96, F 4) with
# deterministic service at fig_hierarchy's HI_REQUESTS, p x seeds (0, 1)
TIERS_LONG_CASE = ("fig-det-mpl96-F4-long", "fig", 96, 4, 0.0,
                   (0.3, 0.55, 0.8), True)
# benchmarks/fig_hierarchy.py's sizes: key space, skew, clients, shards,
# mpl, origin, the per-client L1 capacities, the per-shard L2 capacity,
# the grid, its stated tolerances and its requests (max(8 000,
# N_SIM_REQUESTS // 2))
HI_KEYS, HI_THETA, HI_CLIENTS, HI_SHARDS = 256, 0.8, 3, 2
HI_MPL, HI_DISK_US, HI_L2_CAP, HI_GRID_N = 96, 100.0, 32, 9
HI_L1_CAPS = (4, 8, 16, 32, 64, 96, 128, 176, 224)
HI_FORECAST_TOL, HI_TWIN_TOL, HI_SIGMA_TOL = 0.10, 0.10, 0.25
HI_REQUESTS = max(8_000, FIG_REQUESTS // 2)
# fig_hierarchy C compares 2 simulated seeds with one oracle run of 4 000
# requests (seed 3), whose throughput scatters by 15% (sd over oracle
# seeds 3-34 at p 0.51; 12% at p 0.29; tools/tiered_twins.py): at that
# draw the reference's own JAX simulator misses the 10% tolerance too
# (by 24.8% and 26.8%), and so does the tiered kernel (tools/tiered_twins.py
# --script-draw); so C holds the means of HI_TWIN_SEEDS seeds a side, both
# at HI_REQUESTS, to the script's tolerances
HI_TWIN_SEEDS = 16
# tests/test_hierarchy.py's model and run lengths (simulator, oracle),
# and tests/test_properties.py's tiered twins (p, flows, seed; 10 000
# requests a side) with the case the reference itself fails
HD_MODEL = dict(n_clients=2, n_shards=2, mpl=16, disk_us=50.0)
HD_REQUESTS = (8_000, 4_000)
HD_TWIN_CASES = ((0.2, 2, 0), (0.5, 4, 1), (0.8, 2, 2))
HD_REFERENCE_FAILS = (0.8393, 2, 0)
HD_TWIN_REQUESTS = 10_000
# the twins' throughput scatters by 7% over oracle seeds (p 0.8393: sd
# 0.124 on a mean of 1.849, seeds 0-15; tools/tiered_twins.py), and the
# oracle, which draws the LRU head's bounded-Pareto service at its mean,
# sits 7-9% above both simulators there; so each case holds the means of
# HD_TWIN_SEEDS seeds a side (the kernel on seeds seed .. seed + 7, the
# oracle on the same) to the bands (the test's own draw:
# tools/tiered_twins.py --seeds 2 --first-seed seed)
HD_TWIN_SEEDS = 8
# sketch_vs_plain: requests per lane of SKETCH_CASES of
# tests/test_torch_event_sim_cuda.py (at least; two measured completions per
# job), as the other *_vs_plain checks run their lanes
SKETCH_PLAIN_REQUESTS = 300
# benchmarks/fig_drift.py's sizes: key space, skew, A's sketch_cap, the
# stream, the windows (one event per us), D's hit ratios and run lengths
FD_KEYS, FD_THETA, FD_CAP = 512, 0.9, 96
FD_STREAM, FD_WINDOW_US = 24_000, 500.0
FD_CAPS = (FD_CAP, 256, 512)  # every sketch_cap fig_drift launches at
FD_P = (0.55, 0.85)
FD_CLOSED_REQUESTS, FD_OPEN_REQUESTS = 48_000, 24_000
# fig_drift D draws its windows from the counter engine, whose numbers are
# not the reference's: D is held on these simulation seeds (the script's
# own, seed 0, first), every one of them
FD_SEEDS = (0, 1, 2, 3)
# event_sim_ptxas: the registers of event_sim.cu's 35 instantiations as
# ptxas assigned them for commit 38b57a4 (sm_90a, the library's flags);
# the sketched and the traced coalescing, open-loop and tiered
# instantiations live in sources of their own, and these must keep their
# registers
# the sketch_trace kernel's register-table ladder and its two forms
# (repro_torch.kernels.sketch.REG_SLOTS; packed: one reduction per key)
SKETCH_SLOTS = (1, 2, 4, 8, 16)
SKETCH_FORMS = ("unpacked", "packed")
EVENT_SIM_REGISTERS = {
    "coalescing": (79, 71, 87, 96, 121), "counting": (64, 64, 64, 76, 92),
    "open loop": (83, 70, 79, 87, 128), "tiered": (71, 83, 93, 109, 157),
    "traced": (61, 57, 60, 75, 94),
    "traced, routes over 32": (64, 64, 64, 80, 96),
    "untraced": (55, 53, 57, 67, 90)}  # R = 0, 1, 2, 4, 8
# the main path's throughputs (requests/us) as the event-sim kernel of
# commit ca3464b (one lane per network, state in shared memory) computed
# them on an NVIDIA H100 80GB HBM3 at 700.00 W: same arithmetic, so the
# main path must reproduce them within MAIN_PATH_RTOL, in 4 + 7 launches
MAIN_PATH_RTOL = 1e-6
MAIN_PATH_X = {
    "lru_sim": {
        500.0: (0.23702841997146606, 0.3221535384654999, 0.47104570269584656,
                0.7106621265411377, 1.3710523843765259, 1.5042190551757812,
                1.441320538520813),
        100.0: (1.1584261655807495, 1.466878056526184, 1.6921591758728027,
                1.6999592781066895, 1.5879443883895874, 1.5041462182998657,
                1.4430533647537231),
        5.0: (1.6957483291625977, 1.7005447149276733, 1.6945351362228394,
              1.6976357698440552, 1.5864628553390503, 1.5031343698501587,
              1.4422270059585571)},
    "fifo_sim": (1.1579383611679077, 1.5346721410751343, 2.2957522869110107,
                 3.4617087841033936, 6.6226887702941895, 13.283462524414062,
                 48.59218215942383),
    "x_sim": {
        "lru": (1.2112109661102295, 1.6209553480148315, 1.6842859983444214,
                1.6107646226882935, 1.4908363819122314),
        "fifo": (1.1151018142700195, 1.6440073251724243, 2.617198944091797,
                 4.46701192855835, 12.007936477661133),
        "prob_lru": (1.1806840896606445, 1.6974366903305054,
                     2.4617855548858643, 2.73734712600708, 2.6348981857299805),
        "clock": (1.2241626977920532, 1.8556195497512817, 3.0517842769622803,
                  5.368767261505127, 13.322370529174805),
        "slru": (1.3035715818405151, 1.6015921831130981, 1.5784549713134766,
                 1.5474536418914795, 1.4871746301651),
        "s3fifo": (1.4673336744308472, 2.1419577598571777, 3.2636497020721436,
                   5.623368740081787, 9.954373359680176),
        "sieve": (1.5244017839431763, 2.337858200073242, 3.736071825027466,
                  6.663162708282471, 16.229402542114258)},
}
TRACE_CHECK_REQUESTS, TRACE_CHECK_CAP = 2000, 512  # overflowing rings
# trace_ext_vs_plain: requests per lane of TRACE_EXT_CASES of
# tests/test_torch_event_sim_cuda.py (at least one measured completion per
# job; the routes over 32 visits run their cases' own count)
TRACE_EXT_REQUESTS = 300
TRACE_FULL = 16_384  # lossless at SIM_REQUESTS
# the traced entry points' results rebuilt from their records (traced_path)
TRACE_RECONCILE_RTOL = 1e-5
# ... but the open loop's mean sojourn: the result's sojourns are float32
# sums of the time steps a request lived through (the reference's ages), the
# records' differences of two clock stamps, so the two part by the sums'
# rounding, up to 2**-24 of the sojourn per step, over hundreds of steps
OPEN_SOJOURN_RTOL = 1e-3
# the kernels' checks against their plain versions that time nothing run
# at once, in CHECK_WORKERS processes of their own (each its own CUDA
# context), longest first: the plain versions are bound by the host's
# launches, so the processes overlap on one card (one for each of the
# machine's eight cores: sixteen checks)
CHECK_WORKERS = 8
# (C, N, padded with -1 and duplicated ids) of the LRU-update check
LRU_SHAPES = ((2048, 128, False), (1000, 96, True), (1 << 22, 4096, False))
LRU_PATH = (1 << 22, 4096, 64)  # slots, ids per batch, batches
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
TF32_TENSOR_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
# tests/test_kernels.py's FLASH_CASES, then the full-width prefill shape
# (internlm2-1.8b: B 4, 16 query heads, 8 KV heads, T = S = 2048, d_head 128)
# without and with a 1024-token window
FLASH_CASES = (
    # (B, T, S, H, KV, dh, causal, window, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, "float32"),
    (2, 256, 256, 4, 2, 64, True, 0, "float32"),
    (1, 128, 128, 8, 2, 128, True, 0, "bfloat16"),
    (1, 256, 256, 4, 4, 64, True, 128, "float32"),
    (2, 64, 192, 4, 2, 64, False, 0, "float32"),
    (1, 100, 100, 2, 2, 64, True, 0, "float32"),
)
# ragged bf16 cases for the tensor-core kernel at both its head widths
FLASH_RAGGED_BF16 = ((1, 100, 100, 2, 2, 128, True, 0, "bfloat16"),
                     (1, 100, 100, 2, 2, 64, True, 0, "bfloat16"))
FLASH_FULL = ((4, 2048, 2048, 16, 8, 128, True, 0, "bfloat16"),
              (4, 2048, 2048, 16, 8, 128, True, 1024, "bfloat16"))
# the same shapes in float32, held at 2e-5: at 2048 keys an output is about
# 0.04, so bf16's 2e-2 could not see a dropped or mis-staged K/V tile
FLASH_FULL_F32 = tuple(c[:8] + ("float32",) for c in FLASH_FULL)
# the split-TF32 kernel's head widths 80 and 168 (32-column K/V tiles) in
# both types: ragged, a window that masks whole tiles, bidirectional with
# GQA 8, and the full-width heads of qwen3-32b (64 / 8 heads of 80) and
# gemma3-27b (32 / 16 heads of 168) at 2048 tokens
FLASH_WIDE = (
    (1, 300, 300, 4, 2, 80, True, 0, "float32"),
    (1, 300, 300, 4, 2, 168, True, 0, "float32"),
    (1, 300, 300, 4, 2, 80, True, 0, "bfloat16"),
    (1, 300, 300, 4, 2, 168, True, 0, "bfloat16"),
    (1, 600, 600, 4, 1, 168, True, 100, "float32"),
    (2, 64, 200, 8, 1, 80, False, 0, "bfloat16"),
    (1, 2048, 2048, 64, 8, 80, True, 0, "float32"),
    (1, 2048, 2048, 32, 16, 168, True, 0, "float32"),
)
# tests/test_kernels.py's PAGED_CASES (random seq_lens), then seq_len 0 and
# 1, then a full-width decode batch: 32 sequences of 128 pages of 16 tokens
# over a 4096-page pool (268 MB of K/V), ragged seq_lens
PAGED_CASES = (
    # (B, H, KV, dh, page, n_pages, P, dtype, seq_lens)
    (2, 4, 2, 64, 16, 4, 16, "float32", None),
    (3, 8, 8, 64, 32, 3, 12, "float32", None),
    (2, 4, 4, 128, 16, 2, 8, "bfloat16", None),
    (2, 4, 2, 64, 16, 4, 16, "float32", (0, 0)),
    (2, 4, 4, 128, 16, 2, 8, "bfloat16", (1, 1)),
    # 4, 3 and (seq_len 0) 4 steps of 64 tokens: the double-buffered
    # step buffers are reused from the third step on
    (3, 4, 2, 64, 16, 16, 64, "float32", (256, 131, 0)),
)
PAGED_FULL = (32, 16, 8, 128, 16, 128, 4096, "bfloat16", "ragged")
PAGED_FULL_F32 = PAGED_FULL[:7] + ("float32", "ragged")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py::_tol
# mean |kernel - plain| <= FLASH_MEAN_REL mean |plain| for every bf16 flash
# case, where the elementwise 2e-2 cannot see a dropped or mis-staged K/V
# tile: the tensor-core kernel's rounding of p to bf16 stays under half of
# it, one dropped K/V tile of either kernel goes over twice it
# (tests/test_torch_attention.py, on the CPU)
FLASH_MEAN_REL = 5e-3
ARCH = "internlm2-1.8b"
PREFILL_SHAPE = (2, 2048)  # sequences x tokens of the prefill path
# launch/serve.py's engine and stream, on the full-width model
SERVE = dict(max_seqs=4, max_seq_len=256, page_size=8, n_pages=128,
             prefix_capacity=64, policy="lru", max_new_tokens=8)
SERVE_STREAM = dict(n_requests=24, n_prefixes=4, prefix_len=24, seed=0,
                    new_tokens=6)
# the rwkv6 family: tests/test_kernels.py's WKV_CASES from a zero state,
# then the kernel with a random state in and out (the model path's types
# among them), one decode step, and the full-width prefill shape of
# rwkv6-7b (B 2, T 2048, 64 heads of 64) in the model's types
WKV_CASES = (
    # (B, T, H, dh, chunk, dtype)
    (2, 128, 2, 32, 32, "float32"),
    (1, 256, 4, 64, 128, "float32"),
    (1, 100, 2, 32, 32, "float32"),  # the reference's padding path
    (2, 64, 2, 64, 64, "bfloat16"),
)
WKV_STATE_CASES = (
    # (B, T, H, dh, r/k/v dtype, w dtype); y and w float32 unless bf16 ops
    (2, 48, 2, 16, "float32", "float32"),
    (1, 100, 4, 32, "float32", "float32"),
    (2, 70, 4, 64, "bfloat16", "float32"),
    (4, 1, 64, 64, "bfloat16", "float32"),  # the engine's decode step
    (3, 1, 2, 32, "float32", "float32"),
)
WKV_FULL = (2, 2048, 64, 64)  # the prefill path's shape, bf16 r/k/v, f32 w/y
WKV_DECODE = (4, 1, 64, 64)   # the engine's decode step: 4 slots
WKV_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py
RWKV_ARCH = "rwkv6-7b"
RWKV_CHECK_T, RWKV_SPLIT = 256, 240  # float32 checks: 240 prefilled + 16 steps


class Phases:
    """Prints each phase's wall seconds on its own line."""

    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {self.seconds[name]:.3f} s", flush=True)
        return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``, back to back: a sleep kernel holds
    the stream until the host has queued every call, so the host's cost
    per call (Python, allocation, launch) is hidden, as it is when calls
    are queued ahead of the card.  Raises if the host could not queue the
    calls within the longest sleep (a call that synchronises)."""
    import torch

    fn()
    for cycles in (1 << 23, 1 << 25, 1 << 27):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card had not reached the first call
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
    raise RuntimeError("device_ms: the host did not queue the calls ahead of "
                       "the card")


def start_sass():
    """``cuobjdump --dump-sass`` of the built library, started in the
    background (it takes tens of seconds on the host) into a file beside
    the build; :func:`sass_counts` reads it."""
    import shutil
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    path = _build.BUILD_DIR / "library.sass"
    with open(path, "w") as f:
        return subprocess.Popen([tool, "--dump-sass",
                                 str(_build.build_library())], stdout=f), path


# sass_counts: the event-sim instantiations whose warp collectives and
# atomics are counted, by (kTrace, R, kMode, sketched): fig_drift D's lane,
# the closed loop at R = 4, without the sketch and with it (in place); the
# coalescing one at R = 4 with the sketch (logged)
SIM_SASS = {(0, 4, 0, False): "closed R=4",
            (0, 4, 0, True): "sketched closed R=4",
            (0, 4, 1, True): "sketched coalescing R=4"}
SIM_OPS = ("REDUX", "SHFL", "VOTE", "RED", "ATOM", "ATOMS", "ATOMG")


def sim_sass_name(mangled: str):
    """``SIM_SASS``'s name of a mangled event-sim instantiation, or None."""
    import re

    k = re.search(r"sim_kernelILi([012])ELi(\d+)ELi([01234])E", mangled)
    if not k:
        return None
    return SIM_SASS.get((*map(int, k.groups()), "Sketched" in mangled))


def sass_counts(started, rec):
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of each
    flash kernel instantiation, from the ``cuobjdump --dump-sass`` that
    :func:`start_sass` started; raises unless every tensor-core
    instantiation holds HGMMA and each of the split-TF32 kernel's ten holds
    HMMA.  Also the warp collectives and atomics (``SIM_OPS``, static
    counts: the whole kernel, the loop among it) of ``SIM_SASS``'s
    event-sim instantiations."""
    import re

    proc, path = started
    if proc.wait() != 0:
        raise RuntimeError(f"cuobjdump --dump-sass failed ({proc.returncode})")
    sass = path.read_text()
    counts, fn, sim, sim_fn = {}, None, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "flash" in m.group(1) else None
            if fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            sim_fn = sim_sass_name(m.group(1))
            if sim_fn:
                sim[sim_fn] = dict.fromkeys(SIM_OPS, 0)
        elif fn:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
        elif sim_fn:
            for op in SIM_OPS:
                sim[sim_fn][op] += bool(re.search(rf"\b{op}\b", line))
    tc = {f: c for f, c in counts.items() if "flash_sm90_kernel" in f}
    if len(tc) != 2 or not all(c["HGMMA"] > 0 for c in tc.values()):
        raise AssertionError(f"tensor-core flash kernel without HGMMA: {counts}")
    split = {f: c for f, c in counts.items() if "flash_kernelI" in f}
    if len(split) != 10 or not all(c["HMMA"] > 0 for c in split.values()):
        raise AssertionError(f"split-TF32 flash kernel without HMMA: {counts}")
    for f, c in counts.items():
        print(f"sass {f}: {c}", flush=True)
    rec["flash_sass"] = counts
    for f, c in sim.items():
        print(f"sass event_sim {f}: {c}", flush=True)
    rec["event_sim_sass"] = sim


def start_ptxas():
    """``nvcc -Xptxas -v`` on ``csrc/replay.cu``, ``csrc/linear_scan.cu``
    and ``csrc/flash_attention.cu`` with the library's flags, started
    beside the library's own build."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(_build.CSRC / f"{name}.cu"), "-o", str(out / f"{name}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("replay", "linear_scan", "flash_attention")}


def ptxas_info(proc, pattern, name_of):
    """{instantiation: registers, stack and spills} from ``proc``'s ptxas
    report; ``pattern`` matches an entry function's name and ``name_of``
    names it from the match; entries it does not match are skipped."""
    import re

    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{out}{err}")
    info, fn = {}, None
    for line in (out + err).splitlines():
        if "Compiling entry function" in line:  # entries of other kernels: None
            m = re.search(pattern, line)
            fn = name_of(m) if m else None
            if fn:
                info[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            info[fn].update(zip(("stack_bytes", "spill_store_bytes",
                                 "spill_load_bytes"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            info[fn]["registers"] = int(m.group(1))
    return info


# event_sim_ptxas: the sketched instantiations that had stack memory in the
# sketch slice's final chip run (16 bytes, no local memory); no other may
# have any
SKETCH_STACK_BEFORE = ("tiered R=8",)


def event_sim_ptxas(rec):
    """Registers, stack frame and local memory of each event-sim
    instantiation (untraced, traced, traced for routes over 32 visits,
    coalescing, open loop, counting, tiered, and traced coalescing, open
    loop and tiered; R register slots per thread, R = 0: shared memory),
    without the sketch (``event_sim.cu``, ``event_sim_traced.cu``) and
    with it (``event_sim_sketch.cu``, ``event_sim_traced_sketch.cu``), and
    of the sketch_trace kernel's 11 (S register slots a thread, packed and
    unpacked; S = 0, the table in device memory, unpacked), as the built
    library records them (``cuobjdump -res-usage``: the registers ptxas
    assigned, with no second compile beside the build); raises unless all
    35 + 15 + 35 + 15 + 11 are there, if an instantiation of ``event_sim.cu`` has other
    registers than ``EVENT_SIM_REGISTERS``, or if a sketch_trace
    instantiation, or a sketched one but ``SKETCH_STACK_BEFORE``'s, has
    stack or local memory (sketch_trace's register table is indexed by
    constants alone)."""
    import re
    import shutil
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", str(_build.build_library())],
                         capture_output=True, text=True, check=True).stdout
    modes = ("untraced", "traced", "traced, routes over 32")
    ext = ("coalescing", "open loop", "counting", "tiered")
    info = {"unsketched": {}, "sketched": {}}
    fn, trace_k = None, {}
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            k = re.search(r"sim_kernelILi([012])ELi(\d+)ELi([01234])E",
                          m.group(1))
            fn = None
            if k:
                trace, mode = int(k.group(1)), int(k.group(3))
                what = (modes[trace] if mode == 0 else
                        ("traced " if trace else "") + ext[mode - 1])
                fn = ("sketched" if "Sketched" in m.group(1) else
                      "unsketched", f"{what} R={k.group(2)}")
            elif "sketch_trace_kernel" in m.group(1):
                t = re.search(r"RegTableILi(\d+)ELb([01])E", m.group(1))
                fn = ("sketch_trace",
                      f"S={t.group(1)} {SKETCH_FORMS[int(t.group(2))]}"
                      if t else f"S=0 {SKETCH_FORMS[0]}")
            continue
        r = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if fn and r:
            v = dict(zip(("registers", "stack_bytes", "local_bytes"),
                         map(int, r.groups())))
            if fn[0] == "sketch_trace":
                trace_k[fn[1]] = v
            else:
                info[fn[0]][fn[1]] = v
            fn = None
    for group, got in info.items():
        traced = [n for n in got if n.startswith("traced ")
                  and not n.startswith(("traced R=", "traced, routes"))]
        if len(got) != 50 or len(traced) != 15:
            raise AssertionError(f"cuobjdump -res-usage found {group} "
                                 f"{sorted(got)}")
    if set(info["sketched"]) != set(info["unsketched"]):
        raise AssertionError(f"sketched instantiations "
                             f"{sorted(info['sketched'])} are not the "
                             f"unsketched ones' twins")
    stacked = {fn: v for fn, v in info["sketched"].items()
               if (v["stack_bytes"] and not fn.startswith(SKETCH_STACK_BEFORE))
               or v["local_bytes"]}
    if stacked:
        raise AssertionError(f"sketched event-sim instantiations with stack "
                             f"or local memory: {stacked}")
    want_st = {f"S=0 {SKETCH_FORMS[0]}"} | {
        f"S={n} {f}" for n in SKETCH_SLOTS for f in SKETCH_FORMS}
    if set(trace_k) != want_st:
        raise AssertionError(f"cuobjdump -res-usage found sketch_trace "
                             f"{sorted(trace_k)}, not {sorted(want_st)}")
    spilled = {fn: v for fn, v in trace_k.items()
               if v["stack_bytes"] or v["local_bytes"]}
    if spilled:
        raise AssertionError(f"sketch_trace instantiations with stack or "
                             f"local memory: {spilled}")
    want = {f"{mode} R={r}": n for mode, regs in EVENT_SIM_REGISTERS.items()
            for r, n in zip((0, 1, 2, 4, 8), regs)}
    moved = {fn: (v["registers"], want[fn])
             for fn, v in info["unsketched"].items()
             if fn in want and v["registers"] != want[fn]}
    if moved or not set(want) <= set(info["unsketched"]):
        raise AssertionError(f"event-sim instantiations without the sketch "
                             f"changed registers (now, before): {moved}")
    for group, got in info.items():
        for fn, v in sorted(got.items()):
            print(f"registers event_sim {group} {fn}: {json.dumps(v)}",
                  flush=True)
    for fn, v in sorted(trace_k.items()):
        print(f"registers sketch_trace {fn}: {json.dumps(v)}", flush=True)
    print("registers event_sim: the 35 instantiations of event_sim.cu keep "
          "their registers; the 50 sketched ones have no stack or local "
          f"memory but {SKETCH_STACK_BEFORE}'s stack, as before", flush=True)
    rec["event_sim_ptxas"] = info["unsketched"]
    rec["event_sim_sketch_ptxas"] = info["sketched"]
    rec["sketch_trace_ptxas"] = trace_k


def replay_ptxas(procs, rec):
    """Registers, stack frame and spills of each replay instantiation (one
    per policy and state layout); raises unless all 14 compiled."""
    from repro_torch.cache.flat import POLICY_IDS
    from repro_torch.kernels.replay import LAYOUTS

    names = list(POLICY_IDS)
    info = ptxas_info(procs["replay"], r"replay_kernelILi(\d)ELi(\d)E",
                      lambda m: f"{names[int(m.group(1))]} "
                                f"{LAYOUTS[int(m.group(2))]}")
    if len(info) != 14 or not all(len(v) == 4 for v in info.values()):
        raise AssertionError(f"ptxas reported {info}")
    for fn, v in sorted(info.items()):
        print(f"ptxas replay {fn}: {json.dumps(v)}", flush=True)
    rec["replay_ptxas"] = info


def wkv_ptxas(procs, rec):
    """Registers, stack frame and spills of each chunked WKV instantiation
    (three type combinations x three head widths); raises unless all nine
    compiled."""
    types = {"fff": "f32", "13__nv_bfloat16S1_S1_": "bf16",
             "13__nv_bfloat16ff": "bf16/f32/f32"}
    info = ptxas_info(procs["linear_scan"],
                      r"wkv6_chunked_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)E",
                      lambda m: f"{types.get(m.group(1), m.group(1))} dh={m.group(2)} "
                                f"C={m.group(3)} jblocks={m.group(4)}")
    if len(info) != 9 or not all(len(v) == 4 for v in info.values()):
        raise AssertionError(f"ptxas reported {info}")
    for fn, v in sorted(info.items()):
        print(f"ptxas wkv6_chunked {fn}: {json.dumps(v)}", flush=True)
    rec["wkv_ptxas"] = info


def flash_ptxas(procs, rec):
    """Registers, stack frame and spills of each split-TF32 flash
    instantiation (float32 at six head widths, bf16 at four); raises unless
    all ten compiled."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    info = ptxas_info(procs["flash_attention"], r"flash_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      lambda m: f"{types[m.group(1)]} dh={m.group(2)}")
    if len(info) != 10 or not all(len(v) == 4 for v in info.values()):
        raise AssertionError(f"ptxas reported {info}")
    for fn, v in sorted(info.items()):
        print(f"ptxas flash_attention {fn}: {json.dumps(v)}", flush=True)
    rec["flash_ptxas"] = info


def long_route_network(mpl):
    """A request that alternates two queues twenty times after a think
    station (41 visits), or visits one queue once: the traced kernel's
    instantiation for routes longer than a warp."""
    from repro_torch.core.queueing import (QUEUE, THINK, Branch,
                                           ClosedNetwork, Station)

    stations = (Station("think", THINK, 2.0, dist="exp"),
                Station("a", QUEUE, 0.05, dist="det"),
                Station("b", QUEUE, 0.04, dist="pareto",
                        dist_params=(0.45, 0.1, 1.2), servers=2))
    branches = (Branch("long", lambda p: p, ("think",) + ("a", "b") * 20),
                Branch("short", lambda p: 1.0 - p, ("think", "a")))
    return ClosedNetwork("long route", stations, branches, mpl)


def det_network(net):
    """The network with every station's service made deterministic."""
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det", dist_params=()) for s in net.stations))


def hold_replay(what, kern, plain) -> int:
    """Raise unless the four replay outputs are bit-identical; returns 0."""
    import torch

    torch.cuda.synchronize()
    for a, b, name in zip(kern, plain, ("hits", "evicted", "ops", "cls")):
        if not torch.equal(a, b):
            raise AssertionError(f"replay kernel != plain: {what} {name}")
    print(f"replay {what}: kernel == plain (bit-identical)", flush=True)
    return 0


def hold_sim(what, kern, plain) -> float:
    """Raise unless completed and events are identical and the throughput
    agrees within SIM_RTOL; returns max |dx|."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    kx, px = kern.x.cpu().numpy(), plain.x.cpu().numpy()
    if not np.isfinite(kx).all():
        raise AssertionError(f"event-sim kernel: non-finite throughput ({what})")
    if not (torch.equal(kern.completed, plain.completed)
            and torch.equal(kern.events, plain.events)):
        raise AssertionError(f"event-sim kernel != plain: {what}")
    np.testing.assert_allclose(kx, px, rtol=SIM_RTOL, err_msg=what)
    err = float(np.abs(kx - px).max())
    print(f"event_sim {what}: completed/events identical, max |dx| = {err:.3g}",
          flush=True)
    return err


def hold_replay_layouts(what, policy, grid):
    """The kernel in each of its state layouts that fits the lanes (and
    the wrapper, in the layout it picks) against the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay as kr

    plain = kr.replay_lanes_plain(policy, *grid.args, grid.key_space,
                                  grid.pad)
    for kind in kr.LAYOUTS:
        layout = kr.layout_bytes(policy, grid.key_space, grid.pad, kind)
        if not kr.layout_fits(layout, grid.pad):
            continue
        hold_replay(f"{what}, {kind} layout", kr._launch(
            _build.load_library(), policy, layout, grid.args, grid.key_space,
            grid.pad), plain)
    hold_replay(f"{what}, wrapper", kr.replay_lanes(
        policy, *grid.args, grid.key_space, grid.pad), plain)


def check_replay(rec):
    """Every policy but LRU (held at full length in ``full_size``) at the
    main path's lane shape: key_space 4096, the five sizes (pad 3300),
    window 8 with re-issues, two seeds.  The trace opens with 3400
    distinct keys, so every size is full and evicting from then on, and
    goes on with the main path's Zipf stream.  Then the edge lanes
    (``EDGE_CASES`` of ``tests/test_torch_replay_cuda.py``) and key space
    2**17, in every state layout that fits."""
    import numpy as np
    from repro_torch.core.harness import coin_stream, zipf_trace
    from repro_torch.kernels import replay as kr
    from test_torch_replay_cuda import EDGE_CASES, edge_stream

    keys, us = [], []
    for seed in (0, 1):
        fill = np.random.default_rng(seed).permutation(4096)[:CHECK_FILL]
        keys.append(np.concatenate(
            [fill, zipf_trace(CHECK_T - CHECK_FILL, 4096, 0.99, seed)]))
        us.append(coin_stream(CHECK_T, seed))
    keys, us = np.stack(keys), np.stack(us)
    for policy, params in POLICY_PARAMS.items():
        if policy == "lru":
            continue
        grid = kr.grid_lanes(policy, keys, us, IMPL_CAPS, key_space=4096,
                             window=8, fail_prob=0.1, device="cuda", **params)
        hold_replay(f"{policy} {grid.shape}",
                    kr.replay_lanes(policy, *grid.args, grid.key_space, grid.pad),
                    kr.replay_lanes_plain(policy, *grid.args, grid.key_space,
                                          grid.pad))
    for policy, params, stream, caps, pad_to in EDGE_CASES:
        keys, us, key_space = edge_stream(stream)
        grid = kr.grid_lanes(policy, keys, us, caps, key_space=key_space,
                             pad_to=pad_to, window=4, fail_prob=0.1,
                             device="cuda", **params)
        hold_replay_layouts(f"edge {policy} {params} {stream} {grid.shape}",
                            policy, grid)
    rng = np.random.default_rng(12)
    big = rng.integers(0, REPLAY_BIG_KEYS, size=(1, REPLAY_BIG_T))
    big[0, ::3] = big[0, :REPLAY_BIG_T // 3]  # repeats, so there are hits
    big_us = rng.random(big.shape, dtype=np.float32)
    for policy, params in POLICY_PARAMS.items():
        grid = kr.grid_lanes(policy, big, big_us, (5, 60),
                             key_space=REPLAY_BIG_KEYS, window=8,
                             fail_prob=0.1, device="cuda", **params)
        kind = kr.replay_layout(policy, grid.key_space, grid.pad).kind
        if kind != "global":
            raise AssertionError(f"key space 2**17 took the {kind} layout")
        hold_replay_layouts(f"key space 2**17 {policy} {grid.shape}",
                            policy, grid)
    rec["replay_max_abs_err"] = 0


def untraced(kw):
    return {k: v for k, v in kw.items() if k not in ("trace_cap", "bmiss")}


def sweep_specs(policy):
    """The five measured networks of the main path's ``policy`` sweep
    (``IMPL_CAPS``, key space 4096, 60k requests), compiled on the card."""
    import torch
    from repro_torch.core.harness import measure_cache
    from repro_torch.core.simspec import compile_network

    specs = []
    for c in IMPL_CAPS:
        meas = measure_cache(policy, c, key_space=4096, n_requests=60_000,
                             device="cuda", **POLICY_PARAMS[policy])
        specs.append(compile_network(meas.network, meas.hit_ratio,
                                     device=torch.device("cuda")))
    return specs


def check_event_sim(rec):
    """The det network, whose trajectory fixes no float draw; every
    instantiation of the kernel (``SIM_MPLS``, and a 41-visit route),
    traced and untraced, on the LRU network with a 2-server disk against
    one traced plain run each (and the traced kernel against the untraced
    one); padded grids: three
    networks of different station, branch and route counts, and the LRU
    sweep's five measured networks."""
    import numpy as np
    import torch
    from repro_torch.core.policy_models import (lru_network, s3fifo_network,
                                                slru_network)
    from repro_torch.core.simspec import compile_network
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_sim as es

    dev = torch.device("cuda")
    spec, seeds, kw = es.grid_lanes(det_network(lru_network(disk_us=20.0)),
                                    np.asarray(P_GRID), 2000, (0, 1, 2), 0.25,
                                    dev)
    err = hold_sim("det network", es.sim_lanes(spec, seeds, **kw),
                   es.sim_lanes_plain(spec, seeds, **kw))
    slots = {}
    nets = [(f"mpl {mpl}", mpl, lru_network(disk_us=100.0, mpl=mpl,
                                           disk_servers=2)) for mpl in SIM_MPLS]
    nets.append(("41-visit route", 24, long_route_network(24)))
    for name, mpl, net in nets:
        spec, seeds, kw_t = es.grid_lanes(net, np.asarray((0.5, 0.9)),
                                          SIM_MPL_REQUESTS, (0, 1), 0.25, dev,
                                          trace=256)
        kern = es.sim_lanes(spec, seeds, **untraced(kw_t))
        kern_t = es.sim_lanes(spec, seeds, **kw_t)
        plain = es.sim_lanes_plain(spec, seeds, **kw_t)
        torch.cuda.synchronize()
        for f in ("x", "completed", "events", "t_measured"):
            if not torch.equal(getattr(kern, f), getattr(kern_t, f)):
                raise AssertionError(f"traced kernel != untraced: mpl {mpl} {f}")
        slots[mpl] = _build.load_library().event_sim_slots(mpl)
        what = f"{name} (R={slots[mpl]})"
        err = max(err, hold_sim(what, kern, plain),
                  hold_sim(f"traced {what}", kern_t, plain))
        rec["event_sim_traced_max_abs_err"] = max(
            rec.get("event_sim_traced_max_abs_err", 0.0),
            hold_trace(what, kern_t, plain, spec.visits[0], exact=False))
    nets = (lru_network(disk_us=100.0), s3fifo_network(disk_us=100.0),
            slru_network(disk_us=100.0, disk_servers=2))
    sweep = sweep_specs("lru")
    grids = {"3 networks, K/B/Lr padded": (
        [compile_network(n, p, device=dev) for n, p in zip(nets, (0.6, 0.8, 0.9))],
        [0, 7, 2001], 1000),
        "lru sweep's 5 networks": (sweep, [0] * len(sweep), 2000)}
    for what, (specs, lane_seeds, n_req) in grids.items():
        grid = es.pad_lanes(specs, lane_seeds, n_req, 0.25)
        err = max(err, hold_sim(what, es.sim_lanes(*grid[:2], **grid[2]),
                                es.sim_lanes_plain(*grid[:2], **grid[2])))
    rec["event_sim_max_abs_err"] = err
    rec["event_sim_slots"] = slots


def check_coalesce(rec):
    """The coalescing instantiation against the plain version on the card:
    ``COALESCE_CASES`` of ``tests/test_torch_event_sim_cuda.py`` (F 1, 16,
    64; uniform and Zipf(0.99) flows; one and two disk ranks; 1, 2, 4, 8
    register slots and shared memory).  Deterministic service: every
    output identical; exponential: integers identical, the rest within
    1e-6."""
    import torch
    from test_torch_event_sim_cuda import (COALESCE_CASES, coalesce_pair,
                                           hold_coalesced)

    err = 0.0
    for case in COALESCE_CASES:
        kern, plain = coalesce_pair(case, torch.device("cuda"), CO_REQUESTS)
        torch.cuda.synchronize()
        err = max(err, hold_coalesced(kern, plain, exact=case[-1]))
        print(f"coalesce {case[0]}: kernel == plain "
              f"({'identical' if case[-1] else 'integers identical'}), "
              f"delayed_frac {kern.delayed_frac.cpu().numpy().round(4).tolist()}",
              flush=True)
    rec["event_sim_coalesced_max_abs_err"] = err


def check_open(rec):
    """The open-loop instantiation against the plain version on the card:
    ``OPEN_CASES`` (max_in_system 4, 40, 64, 128, 256, 300; with and
    without bursts and coalescing; a pool that drops arrivals).
    Deterministic service: sojourns, classes and counts identical."""
    import torch
    from test_torch_event_sim_cuda import OPEN_CASES, hold_open, open_pair

    err = 0.0
    for case in OPEN_CASES:
        kern, plain = open_pair(case, torch.device("cuda"), OPEN_REQUESTS)
        torch.cuda.synchronize()
        err = max(err, hold_open(kern, plain, exact=case[-1]))
        print(f"open {case[0]}: kernel == plain "
              f"({'identical' if case[-1] else 'integers identical'}), "
              f"dropped {kern.dropped.cpu().tolist()}, delayed_frac "
              f"{kern.delayed_frac.cpu().numpy().round(4).tolist()}",
              flush=True)
    rec["event_sim_open_max_abs_err"] = err


def check_cluster(rec):
    """``cluster_vs_plain``: the counting instantiation against its plain
    version and the closed kernel (``COUNT_CASES`` of
    ``tests/test_torch_event_sim_cuda.py``: every register-slot count and
    shared memory; identical on deterministic service), then lanes of the
    sharded cluster's networks through the counting and the coalescing
    instantiations against their plain versions (``CLUSTER_CASES``: 4
    shards at mpl 48, 8 at mpl 96 as fig_cluster C runs them, 16 at mpl
    192 as the differential does, and 8 at the default mpl 576, whose jobs
    live in shared memory): integers (completions, events, per-branch counts)
    identical, the rest within 1e-6; and a traced cluster lane with
    counts (one traced and one counting launch) against its plain
    version, records included."""
    import torch
    from test_torch_event_sim_cuda import (CLUSTER_CASES, COUNT_CASES,
                                           cluster_pair, count_pair,
                                           hold_coalesced, hold_counted,
                                           hold_traced_count,
                                           traced_count_pair)

    dev = torch.device("cuda")
    err = {"count": 0.0, "coalesced": 0.0}
    for case in COUNT_CASES:
        kern, plain, closed = count_pair(case, dev, CO_REQUESTS)
        torch.cuda.synchronize()
        err["count"] = max(err["count"],
                           hold_counted(kern, plain, closed, exact=case[-1]))
        print(f"count {case[0]}: kernel == plain "
              f"({'identical' if case[-1] else 'integers identical'}), "
              f"events == the closed kernel's", flush=True)
    for case in CLUSTER_CASES:
        kern, plain = cluster_pair(case, dev, CLUSTER_PLAIN_REQUESTS)
        torch.cuda.synchronize()
        which = "coalesced" if case[-1] else "count"
        err[which] = max(err[which], hold_coalesced(kern, plain, exact=False))
        print(f"cluster {case[0]}: kernel == plain (integers identical, "
              f"branch counts {kern.branch_done.sum(dim=1).tolist()}), "
              f"delayed_frac {kern.delayed_frac.cpu().numpy().round(4).tolist()}",
              flush=True)
    kern, plain = traced_count_pair(dev, CLUSTER_PLAIN_REQUESTS)
    torch.cuda.synchronize()
    err["count"] = max(err["count"], hold_traced_count(kern, plain))
    print("cluster 4shard-mpl48-count traced: records == the traced plain "
          "version's, counts == the counting plain version's", flush=True)
    rec["event_sim_count_max_abs_err"] = err["count"]
    rec["event_sim_coalesced_max_abs_err"] = max(
        rec.get("event_sim_coalesced_max_abs_err", 0.0), err["coalesced"])


def check_sketch(rec, modes=("closed", "count")):
    """``sketch_vs_plain``: the sketched instantiations against their plain
    versions on the card (``SKETCH_CASES`` of
    ``tests/test_torch_event_sim_cuda.py`` of ``modes``: the closed loop
    untraced and traced, a route over 32 visits among them, and the
    counting mode; ``sketch_ext_vs_plain`` the coalescing, open-loop with
    bursts and tiered modes; register slots and shared memory,
    deterministic service): every field of the sketch state identical,
    the EWMAs bit for bit, and every simulation output identical to the
    unsketched kernel's.  Two checks, so that two workers share the
    cases."""
    import torch
    from test_torch_event_sim_cuda import (SKETCH_CASES, hold_sketch_case,
                                           hold_sketched, sketch_pair)

    err = 0.0
    for case in [c for c in SKETCH_CASES if c[1] in modes]:
        kern, plain, bare = sketch_pair(case, torch.device("cuda"),
                                        SKETCH_PLAIN_REQUESTS)
        torch.cuda.synchronize()
        done = hold_sketched(kern, plain, bare)
        hold_sketch_case(case, kern)
        err = max(err, float((kern.sketch.ewma_hit_frac
                              - plain.sketch.ewma_hit_frac).abs().max()))
        print(f"sketch {case[0]}: state == plain (every field), outputs == "
              f"the unsketched kernel's; {done} completions, keys "
              f"{kern.sketch.key_count.cpu().tolist()}, windows to "
              f"{int(kern.sketch.win_id.max())}", flush=True)
    rec["event_sim_sketch_max_abs_err"] = err


def check_sketch_ext(rec):
    """``sketch_ext_vs_plain``: :func:`check_sketch` on the coalescing and
    open-loop cases."""
    check_sketch(rec, modes=("flows", "open"))


def check_sketch_tiers(rec):
    """``sketch_tiers_vs_plain``: :func:`check_sketch` on the tiered
    cases."""
    check_sketch(rec, modes=("tiers",))


def hold_trace_lanes(what, mode, lanes, exact):
    """One traced launch against its traced plain version (records
    identical in req, branch, cls and nvis, the stamps identical on
    deterministic service and within SIM_RTOL otherwise) and against the
    untraced launch (every other output identical); with the sketch on,
    the traced launch's every output but its rings the sketched launch's
    (the sketch state included) and its rings the traced launch's.
    Returns the largest stamp difference (us)."""
    import torch
    from test_torch_event_sim_cuda import (hold_coalesced, hold_open,
                                           hold_tiered, hold_trace_ext,
                                           hold_trace_sketch)

    holds = {"flows": hold_coalesced, "open": hold_open, "tiers": hold_tiered}
    fn, plain_fn, spec, seeds, kw = lanes
    bare = {k: v for k, v in kw.items() if k != "trace_cap"}
    kern = fn(spec, seeds, **kw)
    plain, ms = timed_plain(lambda: plain_fn(spec, seeds, **kw))
    untraced = fn(spec, seeds, **bare)
    torch.cuda.synchronize()
    err = hold_trace_ext(kern, plain, untraced, exact)
    holds[mode](kern, plain, exact=exact)
    sk = dict(sketch_cap=8, window_us=50.0)
    hold_trace_sketch(fn(spec, seeds, **dict(kw, **sk)),
                      fn(spec, seeds, **dict(bare, **sk)), kern)
    cap, done = kw["trace_cap"], kern.completed
    print(f"trace_ext {what}: records == plain "
          f"({'identical' if exact else 'integers identical'}), "
          f"{int((kern.rings.cls == 2).sum())} delayed in the rings, "
          f"{int(done.sum())} completions, rings of {cap} "
          f"{'overflowing' if int(done.max()) > cap else 'lossless'}; "
          f"other outputs == the untraced kernel's, sketch off and on "
          f"(plain {ms:.0f} ms)", flush=True)
    return err


def check_trace_ext(rec, modes=("flows", "open")):
    """``trace_ext_vs_plain``: the traced coalescing and open-loop
    instantiations (``trace_ext_tiers_vs_plain``: the tiered ones) against
    their traced plain versions on the card (:func:`hold_trace_lanes`), on
    ``TRACE_EXT_CASES`` of ``tests/test_torch_event_sim_cuda.py`` at the
    tests' own ``TRACE_EXT_REQUESTS``: every register-slot count and
    shared memory in each mode, routes of 34 and 41 visits, rings that
    overflow and rings that do not, bursts, a pool that drops arrivals.
    Two checks, so that two workers share the cases."""
    import torch
    from test_torch_event_sim_cuda import TRACE_EXT_CASES, trace_ext_lanes

    dev = torch.device("cuda")
    err = 0.0
    for case in TRACE_EXT_CASES:
        if case[1] in modes:
            err = max(err, hold_trace_lanes(
                case[0], case[1],
                trace_ext_lanes(case, dev, TRACE_EXT_REQUESTS),
                exact=case[-1]))
    rec["event_sim_traced_ext_max_abs_err"] = err


def check_trace_ext_tiers(rec):
    """``trace_ext_tiers_vs_plain``: :func:`check_trace_ext` on the
    tiered cases."""
    check_trace_ext(rec, modes=("tiers",))


def check_trace_ext_fig(rec):
    """``trace_ext_fig_vs_plain``: :func:`hold_trace_lanes` on the
    figures' networks, a few hundred requests a lane: fig_delayed_hits B's
    three p x two seeds into overflowing rings, fig_latency B's open loop
    (three p), fig_latency C's coalescing open loop (deterministic disk,
    16 flows, two seeds: the open loop's woken records), fig_hierarchy's
    network at three p and fig_cluster C's 8-shard network (8 flows a
    shard, mpl 96, three p x two seeds, with its per-branch counts)."""
    import numpy as np
    import torch
    from repro_torch.core import build, exponential_analogue
    from repro_torch.kernels import event_sim as es
    from repro_torch.latency import lambda_max
    from test_torch_event_sim_cuda import cluster_model, hierarchy_model

    dev = torch.device("cuda")
    sim, plain, open_, open_plain = (es.sim_lanes, es.sim_lanes_plain,
                                     es.sim_open_lanes, es.sim_open_lanes_plain)
    net_b = build("lru", disk_us=DH_DISK_US, disk_servers=DH_IO_DEPTH)
    err = hold_trace_lanes(
        "fig_delayed_hits B, 3 p x 2 seeds", "flows",
        (sim, plain, *es.grid_lanes(net_b, np.asarray(DH_P_SIM), 500, (0, 1),
                                    0.25, dev, coalesce_flows=16, trace=128)),
        exact=False)
    lat = build("lru", disk_us=LAT_DISK_US)
    lam = LAT_SIM_LOAD * float(np.max(lambda_max(lat, np.linspace(0, 1, 201))))
    lanes = es.open_lanes(
        exponential_analogue(build("lru", disk_us=LAT_DISK_US_SIM)),
        np.asarray(LAT_P_SIM), np.full(3, lam), 500, (0,), 0.25, 256,
        device=dev, trace=256)
    err = max(err, hold_trace_lanes("fig_latency B's open loop, 3 p", "open",
                                    (open_, open_plain, *lanes), exact=False))
    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations))
    lanes = es.open_lanes(net_c, np.array([0.5]), np.array([LAT_CO_LAMBDA]),
                          500, (0, 1), 0.25, 256, coalesce_flows=LAT_CO_FLOWS,
                          device=dev, trace=256)
    err = max(err, hold_trace_lanes(
        "fig_latency C's coalescing open loop, 2 seeds", "open",
        (open_, open_plain, *lanes), exact=True))
    hm = hierarchy_model("fig", HI_MPL)
    lo, hi = hm.profile.p_range()
    lanes = es.grid_lanes(hm.network, np.linspace(lo + 1e-3, hi - 1e-3, 3),
                          400, (0,), 0.25, dev, coalesce_flows=4,
                          tiers=hm.mshr, trace=256)
    err = max(err, hold_trace_lanes("fig_hierarchy's network, 3 p", "tiers",
                                    (sim, plain, *lanes), exact=False))
    cm = cluster_model(CL_SHARDS, 12 * CL_SHARDS, key_space=CL_SIM_KEYS)
    spec, seeds, kw = es.grid_lanes(cm.network, np.asarray(CL_SIM_P), 300,
                                    (0, 1), 0.25, dev, coalesce_flows=8,
                                    trace=512)
    err = max(err, hold_trace_lanes(
        "fig_cluster C's 8 shards, 3 p x 2 seeds", "flows",
        (sim, plain, spec, seeds, dict(kw, count_branches=True)),
        exact=False))
    rec["event_sim_traced_ext_max_abs_err"] = err


def fig_drift_stream(device):
    """fig_drift A's stream on ``device``: 24 000 Zipf(0.9) keys over 512
    (seed 0), one event per us, and the hits of an LRU cache of 64 on it,
    as (1, n) int32, float32 and int32 tensors."""
    import numpy as np
    import torch
    from repro_torch.cache.replay import lru_sweep
    from repro_torch.core.harness import zipf_trace

    trace = zipf_trace(FD_STREAM, FD_KEYS, FD_THETA, seed=0)
    hits = np.asarray(lru_sweep(trace, [64])[0][0], np.int32)
    return tuple(torch.from_numpy(a)[None].to(device) for a in (
        trace.astype(np.int32), np.arange(FD_STREAM, dtype=np.float32), hits))


def hold_sketch_trace_case(name, keys, t, hits, cap, rec):
    """The sketch_trace kernel on the (L, n) streams against its plain
    version (the torch loop, on the card) and the exact twin
    ``sketch_trace_py`` (500-us windows): every field of the state
    identical to the plain version's, every windowed counter to the
    twin's, count-min never under its counts."""
    import torch
    from repro_torch.kernels import sketch as ksk
    from test_torch_event_sim_cuda import hold_sketch_trace

    kern = ksk.sketch_trace_lanes(keys, t, hits, sketch_cap=cap,
                                  window_us=FD_WINDOW_US)
    plain = ksk.sketch_trace_plain(keys, t, hits, sketch_cap=cap,
                                   window_us=FD_WINDOW_US)
    torch.cuda.synchronize()
    hold_sketch_trace(kern, plain, keys, t, hits, cap, FD_WINDOW_US)
    print(f"sketch_trace {name} (sketch_cap {cap}, {keys.shape[0]} x "
          f"{keys.shape[1]} keys): state == plain (every field), windows == "
          f"sketch_trace_py; key_count {kern.key_count.tolist()}", flush=True)
    rec["sketch_trace_max_abs_err"] = max(
        rec.get("sketch_trace_max_abs_err", 0.0),
        float((kern.ewma_hit_frac - plain.ewma_hit_frac).abs().max()))


def check_sketch_trace(rec):
    """``sketch_trace_vs_plain``: :func:`hold_sketch_trace_case` on
    fig_drift A's stream (24 000 keys over 512, theta 0.9, sketch_cap 96,
    with an LRU cache's hits)."""
    import torch

    keys, t, hits = fig_drift_stream(torch.device("cuda"))
    hold_sketch_trace_case("fig_drift A", keys, t, hits, FD_CAP, rec)


def check_sketch_trace_bc(rec):
    """``sketch_trace_bc_vs_plain``: :func:`hold_sketch_trace_case` at
    the other shapes :func:`fig_drift` launches the kernel at, on its
    streams (no hits, as there): B's 24 000 keys (seed 1) at sketch_cap
    256; C's two 12 000-key phases (seed 2; seed 3 at theta 0.55, shifted
    by half the key space) at 512, as one two-lane launch; C's second
    phase at 256 (its undersized table)."""
    import numpy as np
    import torch
    from repro_torch.core.harness import zipf_trace

    dev = torch.device("cuda")

    def lanes(*traces):
        keys = torch.from_numpy(np.stack(traces).astype(np.int32)).to(dev)
        t = torch.arange(keys.shape[1], dtype=torch.float32,
                         device=dev).expand_as(keys).contiguous()
        return keys, t, torch.zeros_like(keys)

    half = FD_STREAM // 2
    t1 = zipf_trace(half, FD_KEYS, FD_THETA, seed=2)
    t2 = (zipf_trace(half, FD_KEYS, 0.55, seed=3) + FD_KEYS // 2) % FD_KEYS
    hold_sketch_trace_case(
        "fig_drift B", *lanes(zipf_trace(FD_STREAM, FD_KEYS, FD_THETA,
                                         seed=1)), 256, rec)
    hold_sketch_trace_case("fig_drift C phases", *lanes(t1, t2), FD_KEYS,
                           rec)
    hold_sketch_trace_case("fig_drift C phase 2, undersized", *lanes(t2),
                           FD_KEYS // 2, rec)


def check_tiers(rec):
    """``tiers_vs_plain``: the tiered instantiation against its plain
    version on the card, on ``TIERS_CASES`` of
    ``tests/test_torch_event_sim_cuda.py`` (tests/test_hierarchy.py's
    2 x 2 hierarchy at mpl 16, 48, 72, 192 and 300, F 2 to 8, uniform and
    Zipf flows, p 0.2, 0.5 and 0.8393; fig_hierarchy's 3 x 2 hierarchy at
    mpl 96 and F 4; one job refilling the entry it fills): integers
    identical (completions, events, per-branch counts), and on
    deterministic service every output, the per-level delayed fractions
    included; the rest within 1e-6."""
    import torch
    from test_torch_event_sim_cuda import TIERS_CASES, hold_tiered, tiers_pair

    err = 0.0
    for case in TIERS_CASES:
        kern, plain = tiers_pair(case, torch.device("cuda"),
                                 TIERS_PLAIN_REQUESTS)
        torch.cuda.synchronize()
        err = max(err, hold_tiered(kern, plain, exact=case[-1]))
        print(f"tiers {case[0]}: kernel == plain "
              f"({'identical' if case[-1] else 'integers identical'}), "
              f"delayed per level "
              f"{kern.delayed_tier.cpu().numpy().round(4).tolist()}",
              flush=True)
    rec["event_sim_tiers_max_abs_err"] = err


def check_tiers_long(rec):
    """``tiers_long_vs_plain``: the tiered instantiation against its plain
    version on ``TIERS_LONG_CASE``, fig_hierarchy's network with
    deterministic service at the length fig_hierarchy's runs give the
    kernel (``HI_REQUESTS``), three p x two seeds: long enough for the
    leader tables and the two-wave cascades to build up; every output
    identical."""
    import torch
    from test_torch_event_sim_cuda import hold_tiered, tiers_pair

    kern, plain = tiers_pair(TIERS_LONG_CASE, torch.device("cuda"),
                             HI_REQUESTS)
    torch.cuda.synchronize()
    err = hold_tiered(kern, plain, exact=True)
    print(f"tiers {TIERS_LONG_CASE[0]}: {HI_REQUESTS} requests x "
          f"{kern.x.numel()} lanes, kernel == plain (identical), events "
          f"{kern.events.tolist()}, delayed per level "
          f"{kern.delayed_tier.cpu().numpy().round(4).tolist()}", flush=True)
    rec["event_sim_tiers_max_abs_err"] = max(
        rec.get("event_sim_tiers_max_abs_err", 0.0), err)


def table2_classify(device):
    """``benchmarks/table2_classify.py`` through the port: the analytic
    classification of Table 1's networks and the implemented structures'
    hit-path ops (one replay launch each)."""
    import numpy as np
    from repro_torch.core import (TABLE1, build, classify_by_throughput,
                                  classify_structural, prob_lru_network)
    from repro_torch.core.harness import run_cache_trace, zipf_trace

    trace = zipf_trace(T2_REQUESTS, T2_KEYS, 0.99, seed=0)

    def hit_ops(policy, **kw):
        hits, ops = run_cache_trace(policy, T2_CAPACITY, trace, seed=0,
                                    key_space=T2_KEYS, device=device, **kw)
        return int(np.asarray(ops)[np.asarray(hits)].sum())

    nets = {"lru": build("lru"), "fifo": build("fifo"),
            "prob_lru(q=0.5)": prob_lru_network(q=0.5),
            "prob_lru(q=0.986)": prob_lru_network(q=1 - 1 / 72),
            "clock": build("clock"), "slru": build("slru"),
            "s3fifo": build("s3fifo")}
    out = {}
    for name, net in nets.items():
        kw = ({"q": 0.5} if "0.5" in name else
              {"q": 1 - 1 / 72} if "0.986" in name else {})
        impl = "LRU-like" if hit_ops(name.split("(")[0], **kw) > 0 else "FIFO-like"
        s, t = classify_structural(net), classify_by_throughput(net)
        if t != TABLE1[name][1]:
            raise AssertionError(f"table2: {name} classified {t}, paper "
                                 f"{TABLE1[name][1]}")
        out[name] = (s, t, impl)
    if hit_ops("sieve") != 0:
        raise AssertionError("table2: sieve does work on hits")
    return out


def fig_delayed_hits(device):
    """``benchmarks/fig_delayed_hits.py`` through the port: (A) LRU's p*
    drops under coalescing and FIFO stays at 1; (B) on a bounded disk the
    coalescing simulation recovers throughput, more at low p_hit, with a
    falling delayed fraction; (C) the measured sweep's sigma falls with
    size and its coalesced bound is never below the plain one."""
    import numpy as np
    from repro_torch.core import build, coalesced_network, sigma_of
    from repro_torch.core.harness import sweep_cache_sizes
    from repro_torch.core.simulator import simulate_network

    out, pstar, seconds = {}, {}, {}
    t0 = time.perf_counter()
    for policy in ("lru", "fifo"):
        pstar[(policy, 0)] = build(policy, disk_us=DH_DISK_US).p_star(grid=2001)
        for flows in DH_FLOWS:
            pstar[(policy, flows)] = build(policy, disk_us=DH_DISK_US,
                                           coalesce_flows=flows).p_star(grid=2001)
    if not (pstar[("lru", 8)] < pstar[("lru", 0)] - 0.01
            and pstar[("lru", 64)] < pstar[("lru", 0)] - 0.005
            and all(pstar[("fifo", f)] > 0.999 for f in (0,) + DH_FLOWS)):
        raise AssertionError(f"fig_delayed_hits A: p* {pstar}")
    out["pstar"] = {f"{k[0]}@{k[1]}": v for k, v in pstar.items()}
    seconds["A"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net_b = build("lru", disk_us=DH_DISK_US, disk_servers=DH_IO_DEPTH)
    model_b = coalesced_network(net_b, flows=16)
    p_sim = np.asarray(DH_P_SIM)
    plain = simulate_network(net_b, p_sim, n_requests=FIG_REQUESTS,
                             seeds=(0, 1), device=device)
    co = simulate_network(net_b, p_sim, n_requests=FIG_REQUESTS, seeds=(0, 1),
                          coalesce_flows=16, device=device)
    gains = co.throughput / plain.throughput
    if not (np.all(co.throughput >= plain.throughput - plain.ci95 - co.ci95)
            and gains[0] > 1.5 and co.delayed_frac[0] > co.delayed_frac[-1]):
        raise AssertionError(f"fig_delayed_hits B: plain {plain.throughput}, "
                             f"coalesced {co.throughput}, delayed "
                             f"{co.delayed_frac}")
    out["sim"] = {"p": DH_P_SIM, "x_plain": plain.throughput.tolist(),
                  "x_co": co.throughput.tolist(),
                  "delayed": co.delayed_frac.tolist(),
                  "sigma_model": [sigma_of(model_b, float(p)) for p in p_sim]}
    seconds["B"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = sweep_cache_sizes("lru", DH_SWEEP_CAPS, key_space=4096,
                              n_requests=DH_REQUESTS, disk_us=DH_DISK_US,
                              device=device)
    windows = np.maximum(1, np.round(probe["x_bound"] * DH_DISK_US).astype(int))
    sw = sweep_cache_sizes("lru", DH_SWEEP_CAPS, key_space=4096,
                           n_requests=DH_REQUESTS, disk_us=DH_DISK_US,
                           miss_latency_requests=windows, device=device)
    seconds["C"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hold_classify_lanes(sw, windows, device)
    seconds["C_held_per_size"] = time.perf_counter() - t0
    sig = np.asarray(sw["sigma"])
    if not (sig[0] > sig[-1] >= 0.0 and np.all(
            sw["x_bound_coalesced"] >= sw["x_bound"] - 1e-9)):
        raise AssertionError(f"fig_delayed_hits C: sigma {sig}, bounds "
                             f"{sw['x_bound']} {sw['x_bound_coalesced']}")
    out["measured"] = {k: np.asarray(v).tolist() for k, v in sw.items()}
    out["windows"] = windows.tolist()
    out["seconds"] = seconds
    return out


def hold_classify_lanes(sw, windows, device):
    """fig_delayed_hits C's one-pass classification at the sweep's full
    40 000 requests: every size a row of ONE ``classify_inflight`` pass
    with its own window, as ``sweep_cache_sizes`` runs it, bit for bit each
    size classified alone (on the host), and the sweep's own
    ``p_true_hit`` and ``p_delayed`` those of the per-size classes."""
    import numpy as np
    from repro_torch.cache.replay import classify_inflight
    from repro_torch.core.harness import _class_fracs, coin_stream, zipf_trace
    from repro_torch.kernels.replay import replay_grid_fused

    trace = zipf_trace(DH_REQUESTS, 4096, 0.99, 0)
    res = replay_grid_fused("lru", trace, coin_stream(DH_REQUESTS, 0),
                            DH_SWEEP_CAPS, key_space=4096, device=device)
    per_row = np.stack([np.full(DH_REQUESTS, int(w)) for w in windows])
    lanes = classify_inflight(trace, res.hits[:, 0], per_row,
                              key_space=4096, device=device)
    hits = res.hits[:, 0].cpu()
    for i, w in enumerate(windows):
        alone = classify_inflight(trace, hits[i], int(w), key_space=4096,
                                  device="cpu")
        fr = _class_fracs(alone)
        if not (np.array_equal(lanes[i], alone)
                and sw["p_true_hit"][i] == float(fr[1])
                and sw["p_delayed"][i] == float(fr[2])):
            raise AssertionError(f"one-pass classification != per-size: "
                                 f"size {DH_SWEEP_CAPS[i]}, window {w}")
    print(f"fig_delayed_hits C: one-pass classification == per-size "
          f"classify_inflight on {DH_REQUESTS} requests x "
          f"{len(DH_SWEEP_CAPS)} sizes, and the sweep's class fractions",
          flush=True)


def fig_latency(device):
    """``benchmarks/fig_latency.py`` through the port: (A) the analytic
    latency inversion and FIFO's monotone response; (B) the open-loop
    simulation against Erlang-C on the fast disk, with the simulated mean
    and p99 rising past the knee; (C) per-class sojourns under coalescing,
    delayed hits between true hits and true misses; (D) the SLO-capacity
    optimum inside (0, 1)."""
    import numpy as np
    from repro_torch.core import build, exponential_analogue
    from repro_torch.core.simulator import simulate_network
    from repro_torch.latency import lambda_max, response_time, slo_forecast

    seconds = {}
    t0 = time.perf_counter()
    grid = np.linspace(0.0, 1.0, 201)
    lru, fifo = build("lru", disk_us=LAT_DISK_US), build("fifo", disk_us=LAT_DISK_US)
    lam_peak = float(np.max(lambda_max(lru, grid)))
    lam = LAT_LOAD_FRAC * lam_peak
    f_lru = slo_forecast(lru, lam, LAT_SLO_US, p_grid=grid)
    f_fifo = slo_forecast(fifo, lam, LAT_SLO_US, p_grid=grid)
    i98 = int(np.argmin(np.abs(grid - 0.98)))
    ilat = int(np.argmin(np.abs(grid - f_lru.p_star_latency)))
    fin = np.isfinite(f_fifo.r_mean)
    if not (abs(f_lru.p_star_throughput - lru.p_star()) < 0.01
            and f_lru.p_star_latency < 0.999
            and abs(f_lru.p_star_latency - f_lru.p_star_throughput) > 0.02
            and f_lru.r_mean[i98] > 1.2 * f_lru.r_mean[ilat]
            and f_lru.r_tail[i98] > 1.2 * f_lru.r_tail[ilat]
            and np.all(np.diff(f_fifo.r_mean[fin]) <= 1e-9)
            and f_fifo.p_star_latency == 1.0 and f_fifo.p_star_slo == 1.0):
        raise AssertionError(f"fig_latency A: {f_lru} {f_fifo}")
    out = {"analytic": {"lambda": lam,
                        "lru_p_star_latency": f_lru.p_star_latency,
                        "lru_p_star_throughput": f_lru.p_star_throughput}}
    seconds["A"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lru_b = build("lru", disk_us=LAT_DISK_US_SIM)
    lam_b = LAT_SIM_LOAD * lam_peak
    p_sim = np.asarray(LAT_P_SIM)
    sim = simulate_network(exponential_analogue(lru_b), p_sim,
                           arrival_rate=lam_b, n_requests=FIG_REQUESTS,
                           seeds=(0, 1, 2), max_in_system=256, device=device)
    ana = response_time(lru_b, p_sim, lam_b)
    rel = np.abs(sim.sojourn_mean - ana) / ana
    if not (np.all(sim.drop_frac == 0.0) and np.all(rel[:-1] < 0.15)
            and rel[-1] < 0.35
            and sim.sojourn_mean[-1] > sim.sojourn_mean[-2]
            and sim.sojourn_p99[-1] > sim.sojourn_p99[-2]):
        raise AssertionError(f"fig_latency B: mean {sim.sojourn_mean}, "
                             f"analytic {ana}, p99 {sim.sojourn_p99}, drops "
                             f"{sim.drop_frac}")
    out["sim"] = {"lambda": lam_b, "mean": sim.sojourn_mean.tolist(),
                  "p99": sim.sojourn_p99.tolist(), "analytic": ana.tolist(),
                  "throughput": sim.throughput.tolist()}
    seconds["B"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations))
    simc = simulate_network(net_c, [0.5], arrival_rate=LAT_CO_LAMBDA,
                            n_requests=FIG_REQUESTS, seeds=(0, 1),
                            coalesce_flows=LAT_CO_FLOWS, max_in_system=256,
                            device=device)
    soj = simc.class_sojourn[0]
    if not (simc.class_frac[0, 2] > 0.05 and soj[1] < soj[2] < soj[0]):
        raise AssertionError(f"fig_latency C: fractions {simc.class_frac}, "
                             f"sojourns {simc.class_sojourn}")
    out["coalesce_classes"] = {"frac": simc.class_frac[0].tolist(),
                               "sojourn": soj.tolist()}
    seconds["C"] = time.perf_counter() - t0
    islo = int(np.argmin(np.abs(grid - f_lru.p_star_slo)))
    if not (f_lru.slo_lambda[islo] > f_lru.slo_lambda[-1] + 1e-6
            and 0.0 < f_lru.p_star_slo < 1.0):
        raise AssertionError(f"fig_latency D: {f_lru.slo_lambda}")
    out["slo"] = {"p_star_slo_lru": f_lru.p_star_slo,
                  "peak_slo_lambda_lru": float(np.max(f_lru.slo_lambda))}
    out["seconds"] = seconds
    return out


def fig_cluster(device):
    """``benchmarks/fig_cluster.py`` through the port, at its sizes: (A) the
    ring's and two-choice imbalance across skew; (B) the headline: the
    cluster LRU p* below the single-node forecast on a measured 8-shard
    profile, FIFO monotone, the hot shard above the cluster average; (C)
    the simulated 8-shard cluster with shard-local MSHR flows (one launch
    of the coalescing kernel) against the key-routing oracle (8k requests,
    seeds 3 and 4), 10% on X and 0.06 on the delayed fraction, the hot
    shard coalescing less; (D) hash-routed against rebalanced lambda_max
    and an interior SLO optimum; (E) ON-OFF arrivals raising the p99 at
    the same mean rate (the open-loop kernel, 512 slots)."""
    import numpy as np
    from repro_torch.cluster import (HashRing, cluster_network,
                                     ideal_shard_profile, imbalance,
                                     measured_shard_profile, shard_weights,
                                     simulate_cluster, simulate_cluster_py,
                                     two_choice_assignment, zipf_key_probs)
    from repro_torch.core import build, exponential_analogue
    from repro_torch.core.harness import zipf_trace
    from repro_torch.core.simulator import simulate_network
    from repro_torch.latency import slo_forecast

    out, seconds = {"imbalance": {}}, {}
    t0 = time.perf_counter()
    ring = HashRing(CL_SHARDS, vnodes=64, seed=1)
    for theta in (0.0, 0.8, 1.0):
        probs = zipf_key_probs(CL_KEYS, theta, seed=0)
        ib_ring = imbalance(shard_weights(ring.assignment(CL_KEYS), probs,
                                          CL_SHARDS))
        ib_tc = imbalance(shard_weights(
            two_choice_assignment(probs, CL_SHARDS, seed=1), probs, CL_SHARDS))
        if not ib_tc <= ib_ring + 1e-9:
            raise AssertionError(f"fig_cluster A: theta {theta}: two-choice "
                                 f"{ib_tc} > ring {ib_ring}")
        out["imbalance"][f"theta={theta:g}"] = {"ring": ib_ring,
                                                "two_choice": ib_tc}
    if not out["imbalance"]["theta=1"]["ring"] > 1.2:
        raise AssertionError(f"fig_cluster A: {out['imbalance']}")
    seconds["A"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trace = zipf_trace(40_000, CL_KEYS, CL_THETA, seed=0)
    assign = ring.assignment(CL_KEYS)
    profile = measured_shard_profile(trace, assign)
    single_lru = build("lru", disk_us=100.0)
    cm_lru = cluster_network("lru", CL_SHARDS, profile=profile, disk_us=100.0)
    cm_fifo = cluster_network("fifo", CL_SHARDS, profile=profile,
                              disk_us=100.0)
    p_single = single_lru.p_star(grid=CL_PSTAR_GRID)
    p_cluster = cm_lru.p_star(grid=CL_PSTAR_GRID)
    p_hi = profile.p_range()[1] - 0.01
    x_fifo = cm_fifo.throughput_upper(np.linspace(0.02, p_hi, 60))
    pk = profile.shard_p(p_cluster)
    hot = int(np.argmax(profile.weights))
    if not (p_cluster < p_single - 0.01 and np.all(np.diff(x_fifo) >= -1e-9)
            and pk[hot] > p_cluster):
        raise AssertionError(f"fig_cluster B: p* cluster {p_cluster}, single "
                             f"{p_single}, hot shard's p {pk[hot]}")
    out["pstar"] = {"single_lru": p_single, "cluster_lru": p_cluster,
                    "imbalance": profile.imbalance(),
                    "hot_shard_local_p": float(pk[hot])}
    seconds["B"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    probs_s = zipf_key_probs(CL_SIM_KEYS, CL_THETA, seed=0)
    assign_s = HashRing(CL_SHARDS, vnodes=64, seed=1).assignment(CL_SIM_KEYS)
    prof_s = ideal_shard_profile(assign_s, probs_s)
    cm_s = cluster_network("lru", CL_SHARDS, profile=prof_s, disk_us=100.0,
                           mpl=12 * CL_SHARDS)
    sim_p = np.asarray(CL_SIM_P)
    jx = simulate_cluster(cm_s, sim_p, n_requests=FIG_REQUESTS, seeds=(0, 1),
                          coalesce_flows=8, device=device)
    seconds["C_sim"] = time.perf_counter() - t0
    py = []
    for p in sim_p:
        runs = [simulate_cluster_py(cm_s, probs_s, assign_s, float(p),
                                    n_requests=FIG_REQUESTS // 2, seed=s,
                                    coalesce_flows=8) for s in (3, 4)]
        py.append({k: float(np.mean([r[k] for r in runs]))
                   for k in ("x", "delayed_frac")})
    rel = np.array([abs(jx.throughput[i] - py[i]["x"]) / py[i]["x"]
                    for i in range(len(sim_p))])
    d_gap = np.array([abs(jx.delayed_frac[i] - py[i]["delayed_frac"])
                      for i in range(len(sim_p))])
    pk_s = prof_s.shard_p(float(sim_p[1]))
    hot_s, cold_s = int(np.argmax(pk_s)), int(np.argmin(pk_s))
    if not (np.all(rel < 0.1) and np.all(d_gap < 0.06)
            and jx.shard_delayed_frac[1, hot_s] < jx.shard_delayed_frac[1, cold_s]):
        raise AssertionError(f"fig_cluster C: X {jx.throughput} vs oracle "
                             f"{[r['x'] for r in py]} (rel {rel}), delayed "
                             f"gaps {d_gap}, shard delayed "
                             f"{jx.shard_delayed_frac[1]}")
    out["sim"] = {"p": list(CL_SIM_P), "x_sim": jx.throughput.tolist(),
                  "x_oracle": [r["x"] for r in py], "rel_err": rel.tolist(),
                  "delayed_sim": jx.delayed_frac.tolist(),
                  "delayed_oracle": [r["delayed_frac"] for r in py]}
    seconds["C"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["boundary"] = []
    for p in (0.5, float(p_cluster), 0.9):
        routed = float(cm_lru.lambda_max(p))
        ideal = float(cm_lru.ideal_lambda_max(p))
        if not routed < ideal:
            raise AssertionError(f"fig_cluster D: p {p}: routed {routed} >= "
                                 f"ideal {ideal}")
        out["boundary"].append({"p": p, "routed": routed, "ideal": ideal})
    lam = 0.6 * float(cm_lru.lambda_max(p_cluster))
    f = slo_forecast(cm_lru.network, lam, CL_SLO_US,
                     p_grid=np.linspace(0.05, p_hi, 40))
    if not f.p_star_slo < 0.999:
        raise AssertionError(f"fig_cluster D: p*_slo {f.p_star_slo}")
    out["slo"] = {"lambda": lam, "p_star_slo": f.p_star_slo}
    seconds["D"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    net_e = exponential_analogue(cm_s.network)
    lam_e = 0.55 * float(cm_s.lambda_max(0.6, tail_mode="nominal"))
    kw = dict(arrival_rate=lam_e, n_requests=FIG_REQUESTS, seeds=(0, 1),
              max_in_system=512, device=device)
    po = simulate_network(net_e, [0.6], **kw)
    bu = simulate_network(net_e, [0.6], burst=(0.55, 2_000.0), **kw)
    if not bu.sojourn_p99[0] > po.sojourn_p99[0]:
        raise AssertionError(f"fig_cluster E: p99 burst {bu.sojourn_p99} <= "
                             f"poisson {po.sojourn_p99}")
    out["burst"] = {"lambda": lam_e, "poisson_p99": float(po.sojourn_p99[0]),
                    "burst_p99": float(bu.sojourn_p99[0])}
    seconds["E"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def fig_hierarchy(device):
    """``benchmarks/fig_hierarchy.py`` through the port, at its sizes and
    tolerances: (A) the Che tier profile, L1 filtering starving L2; (B)
    the LRU-client inversion — the simulated cluster throughput peaks at an
    interior p1 within 1.1 grid steps of the tier-aware p*, 3% above the
    last point, FIFO clients monotone, the MVA forecast within 10% of the
    simulation everywhere (the counting kernel, 9 p x 2 seeds); (C) the
    tiered kernel against the heapq oracle within 10% in throughput, 0.06
    in the L1 and 0.04 in the L2 delayed fraction; (D) cross-tier
    coalescing starving with p1, the convoy effect (coalescing lowering
    throughput at low p1) and the analytic sigma1 within 25% of the
    simulated one."""
    import numpy as np
    from repro_torch.cluster import zipf_key_probs
    from repro_torch.hierarchy import (coalesced_hierarchy, hierarchy_network,
                                       simulate_hierarchy,
                                       simulate_hierarchy_py, tier_sigma_of,
                                       tiered_profile)

    out, seconds = {}, {}
    t0 = time.perf_counter()
    prof = tiered_profile(zipf_key_probs(HI_KEYS, HI_THETA, seed=0),
                          np.array(HI_L1_CAPS), l2_cap=HI_L2_CAP,
                          assign=np.arange(HI_KEYS) % HI_SHARDS,
                          n_shards=HI_SHARDS)
    p2_mean = prof.l2_hit.mean(axis=1)
    if not p2_mean[-1] < p2_mean[0] - 0.05:
        raise AssertionError(f"fig_hierarchy A: p2 {p2_mean[0]} -> "
                             f"{p2_mean[-1]}")
    out["profile"] = {"p1": prof.l1_hit.tolist(), "p2_mean": p2_mean.tolist()}
    seconds["A"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lo, hi = prof.p_range()
    grid = np.linspace(lo + 1e-3, hi - 1e-3, HI_GRID_N)
    out["headline"], models = {}, {}
    for policy in ("lru", "fifo"):
        model = hierarchy_network(policy, "lru", n_clients=HI_CLIENTS,
                                  n_shards=HI_SHARDS, profile=prof,
                                  disk_us=HI_DISK_US, mpl=HI_MPL)
        models[policy] = model
        p_star = model.p_star(grid=4001)
        mva = np.array([model.mva_throughput(p) for p in grid])
        sim = simulate_hierarchy(model, grid, n_requests=HI_REQUESTS,
                                 seeds=(0, 1), device=device)
        rel = np.abs(sim.throughput - mva) / sim.throughput
        ok = bool(np.all(rel < HI_FORECAST_TOL))
        k = int(np.argmax(sim.throughput))
        if policy == "lru":
            ok = ok and (k < HI_GRID_N - 1
                         and sim.throughput[k] > 1.03 * sim.throughput[-1]
                         and abs(grid[k] - p_star) <= 1.1 * (grid[1] - grid[0])
                         and p_star < hi - 0.01)
        else:
            ok = ok and (p_star >= hi - 1e-9 and np.all(
                np.diff(sim.throughput) > -0.02 * sim.throughput[:-1]))
        out["headline"][policy] = {
            "p_grid": grid.tolist(), "p_star": float(p_star),
            "x_mva": mva.tolist(), "x_sim": sim.throughput.tolist(),
            "rel_err_max": float(rel.max()), "peak_p": float(grid[k])}
        if not ok:
            raise AssertionError(f"fig_hierarchy B ({policy} clients): "
                                 f"{out['headline'][policy]}")
        print(f"fig_hierarchy B {policy}: p* {p_star:.4f}, sim peak at p1 "
              f"{grid[k]:.4f}, MVA within {rel.max():.3f}", flush=True)
    seconds["B"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = models["lru"]
    twin_p = [float(grid[2]), float(grid[HI_GRID_N // 2])]
    jx = simulate_hierarchy(model, twin_p, n_requests=HI_REQUESTS,
                            seeds=tuple(range(HI_TWIN_SEEDS)),
                            coalesce_flows=4, device=device)
    seconds["C_sim"] = time.perf_counter() - t0
    runs = [[simulate_hierarchy_py(model, p, n_requests=HI_REQUESTS, seed=sd,
                                   coalesce_flows=4)
             for sd in range(3, 3 + HI_TWIN_SEEDS)] for p in twin_p]
    py = {k: np.array([np.mean([getattr(r, k)[0] for r in rs]) for rs in runs])
          for k in ("throughput", "delayed_l1_frac", "delayed_l2_frac")}
    rel = np.abs(jx.throughput - py["throughput"]) / py["throughput"]
    d1 = np.abs(jx.delayed_l1_frac - py["delayed_l1_frac"])
    d2 = np.abs(jx.delayed_l2_frac - py["delayed_l2_frac"])
    out["twins"] = {"p": twin_p, "x_sim": jx.throughput.tolist(),
                    "x_oracle": py["throughput"].tolist(),
                    "rel_err": rel.tolist(), "dl1_gap": d1.tolist(),
                    "dl2_gap": d2.tolist(), "seeds": HI_TWIN_SEEDS}
    print(f"fig_hierarchy C: X {jx.throughput.round(4).tolist()} vs oracle "
          f"{py['throughput'].round(4).tolist()} ({HI_TWIN_SEEDS} seeds a "
          f"side, rel {rel.round(3).tolist()})", flush=True)
    if not (np.all(rel < HI_TWIN_TOL) and np.all(d1 < 0.06)
            and np.all(d2 < 0.04)):
        raise AssertionError(f"fig_hierarchy C: {out['twins']}")
    seconds["C"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    coal_p = np.array([float(grid[1]), float(grid[HI_GRID_N // 2]),
                       float(grid[-2])])
    coal = simulate_hierarchy(model, coal_p, n_requests=HI_REQUESTS,
                              seeds=(0, 1), coalesce_flows=4, device=device)
    plain = simulate_hierarchy(model, coal_p, n_requests=HI_REQUESTS,
                               seeds=(0, 1), device=device)
    cnet = coalesced_hierarchy(model, flows=4)
    s1s = np.array([tier_sigma_of(cnet, float(p))[0] for p in coal_p])
    miss_frac = 1.0 - np.array([prof.tier_p(float(p))[0] for p in coal_p])
    sim_s1 = coal.delayed_l1_frac / miss_frac
    rel_s = np.abs(s1s - sim_s1) / sim_s1
    out["delayed"] = {"p": coal_p.tolist(), "x_coal": coal.throughput.tolist(),
                      "x_plain": plain.throughput.tolist(),
                      "dl1": coal.delayed_l1_frac.tolist(),
                      "dl2": coal.delayed_l2_frac.tolist(),
                      "sigma1_analytic": s1s.tolist(),
                      "sigma1_sim": sim_s1.tolist()}
    if not (coal.delayed_l1_frac[-1] < coal.delayed_l1_frac[0] - 0.05
            and coal.delayed_l2_frac[-1] <= coal.delayed_l2_frac[0] + 1e-9
            and coal.throughput[0] < plain.throughput[0]
            and np.all(rel_s < HI_SIGMA_TOL)):
        raise AssertionError(f"fig_hierarchy D: {out['delayed']}")
    seconds["D"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _windowed_hit_frac(hits, window):
    """Mean hit indicator per tumbling window (whole windows only)."""
    import numpy as np

    n = (len(hits) // window) * window
    return np.asarray(hits[:n], np.float64).reshape(-1, window).mean(axis=1)


def fig_drift_residuals(device, seed):
    """fig_drift D on simulation seed ``seed``: the windowed hit ratio and
    completion rate of the closed loop at FD_P (48 000 requests, 8-key
    sketch, 1 ms windows; the ramp and the last window trimmed), the
    residual monitor's alarms over them (stationary, live and stale
    profiles) and the windowed arrival rates of the open loop, Poisson
    and ON-OFF (24 000 requests, 2 ms windows) with their Page-Hinkley
    alarms."""
    import numpy as np
    from repro_torch.core import build
    from repro_torch.core.simulator import simulate_network
    from repro_torch.obs.drift import page_hinkley_scan
    from repro_torch.obs.residuals import ResidualMonitor

    net = build("lru", disk_us=100.0)
    lo_hi = []
    for p in FD_P:
        est = simulate_network(net, [p], n_requests=FD_CLOSED_REQUESTS,
                               seeds=(seed,), sketch_cap=8, window_us=1_000.0,
                               device=device).sketches[0][0]
        keep = np.flatnonzero(est.win_done_count > 0)[1:-1]
        lo_hi.append((est.win_hit_frac[keep], est.win_done_rate[keep]))
    (hit_lo, x_lo), (hit_hi, x_hi) = lo_hi
    quiet = ResidualMonitor(net, mode="closed").run(
        np.arange(len(hit_lo)), hit_lo, x_lo)
    hit_series = np.concatenate([hit_lo, hit_hi])
    x_series = np.concatenate([x_lo, x_hi])
    ids = np.arange(len(hit_series))
    live = ResidualMonitor(net, mode="closed").run(ids, hit_series, x_series)
    stale = ResidualMonitor(net, mode="closed").run(
        ids, np.full_like(hit_series, float(np.mean(hit_lo))), x_series)
    live_md = [a for a in live if a.kind == "model-drift"]
    stale_md = [a for a in stale if a.kind == "model-drift"]

    def arrival_series(burst):
        est = simulate_network(net, [0.7], n_requests=FD_OPEN_REQUESTS,
                               seeds=(seed,), arrival_rate=0.04,
                               max_in_system=512, burst=burst, sketch_cap=8,
                               window_us=2_000.0, device=device).sketches[0][0]
        return est.win_arrival_rate[est.win_done_count > 0]

    arr_p, arr_b = arrival_series(None), arrival_series((0.4, 10_000.0))
    ph_kw = dict(delta_slack=0.002, lam_threshold=0.02)
    return {
        "seed": seed,
        "quiet_alarm_kinds": sorted({a.kind for a in quiet}),
        "live_model_drift": len(live_md),
        "stale_model_drift": len(stale_md),
        "stale_lag_windows": (int(stale_md[0].window_id) - len(hit_lo)
                              if stale_md else None),
        "poisson_arrival_cv": float(arr_p.std() / arr_p.mean()),
        "burst_arrival_cv": float(arr_b.std() / arr_b.mean()),
        "poisson_alarms": len(page_hinkley_scan(arr_p, **ph_kw)),
        "burst_alarms": len(page_hinkley_scan(arr_b, **ph_kw)),
        "windows": [len(hit_lo), len(hit_hi), len(arr_p), len(arr_b)],
    }


def fig_drift_d_holds(d) -> bool:
    """fig_drift D's criteria on one seed's :func:`fig_drift_residuals`."""
    lag = d["stale_lag_windows"]
    return ("model-drift" not in d["quiet_alarm_kinds"]
            and d["stale_model_drift"] > 0 and d["live_model_drift"] == 0
            and lag is not None and 0 <= lag <= 16
            and d["burst_alarms"] > 0
            and d["burst_arrival_cv"] > d["poisson_arrival_cv"])


def fig_drift(device):
    """``benchmarks/fig_drift.py`` through the port, at its sizes and
    criteria: (A) the sketch_trace kernel against the exact twin on a
    24 000-key Zipf stream (windowed counters identical, count-min never
    under, top-16 recall >= 0.9 at sketch_cap 96); (B) the online profile
    sizing p* within 0.05 of the re-swept Mattson truth; (C) Page-Hinkley
    silent before a popularity churn and firing within 8 windows after it,
    each phase's online p* sizing within 0.05, and the undersized table
    reading saturated; (D) the residual monitor on the sketched closed
    loop (silent on live profiles, a model-drift alarm within 16 windows
    on a stale one) and Page-Hinkley on the sketched open loop's windowed
    arrival rate (ON-OFF alarms and is burstier than Poisson).  D runs on
    the counter engine, which draws other numbers than the reference's:
    it is held on FD_SEEDS simulation seeds, the script's seed 0 first,
    and must hold on every one of them."""
    import numpy as np
    from repro_torch.cache.replay import lru_sweep
    from repro_torch.core import build
    from repro_torch.core.harness import zipf_trace
    from repro_torch.latency import slo_forecast
    from repro_torch.obs.drift import page_hinkley_scan
    from repro_torch.obs.profile import observed_profile
    from repro_torch.obs.streaming import sketch_trace, sketch_trace_py

    out, seconds = {}, {}
    ks, th, win = FD_KEYS, FD_THETA, FD_WINDOW_US

    t0 = time.perf_counter()
    trace = zipf_trace(FD_STREAM, ks, th, seed=0)
    hits = np.asarray(lru_sweep(trace, [64])[0][0], np.int64)
    fast = sketch_trace(trace, hits=hits, sketch_cap=FD_CAP, window_us=win,
                        device=device)
    oracle = sketch_trace_py(trace, hits=hits, sketch_cap=FD_CAP,
                             window_us=win)
    probe = np.arange(ks)
    cm, truth = fast.cm_estimate(probe), oracle.cm_estimate(probe)
    true_top = set(probe[np.argsort(truth)[::-1][:16]].tolist())
    recall = len(true_top & set(fast.topk(16)[0].tolist())) / 16
    out["sketch_twin"] = {"recall_top16": recall,
                          "cm_underestimates": int((cm < truth).sum()),
                          "cm_overestimate_frac": float((cm > truth).mean()),
                          "saturation_frac": fast.saturation_frac(),
                          "ewma_hit_frac": fast.ewma_hit_frac}
    if not (np.array_equal(fast.window_id, oracle.window_id)
            and np.array_equal(fast.win_done_count, oracle.win_done_count)
            and np.array_equal(fast.win_arrival_rate, oracle.win_arrival_rate)
            and np.allclose(fast.win_hit_frac, oracle.win_hit_frac,
                            equal_nan=True)
            and abs(fast.ewma_hit_frac - oracle.ewma_hit_frac) < 1e-5
            and int((cm < truth).sum()) == 0 and recall >= 0.9):
        raise AssertionError(f"fig_drift A: {out['sketch_twin']}")
    seconds["A"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trace = zipf_trace(FD_STREAM, ks, th, seed=1)
    prof = observed_profile(sketch_trace(trace, sketch_cap=256, window_us=win,
                                         device=device), key_space=ks)
    net = build("lru", disk_us=100.0)
    p_star = net.p_star(grid=4001)
    cap_hat = prof.cap_of_p(p_star)
    warm = FD_STREAM // 4
    cap_grid = np.unique(np.clip(np.round(
        [cap_hat, prof.cap_of_p(0.5), prof.cap_of_p(0.7)]), 1, ks)).astype(int)
    sweep, _ = lru_sweep(trace, cap_grid)
    true_p = {int(c): float(np.asarray(sweep[i][warm:]).mean())
              for i, c in enumerate(cap_grid)}
    err_star = abs(true_p[int(round(np.clip(cap_hat, 1, ks)))] - p_star)
    max_err = max(abs(prof.p_of_cap(c) - p) for c, p in true_p.items())
    fc = slo_forecast(net, arrival_rate=0.05, slo_us=400.0, profile=prof)
    out["profile"] = {"p_star": p_star, "cap_hat": cap_hat,
                      "err_at_p_star": err_star, "hit_curve_max_err": max_err,
                      "slo_p_star_slo": fc.p_star_slo,
                      "caps_checked": cap_grid.tolist()}
    if not (err_star <= 0.05 and max_err <= 0.05 and fc.cap_grid is not None
            and len(fc.cap_grid) == len(fc.p_grid)):
        raise AssertionError(f"fig_drift B: {out['profile']}")
    seconds["B"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    half = FD_STREAM // 2
    t1 = zipf_trace(half, ks, th, seed=2)
    t2 = (zipf_trace(half, ks, 0.55, seed=3) + ks // 2) % ks
    series = _windowed_hit_frac(
        np.asarray(lru_sweep(np.concatenate([t1, t2]), [64])[0][0]), 500)
    churn_win, warm_w = half // 500, 4
    alarms = np.asarray(page_hinkley_scan(series[warm_w:], delta_slack=0.01,
                                          lam_threshold=0.25)) + warm_w
    pre, post = alarms[alarms < churn_win], alarms[alarms >= churn_win]
    phase_err = {}
    for name, tr in (("phase1", t1), ("phase2", t2)):
        prof = observed_profile(sketch_trace(tr, sketch_cap=ks, window_us=win,
                                             device=device), key_space=ks)
        cap = int(round(np.clip(prof.cap_of_p(p_star), 1, ks)))
        h = lru_sweep(tr, [cap])[0][0]
        phase_err[name] = abs(float(np.asarray(h[len(tr) // 4:]).mean())
                              - p_star)
    sat_small = sketch_trace(t2, sketch_cap=ks // 2, window_us=win,
                             device=device).saturation_frac()
    sat_full = sketch_trace(t2, sketch_cap=ks, window_us=win,
                            device=device).saturation_frac()
    lag = int(post[0] - churn_win) if len(post) else None
    out["churn"] = {"n_windows": len(series), "churn_window": churn_win,
                    "false_alarms": len(pre), "lag_windows": lag,
                    "p_star_err_phase1": phase_err["phase1"],
                    "p_star_err_phase2": phase_err["phase2"],
                    "saturation_undersized": sat_small,
                    "saturation_full": sat_full}
    if not (len(pre) == 0 and lag is not None and lag <= 8
            and max(phase_err.values()) <= 0.05 and sat_small > 5 * sat_full):
        raise AssertionError(f"fig_drift C: {out['churn']}")
    seconds["C"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = [fig_drift_residuals(device, s) for s in FD_SEEDS]
    held = [fig_drift_d_holds(d) for d in runs]
    out["residual"] = {"seeds": list(FD_SEEDS), "held": held, "runs": runs}
    print(f"fig_drift D: criteria hold on seeds "
          f"{[s for s, h in zip(FD_SEEDS, held) if h]} of {list(FD_SEEDS)} "
          f"(the script's seed 0: {held[0]}); stale lags "
          f"{[d['stale_lag_windows'] for d in runs]}, burst cv "
          f"{[round(d['burst_arrival_cv'], 3) for d in runs]} vs Poisson "
          f"{[round(d['poisson_arrival_cv'], 3) for d in runs]}", flush=True)
    if not all(held):
        raise AssertionError(f"fig_drift D: {out['residual']}")
    seconds["D"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def figures_path(rec, device="cuda"):
    """The delayed-hits, latency, cluster, hierarchy and streaming path:
    the qualitative assertions of ``benchmarks/table2_classify.py``,
    ``fig_delayed_hits.py``, ``fig_latency.py``, ``fig_cluster.py``,
    ``fig_hierarchy.py`` and ``fig_drift.py`` through the port (the
    machine with the card has no jax), at the benchmarks' sizes; each
    figure's wall seconds."""
    out, seconds = {}, {}
    for name, fn in (("table2_classify", table2_classify),
                     ("fig_delayed_hits", fig_delayed_hits),
                     ("fig_latency", fig_latency),
                     ("fig_cluster", fig_cluster),
                     ("fig_hierarchy", fig_hierarchy),
                     ("fig_drift", fig_drift)):
        t0 = time.perf_counter()
        out[name] = fn(device)
        seconds[name] = time.perf_counter() - t0
        parts = out[name].get("seconds", {}) if name != "table2_classify" else {}
        print(f"figure {name}: assertions hold ({seconds[name]:.3f} s; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()) + ")",
              flush=True)
    out["seconds"] = seconds
    rec["figures"] = out


def cluster_differential(rec, device="cuda"):
    """``tests/test_cluster.py``'s simulations through the port on the
    card: the 12-case matrix (LRU, FIFO, CLOCK x Zipf theta 0 and 1 x 1
    and 4 shards; 9k simulated requests on seeds 0 and 1, mpl 12 per
    shard, 8 flows per shard) and the six 16-shard cases (12k; the
    oracle 9k), each the kernel against the port's key-routing oracle
    (equal to the reference's: ``tests/test_torch_cluster.py``), averaged
    over ``CL_ORACLE_SEEDS``, within that file's bands (seed 3's own gap
    in X is recorded beside it); one of those cases again at 40k requests
    over 16 seeds a side, held within 4 standard errors
    (:func:`cluster_long_run`); the analytic bound over an uncoalesced run (the
    counting kernel), shard-local coalescing, and the open-loop cluster
    against the Erlang-C mixture at low load."""
    import numpy as np
    from repro_torch.cluster import (HashRing, cluster_network,
                                     ideal_shard_profile, simulate_cluster,
                                     simulate_cluster_py, zipf_key_probs)
    from repro_torch.core import exponential_analogue
    from repro_torch.core.simulator import simulate_network

    def skewed(n_shards, theta=1.0):
        probs = zipf_key_probs(1024, theta, seed=0)
        assign = HashRing(n_shards, vnodes=64, seed=1).assignment(1024)
        return probs, assign, ideal_shard_profile(assign, probs)

    cases = [(pol, th, n) for n in (1, 4) for pol in ("lru", "fifo", "clock")
             for th in (0.0, 1.0)]
    cases += [(pol, th, 16) for pol in ("lru", "fifo", "clock")
              for th in (0.0, 1.0)]
    out = {}
    for pol, theta, n in cases:
        n_sim, n_py = CL_DIFF_REQUESTS[n]
        probs, assign, prof = skewed(n, theta)
        cm = cluster_network(pol, n, profile=prof, disk_us=100.0, mpl=12 * n)
        jx = simulate_cluster(cm, [CL_P_OP], n_requests=n_sim, seeds=(0, 1),
                              coalesce_flows=8, device=device)
        runs = [simulate_cluster_py(cm, probs, assign, CL_P_OP,
                                    n_requests=n_py, seed=seed,
                                    coalesce_flows=8)
                for seed in CL_ORACLE_SEEDS]
        py = {k: np.nanmean([r[k] for r in runs], axis=0)
              for k in ("x", "shard_hit_ratio", "shard_share",
                        "shard_delayed_frac", "delayed_frac")}
        w = cm.profile.weights
        got = {"rel_x": abs(py["x"] - jx.throughput[0]) / py["x"],
               "hit_gap": float(np.nansum(w * np.abs(
                   jx.shard_hit_ratio[0] - py["shard_hit_ratio"]))),
               "share_gap": float(np.abs(py["shard_share"] - w).max()),
               "del_gap": float(np.nansum(w * np.abs(
                   jx.shard_delayed_frac[0] - py["shard_delayed_frac"]))),
               "delayed_gap": abs(float(jx.delayed_frac[0])
                                  - py["delayed_frac"]),
               "shard_sum_rel": abs(jx.shard_throughput[0].sum()
                                    - jx.throughput[0]) / jx.throughput[0]}
        limits = {"rel_x": 0.12, "hit_gap": 0.06, "share_gap": 0.08,
                  "del_gap": 0.06, "delayed_gap": 0.06, "shard_sum_rel": 0.02}
        bad = {k: v for k, v in got.items() if not v < limits[k]}
        what = f"{pol} theta={theta:g} {n} shards"
        if bad:
            raise AssertionError(f"cluster differential {what}: {bad} "
                                 f"(limits {limits})")
        out[what] = {k: float(v) for k, v in got.items()}
        out[what]["rel_x_seed3"] = float(abs(runs[0]["x"] - jx.throughput[0])
                                         / runs[0]["x"])
        print(f"cluster {what}: X {float(jx.throughput[0]):.4f} vs oracle "
              f"{float(py['x']):.4f} (rel {got['rel_x']:.3f}; seed 3 alone "
              f"{out[what]['rel_x_seed3']:.3f}), hit gap "
              f"{got['hit_gap']:.4f}, delayed gap {got['del_gap']:.4f}",
              flush=True)

    out["long_run"] = cluster_long_run(device)
    _, _, prof = skewed(4)
    cm = cluster_network("lru", 4, profile=prof, disk_us=100.0, mpl=96)
    jx = simulate_cluster(cm, [0.5, 0.8], n_requests=10_000, seeds=(0, 1),
                          device=device)
    ub = cm.throughput_upper(jx.p_hit)
    if not (np.all(jx.throughput <= ub * 1.03)
            and np.all(jx.delayed_frac == 0.0)):
        raise AssertionError(f"cluster bound: {jx.throughput} vs {ub}")
    out["bound"] = {"x": jx.throughput.tolist(), "upper": ub.tolist()}
    cm = cluster_network("lru", 4, profile=prof, disk_us=100.0, mpl=48)
    jx = simulate_cluster(cm, [0.6], n_requests=12_000, seeds=(0, 1, 2),
                          coalesce_flows=8, device=device)
    pk = prof.shard_p(0.6)
    hot, cold = int(np.argmax(pk)), int(np.argmin(pk))
    if not (jx.shard_delayed_frac[0, hot] < jx.shard_delayed_frac[0, cold]
            and jx.delayed_frac[0] > 0.05):
        raise AssertionError(f"cluster shard-local coalescing: "
                             f"{jx.shard_delayed_frac[0]}")
    out["shard_local_delayed"] = jx.shard_delayed_frac[0].tolist()
    cm = cluster_network("lru", 4, profile=prof, disk_us=100.0)
    lam = 0.35 * float(cm.lambda_max(0.7, tail_mode="nominal"))
    op = simulate_network(exponential_analogue(cm.network), [0.7],
                          arrival_rate=lam, n_requests=15_000, seeds=(0, 1),
                          max_in_system=256, device=device)
    want = float(cm.response_time(0.7, lam))
    rel = abs(op.sojourn_mean[0] - want) / want
    if not (np.all(op.drop_frac == 0.0) and rel < 0.1):
        raise AssertionError(f"cluster open loop: {op.sojourn_mean} vs {want}")
    out["open_mixture_rel"] = float(rel)
    rec["cluster_differential"] = out


def hierarchy_differential(rec, device="cuda"):
    """``tests/test_hierarchy.py``'s tiered simulations through the port
    (its 2 x 2 LRU hierarchy at mpl 16, F 2): the kernel at p 0.35 (8k
    requests, seeds 0 and 1) against the port's oracle (4k, seed 2) within
    rel 0.15 in X, 0.08 in the L1 and 0.05 in the L2 delayed fraction,
    the tier split summing to the delayed fraction; the level shares at p
    0.4 within 0.05 of ``level_fractions``; the analytic sigma1 within rel
    0.3 of the simulated one.  Then ``tests/test_properties.py``'s tiered
    twins, (p, F, seed) = (0.2, 2, 0), (0.5, 4, 1), (0.8, 2, 2), 10k
    requests a side, the means of HD_TWIN_SEEDS seeds a side within rel
    0.2 in X, 0.1 and 0.06 in the delayed fractions; and the case the
    reference fails there, (0.8393, 2, 0), held the same way."""
    import numpy as np
    from repro_torch.hierarchy import (hierarchy_network, simulate_hierarchy,
                                       simulate_hierarchy_py, tier_sigma_of)

    model = hierarchy_network("lru", "lru", **HD_MODEL)
    n_sim, n_py = HD_REQUESTS
    out = {}
    jx = simulate_hierarchy(model, [0.35], n_requests=n_sim, seeds=(0, 1),
                            coalesce_flows=2, device=device)
    py = simulate_hierarchy_py(model, 0.35, n_requests=n_py, seed=2,
                               coalesce_flows=2)
    got = {"rel_x": abs(jx.throughput[0] - py.throughput[0]) / py.throughput[0],
           "dl1_gap": abs(jx.delayed_l1_frac[0] - py.delayed_l1_frac[0]),
           "dl2_gap": abs(jx.delayed_l2_frac[0] - py.delayed_l2_frac[0])}
    split = max(abs(r.delayed_frac[0] - r.delayed_l1_frac[0]
                    - r.delayed_l2_frac[0]) for r in (jx, py))
    s1 = tier_sigma_of(model.coalesced(flows=2), 0.35)[0]
    sim_s1 = jx.delayed_l1_frac[0] / (1.0 - 0.35)
    lv = simulate_hierarchy(model, [0.4], n_requests=n_sim, seeds=(0,),
                            coalesce_flows=2, device=device)
    lv_gap = np.abs(lv.level_throughput[0] / lv.throughput[0]
                    - model.level_fractions(0.4)).max()
    out["twins"] = {k: float(v) for k, v in got.items()}
    out["twins"].update(split=float(split), x_sim=float(jx.throughput[0]),
                        x_oracle=float(py.throughput[0]),
                        sigma1=float(s1), sigma1_sim=float(sim_s1),
                        level_gap=float(lv_gap))
    if not (got["rel_x"] < 0.15 and got["dl1_gap"] < 0.08
            and got["dl2_gap"] < 0.05 and split < 1e-6
            and jx.delayed_l1_frac[0] > jx.delayed_l2_frac[0] > 0.0
            and abs(s1 - sim_s1) < 0.3 * abs(sim_s1) and lv_gap < 0.05
            and abs(lv.shard_throughput[0].sum()
                    - lv.level_throughput[0, 1:].sum())
            < 1e-6 * lv.throughput[0]):
        raise AssertionError(f"hierarchy differential: {out['twins']}")
    print(f"hierarchy twins p 0.35: X {jx.throughput[0]:.4f} vs oracle "
          f"{py.throughput[0]:.4f} (rel {got['rel_x']:.3f}), L1 gap "
          f"{got['dl1_gap']:.4f}, L2 gap {got['dl2_gap']:.4f}; sigma1 "
          f"{s1:.3f} vs {sim_s1:.3f}; levels within {lv_gap:.4f}",
          flush=True)
    for p, flows, seed in HD_TWIN_CASES + (HD_REFERENCE_FAILS,):
        seeds = tuple(range(seed, seed + HD_TWIN_SEEDS))
        res = simulate_hierarchy(model, [p], n_requests=HD_TWIN_REQUESTS,
                                 seeds=seeds, coalesce_flows=flows,
                                 device=device)
        refs = [simulate_hierarchy_py(model, p, n_requests=HD_TWIN_REQUESTS,
                                      seed=sd, coalesce_flows=flows)
                for sd in seeds]
        x = float(res.throughput[0])
        xr = float(np.mean([r.throughput[0] for r in refs]))
        case = {"x_sim": x, "x_oracle": xr, "seeds": len(seeds),
                "rel_x": abs(x - xr) / max(x, xr),
                "dl1_gap": abs(float(res.delayed_l1_frac[0]) - float(
                    np.mean([r.delayed_l1_frac[0] for r in refs]))),
                "dl2_gap": abs(float(res.delayed_l2_frac[0]) - float(
                    np.mean([r.delayed_l2_frac[0] for r in refs])))}
        out[f"p={p:g} F={flows} seed={seed}"] = case
        print(f"hierarchy twins p {p:g} F {flows} seed {seed}: X {x:.4f} vs "
              f"oracle {xr:.4f} ({len(seeds)} seeds a side, rel "
              f"{case['rel_x']:.3f}, band 0.2), L1 gap {case['dl1_gap']:.4f},"
              f" L2 gap {case['dl2_gap']:.4f}", flush=True)
        if not (case["rel_x"] < 0.2 and case["dl1_gap"] < 0.1
                and case["dl2_gap"] < 0.06):
            raise AssertionError(f"hierarchy twins {(p, flows, seed)}: {case}")
    rec["hierarchy_differential"] = out


def cluster_long_run(device="cuda", n_requests=CL_LONG_REQUESTS,
                     n_seeds=CL_LONG_SEEDS, n_se=CL_LONG_SE) -> dict:
    """The differential's LRU, theta 1, 4-shard case at ``n_requests``:
    ``simulate_cluster`` (the kernel on the card, its plain version on the
    CPU) over seeds 0 .. n_seeds - 1 against the key-routing oracle over
    seeds 3 .. n_seeds + 2; the two means must lie within ``n_se``
    standard errors of their difference (each side's error from its own
    seeds' spread).  Returns both sides' numbers."""
    import numpy as np
    from repro_torch.cluster import (HashRing, cluster_network,
                                     ideal_shard_profile, simulate_cluster,
                                     simulate_cluster_py, zipf_key_probs)

    probs = zipf_key_probs(1024, 1.0, seed=0)
    assign = HashRing(4, vnodes=64, seed=1).assignment(1024)
    cm = cluster_network("lru", 4, profile=ideal_shard_profile(assign, probs),
                         disk_us=100.0, mpl=48)
    jx = simulate_cluster(cm, [CL_P_OP], n_requests=n_requests,
                          seeds=tuple(range(n_seeds)), coalesce_flows=8,
                          device=device)
    xs = np.array([simulate_cluster_py(cm, probs, assign, CL_P_OP,
                                       n_requests=n_requests, seed=seed,
                                       coalesce_flows=8)["x"]
                   for seed in range(3, 3 + n_seeds)], dtype=np.float64)
    se_sim = float(jx.ci95[0]) / 1.96
    se_py = float(xs.std(ddof=1)) / math.sqrt(n_seeds)
    got = {"x_sim": float(jx.throughput[0]), "se_sim": se_sim,
           "x_oracle": float(xs.mean()), "se_oracle": se_py,
           "sd_oracle": float(xs.std(ddof=1)),
           "gap": abs(float(jx.throughput[0]) - float(xs.mean())),
           "band": n_se * math.hypot(se_sim, se_py),
           "n_requests": n_requests, "n_seeds": n_seeds}
    got["rel_x"] = got["gap"] / got["x_oracle"]
    print(f"cluster lru theta=1 4 shards, {n_requests} requests x "
          f"{n_seeds} seeds: X {got['x_sim']:.5f} (se {se_sim:.5f}) vs "
          f"oracle {got['x_oracle']:.5f} (se {se_py:.5f}): gap "
          f"{got['gap']:.5f}, band {got['band']:.5f} ({n_se:g} se)",
          flush=True)
    if not got["gap"] < got["band"]:
        raise AssertionError(f"cluster long run: {got}")
    return got


def ext_timing(rec):
    """The coalescing and open-loop instantiations timed per launch (CUDA
    events) on one lane of the figures' networks (fig_delayed_hits B at
    p 0.5 with 16 flows; fig_latency C at p 0.5), beside their plain
    versions on the same inputs (held identical: deterministic service in
    C's disk, and the draws of B's equal on the card) and the work's
    bound: its bytes, and its operations counted as if they ran in
    parallel, as for the event-sim row.  Also the figures' own launches
    (fig_delayed_hits B's 6 lanes, fig_latency B's 9) at FIG_REQUESTS, and
    the counting instantiation on one lane of fig_cluster C's 8-shard
    network (beside its plain version and bound, the closed kernel and the
    coalescing one on the same lane: ns per event at 8 shards); each
    mode's lane with the sketch; the coalescing, open-loop, tiered and
    8-shard coalescing lanes traced into lossless rings (kernel only; the
    coalescing lane's traced plain version too, held against the traced
    kernel and timed alone: the kernels line's traced row)."""
    import numpy as np
    import torch
    from repro_torch.core import build, exponential_analogue
    from repro_torch.kernels import event_sim as es
    from repro_torch.latency import lambda_max
    from test_torch_event_sim_cuda import (cluster_model, hierarchy_model,
                                           hold_coalesced, hold_open,
                                           hold_tiered, hold_trace_ext)

    dev = torch.device("cuda")

    def spec_bytes(spec, seeds, kw):
        return (sum(a.numel() * a.element_size() for a in spec)
                + sum(v.numel() * v.element_size() for v in kw.values()
                      if isinstance(v, torch.Tensor)) + seeds.numel() * 4)

    net_b = build("lru", disk_us=DH_DISK_US, disk_servers=DH_IO_DEPTH)
    spec, seeds, kw = es.grid_lanes(net_b, np.array([0.5]), EXT_TIMING_REQUESTS,
                                    (0,), 0.25, dev, coalesce_flows=16)
    co_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw), reps=5)
    kern = es.sim_lanes(spec, seeds, **kw)
    plain, co_plain_ms = timed_plain(lambda: es.sim_lanes_plain(spec, seeds,
                                                                **kw))
    rec["event_sim_coalesced_max_abs_err"] = max(
        rec["event_sim_coalesced_max_abs_err"],
        hold_coalesced(kern, plain, exact=False))
    mpl = kw["mpl"]
    co_events = int(kern.events.long().sum())
    # per event: the closed loop's work (two argmin passes, the rebase,
    # three draws and a service draw) and the flow compare over the jobs
    # and the flow draw
    co_bytes = spec_bytes(spec, seeds, kw) + 4 * (6 + 2 * spec.visits.shape[1])
    co_ops = co_events * (6 * mpl + 80)
    cb, cby = work_bound(co_bytes, co_ops)
    fig = es.grid_lanes(net_b, np.asarray(DH_P_SIM), FIG_REQUESTS, (0, 1),
                        0.25, dev, coalesce_flows=16)
    co_fig_ms = cuda_ms(lambda: es.sim_lanes(fig[0], fig[1], **fig[2]), reps=3)

    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations))
    ospec, oseeds, okw = es.open_lanes(net_c, np.array([0.5]),
                                       np.array([LAT_CO_LAMBDA]),
                                       EXT_TIMING_REQUESTS, (0,), 0.25, 256,
                                       coalesce_flows=LAT_CO_FLOWS,
                                       device=dev)
    open_ms = cuda_ms(lambda: es.sim_open_lanes(ospec, oseeds, **okw), reps=5)
    okern = es.sim_open_lanes(ospec, oseeds, **okw)
    oplain, open_plain_ms = timed_plain(
        lambda: es.sim_open_lanes_plain(ospec, oseeds, **okw))
    rec["event_sim_open_max_abs_err"] = max(
        rec["event_sim_open_max_abs_err"], hold_open(okern, oplain, exact=True))
    n_slots = okw["n_slots"]
    open_events = int(okern.events.long().sum())
    n_rec = okern.sojourn_us.shape[1]
    # the records: each written once, 5 bytes
    open_bytes = spec_bytes(ospec, oseeds, okw) + 5 * n_rec * oseeds.numel()
    # per event: the argmin passes, the ageing of every slot, the flow
    # compare, the free-slot ballot and the draws
    open_ops = open_events * (7 * n_slots + 90)
    ob, oby = work_bound(open_bytes, open_ops)
    lat = build("lru", disk_us=LAT_DISK_US)
    lam_b = LAT_SIM_LOAD * float(np.max(lambda_max(lat, np.linspace(0, 1, 201))))
    ofig = es.open_lanes(exponential_analogue(build("lru", disk_us=LAT_DISK_US_SIM)),
                         np.asarray(LAT_P_SIM), np.full(3, lam_b), FIG_REQUESTS,
                         (0, 1, 2), 0.25, 256, device=dev)
    open_fig_ms = cuda_ms(lambda: es.sim_open_lanes(ofig[0], ofig[1], **ofig[2]),
                          reps=3)

    # the counting instantiation at 8 shards: one lane of fig_cluster C's
    # network at its middle p, beside the closed kernel on the same lane
    # and the coalescing one with 8 flows per shard
    cm = cluster_model(CL_SHARDS, 12 * CL_SHARDS, key_space=CL_SIM_KEYS)
    cspec, cseeds, ckw = es.grid_lanes(cm.network, np.array([CL_SIM_P[1]]),
                                       EXT_TIMING_REQUESTS, (0,), 0.25, dev)
    cnt_ms = cuda_ms(lambda: es.sim_lanes(cspec, cseeds, count_branches=True,
                                          **ckw), reps=5)
    ckern = es.sim_lanes(cspec, cseeds, count_branches=True, **ckw)
    cplain, cnt_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(cspec, cseeds, count_branches=True, **ckw))
    rec["event_sim_count_max_abs_err"] = max(
        rec["event_sim_count_max_abs_err"],
        hold_coalesced(ckern, cplain, exact=False))
    closed_ms = cuda_ms(lambda: es.sim_lanes(cspec, cseeds, **ckw), reps=5)
    cnt_events = int(ckern.events.long().sum())
    # outputs: the closed loop's four and the delayed fraction, and two
    # counts per branch
    cnt_bytes = spec_bytes(cspec, cseeds, ckw) + 4 * (5 + 2 * cspec.visits.shape[1])
    # per event: the closed loop's work and the count's increment
    cnt_ops = cnt_events * (5 * ckw["mpl"] + 61)
    nb, nby = work_bound(cnt_bytes, cnt_ops)
    fspec, fseeds, fkw = es.grid_lanes(cm.network, np.array([CL_SIM_P[1]]),
                                       EXT_TIMING_REQUESTS, (0,), 0.25, dev,
                                       coalesce_flows=8)
    fl_ms = cuda_ms(lambda: es.sim_lanes(fspec, fseeds, **fkw), reps=5)
    fl_events = int(es.sim_lanes(fspec, fseeds, **fkw).events.long().sum())
    n_k = int(cspec.svc_ns.shape[1])

    # the tiered instantiation: one lane of fig_hierarchy's LRU-client
    # hierarchy (3 clients, 2 shards, mpl 96) at its middle p with 4 flows
    # per table, beside the closed, counting and coalescing kernels on the
    # same lane
    hm = hierarchy_model("fig", HI_MPL)
    hp = np.array([0.5 * sum(hm.profile.p_range())])
    tspec, tseeds, tkw = es.grid_lanes(hm.network, hp, EXT_TIMING_REQUESTS,
                                       (0,), 0.25, dev, coalesce_flows=4,
                                       tiers=hm.mshr)
    ti_ms = cuda_ms(lambda: es.sim_lanes(tspec, tseeds, **tkw), reps=5)
    tkern = es.sim_lanes(tspec, tseeds, **tkw)
    tplain, ti_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(tspec, tseeds, **tkw))
    rec["event_sim_tiers_max_abs_err"] = max(
        rec["event_sim_tiers_max_abs_err"],
        hold_tiered(tkern, tplain, exact=False))
    ti_events = int(tkern.events.long().sum())
    hspec, hseeds, hkw = es.grid_lanes(hm.network, hp, EXT_TIMING_REQUESTS,
                                       (0,), 0.25, dev)
    h_closed_ms = cuda_ms(lambda: es.sim_lanes(hspec, hseeds, **hkw), reps=5)
    h_count_ms = cuda_ms(lambda: es.sim_lanes(hspec, hseeds,
                                              count_branches=True, **hkw),
                         reps=5)
    h_events = int(es.sim_lanes(hspec, hseeds, **hkw).events.long().sum())
    fhspec, fhseeds, fhkw = es.grid_lanes(hm.network, hp, EXT_TIMING_REQUESTS,
                                          (0,), 0.25, dev, coalesce_flows=4)
    h_flows_ms = cuda_ms(lambda: es.sim_lanes(fhspec, fhseeds, **fhkw), reps=5)
    h_flows_events = int(es.sim_lanes(fhspec, fhseeds,
                                      **fhkw).events.long().sum())
    tables = tkw["tiers"]
    ti_bytes = (spec_bytes(tspec, tseeds, tkw)
                + sum(t.numel() * t.element_size() for t in tables[:3])
                + 4 * (5 + 2 * tspec.visits.shape[1] + tables.max_held))
    # per event: the closed loop's work and the count (as kCount), the
    # placement (three table reads, the flow draw) and the leader write;
    # per delayed hit (each measured one, at least): the cascade's mark and
    # its fresh request's draws
    n_delayed = int(round(float(tkern.delayed_frac[0])
                          * (int(tkern.completed[0]) - tkw["warmup"])))
    ti_ops = ti_events * (5 * tkw["mpl"] + 81) + 40 * n_delayed
    tb, tby = work_bound(ti_bytes, ti_ops)

    # the sketch's cost per event: each mode's lane above launched with the
    # sketch (sketch_cap 16, 1 ms windows) beside it without; the closed
    # loop (untraced and traced) on fig_drift D's lane (sketch_cap 8), whose
    # sketched launch is also held against its plain version
    def sk(kw):
        return dict(kw, sketch_cap=16, window_us=1_000.0)

    sketch_rows = {}

    def sketch_row(mode, fn, kw, off_ms, events):
        on_ms = cuda_ms(lambda: fn(**sk(kw)), reps=5)
        sketch_rows[mode] = {
            "off_ms": off_ms, "on_ms": on_ms, "events": events,
            "off_ns_per_event": off_ms * 1e6 / events,
            "on_ns_per_event": on_ms * 1e6 / events}

    sketch_row("counting, 8 shards",
               lambda **k: es.sim_lanes(cspec, cseeds, count_branches=True,
                                        **k),
               es.grid_lanes(cm.network, np.array([CL_SIM_P[1]]),
                             EXT_TIMING_REQUESTS, (0,), 0.25, dev,
                             sketch=True)[2], cnt_ms, cnt_events)
    sketch_row("coalescing", lambda **k: es.sim_lanes(spec, seeds, **k),
               es.grid_lanes(net_b, np.array([0.5]), EXT_TIMING_REQUESTS,
                             (0,), 0.25, dev, coalesce_flows=16,
                             sketch=True)[2], co_ms, co_events)
    sketch_row("open loop", lambda **k: es.sim_open_lanes(ospec, oseeds, **k),
               okw, open_ms, open_events)
    sketch_row("tiered", lambda **k: es.sim_lanes(tspec, tseeds, **k),
               es.grid_lanes(hm.network, hp, EXT_TIMING_REQUESTS, (0,), 0.25,
                             dev, coalesce_flows=4, tiers=hm.mshr,
                             sketch=True)[2], ti_ms, ti_events)
    dnet = build("lru", disk_us=100.0)
    dspec, dseeds, dkw = es.grid_lanes(dnet, np.array([FD_P[0]]),
                                       EXT_TIMING_REQUESTS, (0,), 0.25, dev,
                                       sketch=True)
    d_kw = dict(dkw, sketch_cap=8, window_us=1_000.0)
    d_off_ms = cuda_ms(lambda: es.sim_lanes(dspec, dseeds, **dkw), reps=5)
    d_ms = cuda_ms(lambda: es.sim_lanes(dspec, dseeds, **d_kw), reps=5)
    dkern = es.sim_lanes(dspec, dseeds, **d_kw)
    dplain, d_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(dspec, dseeds, **d_kw))
    hold_sim("sketched closed, fig_drift D's lane", dkern, dplain)
    # exponential service: the window boundaries may fall a last ulp apart,
    # so the totals are held (sketch_vs_plain holds every field on
    # deterministic service)
    for f in ("win_done_count", "win_hit_count", "key_count"):
        if int(getattr(dkern.sketch, f).sum()) != int(
                getattr(dplain.sketch, f).sum()):
            raise AssertionError(f"sketched closed kernel != plain: {f}")
    rec["event_sim_sketch_max_abs_err"] = max(
        rec.get("event_sim_sketch_max_abs_err", 0.0),
        float((dkern.x - dplain.x).abs().max()))
    d_events = int(dkern.events.long().sum())
    sketch_rows["closed"] = {
        "off_ms": d_off_ms, "on_ms": d_ms, "events": d_events,
        "off_ns_per_event": d_off_ms * 1e6 / d_events,
        "on_ns_per_event": d_ms * 1e6 / d_events}
    tr_kw = dict(dkw, trace_cap=64)
    tr_off_ms = cuda_ms(lambda: es.sim_lanes(dspec, dseeds, **tr_kw), reps=5)
    sketch_row("traced closed", lambda **k: es.sim_lanes(dspec, dseeds, **k),
               tr_kw, tr_off_ms, d_events)
    state_bytes = sum(t.numel() * t.element_size() for t in dkern.sketch)
    d_bytes = spec_bytes(dspec, dseeds, dkw) + 16 + state_bytes

    # tracing's cost per event in the coalescing, open-loop and tiered
    # modes: each mode's lane above launched traced into lossless rings
    # beside its untraced time (kernel only); the coalescing lane's is the
    # kernels line's traced row, its traced plain version timed here
    trace_rows = {}
    cap = 2 * EXT_TIMING_REQUESTS

    def trace_row(mode, fn, kw, off_ms, events):
        on_ms = cuda_ms(lambda: fn(**dict(kw, trace_cap=cap)), reps=5)
        trace_rows[mode] = {
            "off_ms": off_ms, "on_ms": on_ms, "events": events,
            "off_ns_per_event": off_ms * 1e6 / events,
            "on_ns_per_event": on_ms * 1e6 / events}
        return on_ms

    tr_co_kw = es.grid_lanes(net_b, np.array([0.5]), EXT_TIMING_REQUESTS, (0,),
                             0.25, dev, coalesce_flows=16, trace=cap)[2]
    tr_co_ms = trace_row("coalescing",
                         lambda **k: es.sim_lanes(spec, seeds, **k), tr_co_kw,
                         co_ms, co_events)
    tr_kern = es.sim_lanes(spec, seeds, **tr_co_kw)
    tr_plain, tr_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(spec, seeds, **tr_co_kw))
    rec["event_sim_traced_ext_max_abs_err"] = max(
        rec["event_sim_traced_ext_max_abs_err"],
        hold_trace_ext(tr_kern, tr_plain, kern, exact=False))
    trace_row("open loop", lambda **k: es.sim_open_lanes(ospec, oseeds, **k),
              okw, open_ms, open_events)
    trace_row("tiered", lambda **k: es.sim_lanes(tspec, tseeds, **k),
              es.grid_lanes(hm.network, hp, EXT_TIMING_REQUESTS, (0,), 0.25,
                            dev, coalesce_flows=4, tiers=hm.mshr,
                            trace=cap)[2], ti_ms, ti_events)
    trace_row("coalescing, 8 shards",
              lambda **k: es.sim_lanes(fspec, fseeds, **k),
              es.grid_lanes(cm.network, np.array([CL_SIM_P[1]]),
                            EXT_TIMING_REQUESTS, (0,), 0.25, dev,
                            coalesce_flows=8, trace=cap)[2], fl_ms, fl_events)
    # the rings' bytes: each record written once (five words and two stamp
    # rows), the emitted count, and the miss classes read
    tr_bytes = (co_bytes + 4 * (1 + spec.visits.shape[1])
                + int(kern.completed[0]) * 4 * (5 + 2 * spec.visits.shape[2]))
    trb, trby = work_bound(tr_bytes, co_ops)
    # per event: the closed loop's work (as kCount) and the sketch's tick,
    # window counts and EWMA steps
    d_ops = d_events * (5 * dkw["mpl"] + 61 + 30)
    d_work, d_work_by = work_bound(d_bytes, d_ops)
    # its chain: each event's warp collectives (CLOSED_CHAIN) at their
    # latencies, probed; far above its bytes and operations
    chase = build_chase()
    red = redux_latency(chase)
    shf = redux_latency(chase, "shfl")
    d_chain_ns = (CLOSED_CHAIN["redux"] * red["ns"]
                  + CLOSED_CHAIN["shfl"] * shf["ns"])
    d_chain_ms = d_events * d_chain_ns * 1e-6
    db, dby = max((d_work, d_work_by), (d_chain_ms, "operations"))

    # the sketch_trace kernel on fig_drift A's stream at each of
    # fig_drift's caps, in turns with its S = 0 instantiation (the table in
    # device memory) on the same inputs and held equal to it, beside its
    # chain bound (one warp reduction per key); at A's cap also beside the
    # plain torch loop on the card
    from repro_torch.kernels import sketch as ksk

    fkeys, ft, fhits = fig_drift_stream(dev)
    chain_ms = FD_STREAM * red["ns"] * 1e-6
    st_rows = {}
    for st_cap in FD_CAPS:
        form = ksk.sketch_trace_form(st_cap, FD_STREAM)
        runs = {form: [], (0, False): []}
        for f in (form, (0, False), (0, False), form):
            runs[f].append(cuda_ms(lambda f=f: ksk.sketch_trace_lanes(
                fkeys, ft, fhits, sketch_cap=st_cap, window_us=FD_WINDOW_US,
                form=f), reps=5))
        a, b = (ksk.sketch_trace_lanes(fkeys, ft, fhits, sketch_cap=st_cap,
                                       window_us=FD_WINDOW_US, form=f)
                for f in runs)
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"sketch_trace S={form[0]} != S=0 at "
                                     f"cap {st_cap}: {f}")
        ms, s0_ms = (sum(v) / len(v) for v in runs.values())
        st_rows[st_cap] = {
            "slots": form[0], "packed": form[1], "ms": ms,
            "ms_runs": runs[form], "ns_per_key": ms * 1e6 / FD_STREAM,
            "s0_ms": s0_ms, "s0_ms_runs": runs[(0, False)],
            "s0_ns_per_key": s0_ms * 1e6 / FD_STREAM,
            "chain_bound_ms": chain_ms, "chain_share": chain_ms / ms}
    st_kw = dict(sketch_cap=FD_CAP, window_us=FD_WINDOW_US)
    st_ms = st_rows[FD_CAP]["ms"]
    st_kern = ksk.sketch_trace_lanes(fkeys, ft, fhits, **st_kw)
    st_plain, st_plain_ms = timed_plain(
        lambda: ksk.sketch_trace_plain(fkeys, ft, fhits, **st_kw))
    for f in st_kern._fields:
        if not torch.equal(getattr(st_kern, f), getattr(st_plain, f)):
            raise AssertionError(f"sketch_trace kernel != plain: {f}")
    st_bytes = 12 * FD_STREAM + sum(t.numel() * t.element_size()
                                    for t in st_kern)
    # per key: the SpaceSaving search (a compare of each slot's key and
    # count), four count-min hashes, the tick and the EWMA steps
    st_ops = FD_STREAM * (2 * FD_CAP + 60)
    st_work, st_work_by = work_bound(st_bytes, st_ops)
    # the keys' chain of warp reductions, far above bytes and operations
    sb, sby = max((st_work, st_work_by), (chain_ms, "operations"))
    out = {
        "count_8_shards": {
            "ms": cnt_ms, "plain_ms": cnt_plain_ms, "events": cnt_events,
            "ns_per_event": cnt_ms * 1e6 / cnt_events,
            "closed_ms": closed_ms,
            "closed_ns_per_event": closed_ms * 1e6 / cnt_events,
            "coalesced_ms": fl_ms, "coalesced_events": fl_events,
            "coalesced_ns_per_event": fl_ms * 1e6 / fl_events,
            "stations": n_k, "mpl": ckw["mpl"], "bytes": cnt_bytes,
            "ops": cnt_ops, "bound_ms": nb,
            "requests": EXT_TIMING_REQUESTS},
        "coalesced": {"ms": co_ms, "plain_ms": co_plain_ms, "events": co_events,
                      "ns_per_event": co_ms * 1e6 / co_events,
                      "bytes": co_bytes, "ops": co_ops, "bound_ms": cb,
                      "fig_b_launch_ms": co_fig_ms,
                      "requests": EXT_TIMING_REQUESTS},
        "open": {"ms": open_ms, "plain_ms": open_plain_ms,
                 "events": open_events, "ns_per_event": open_ms * 1e6 / open_events,
                 "bytes": open_bytes, "ops": open_ops, "bound_ms": ob,
                 "fig_b_launch_ms": open_fig_ms,
                 "requests": EXT_TIMING_REQUESTS},
        "tiers": {"ms": ti_ms, "plain_ms": ti_plain_ms, "events": ti_events,
                  "ns_per_event": ti_ms * 1e6 / ti_events,
                  "delayed_hits": n_delayed, "p": float(hp[0]),
                  "closed_ms": h_closed_ms, "count_ms": h_count_ms,
                  "closed_events": h_events,
                  "closed_ns_per_event": h_closed_ms * 1e6 / h_events,
                  "count_ns_per_event": h_count_ms * 1e6 / h_events,
                  "coalesced_ms": h_flows_ms,
                  "coalesced_events": h_flows_events,
                  "coalesced_ns_per_event": h_flows_ms * 1e6 / h_flows_events,
                  "stations": int(tspec.svc_ns.shape[1]), "mpl": tkw["mpl"],
                  "bytes": ti_bytes, "ops": ti_ops, "bound_ms": tb,
                  "requests": EXT_TIMING_REQUESTS},
        "sketch": {"ms": d_ms, "plain_ms": d_plain_ms, "bytes": d_bytes,
                   "ops": d_ops, "work_bound_ms": d_work, "bound_ms": db,
                   "chain": CLOSED_CHAIN, "shfl": shf, "redux": red,
                   "chain_ns_per_event": d_chain_ns,
                   "chain_bound_ms": d_chain_ms,
                   "chain_share": d_chain_ms / d_ms,
                   "off_chain_share": d_chain_ms / d_off_ms,
                   "per_mode": sketch_rows, "requests": EXT_TIMING_REQUESTS},
        "traced": {"ms": tr_co_ms,
                   "plain_ms": tr_plain_ms,
                   "bytes": tr_bytes, "ops": co_ops, "bound_ms": trb,
                   "per_mode": trace_rows, "ring_cap": cap,
                   "requests": EXT_TIMING_REQUESTS},
        "sketch_trace": {"ms": st_ms, "plain_ms": st_plain_ms,
                         "keys": FD_STREAM, "sketch_cap": FD_CAP,
                         "ns_per_key": st_ms * 1e6 / FD_STREAM,
                         "bytes": st_bytes, "ops": st_ops,
                         "work_bound_ms": st_work, "redux": red,
                         "chain_bound_ms": chain_ms, "bound_ms": sb,
                         "per_cap": st_rows}}
    c8 = out["count_8_shards"]
    print(f"event_sim count, {CL_SHARDS} shards (K {n_k}, mpl {ckw['mpl']}): "
          f"{cnt_ms:.3f} ms per 1-lane launch ({c8['ns_per_event']:.1f} ns per "
          f"event), plain {cnt_plain_ms:.1f} ms, bound {nb:.5f} ms; the closed "
          f"kernel on the same lane {c8['closed_ns_per_event']:.1f} ns per "
          f"event, the coalescing one (8 flows per shard) "
          f"{c8['coalesced_ns_per_event']:.1f} ns per event", flush=True)
    print(f"event_sim coalesced: {co_ms:.3f} ms per 1-lane launch "
          f"({out['coalesced']['ns_per_event']:.1f} ns per event), plain "
          f"{co_plain_ms:.1f} ms, bound {cb:.5f} ms; fig_delayed_hits B's "
          f"launch {co_fig_ms:.3f} ms", flush=True)
    t8 = out["tiers"]
    print(f"event_sim tiers, fig_hierarchy's lane (K {t8['stations']}, mpl "
          f"{tkw['mpl']}, F 4, p {hp[0]:.4f}): {ti_ms:.3f} ms per 1-lane "
          f"launch ({t8['ns_per_event']:.1f} ns per event), plain "
          f"{ti_plain_ms:.1f} ms, bound {tb:.5f} ms; on the same lane the "
          f"closed kernel {t8['closed_ns_per_event']:.1f}, the counting one "
          f"{t8['count_ns_per_event']:.1f}, the coalescing one "
          f"{t8['coalesced_ns_per_event']:.1f} ns per event", flush=True)
    print(f"event_sim open: {open_ms:.3f} ms per 1-lane launch "
          f"({out['open']['ns_per_event']:.1f} ns per event), plain "
          f"{open_plain_ms:.1f} ms, bound {ob:.5f} ms; fig_latency B's "
          f"launch {open_fig_ms:.3f} ms", flush=True)
    for mode, r in sketch_rows.items():
        print(f"event_sim sketch, {mode}: {r['off_ns_per_event']:.1f} ns per "
              f"event without the sketch, {r['on_ns_per_event']:.1f} with it "
              f"({r['on_ns_per_event'] - r['off_ns_per_event']:+.1f}; "
              f"{r['events']} events; the sketch "
              f"{SKETCH_DESIGN.get(mode, 'in place')})", flush=True)
    for mode, r in trace_rows.items():
        print(f"event_sim traced, {mode}: {r['off_ns_per_event']:.1f} ns per "
              f"event untraced, {r['on_ns_per_event']:.1f} traced "
              f"({r['events']} events)", flush=True)
    print(f"event_sim traced coalescing, fig_delayed_hits B's lane: "
          f"{tr_co_ms:.3f} ms per 1-lane launch, plain "
          f"{tr_plain_ms:.1f} ms, "
          f"bound {trb:.5f} ms", flush=True)
    print(f"event_sim sketched closed, fig_drift D's lane: {d_ms:.3f} ms per "
          f"1-lane launch, plain {d_plain_ms:.1f} ms, bound {db:.5f} ms "
          f"(chain: {d_events} events of {CLOSED_CHAIN['redux']} warp "
          f"reductions of {red['ns']:.2f} ns and {CLOSED_CHAIN['shfl']} "
          f"shuffle of {shf['ns']:.2f} ns, {shf['cycles']:.1f} cycles; bytes "
          f"and operations {d_work:.5f} ms): {d_chain_ms / d_ms:.3f} of it "
          f"reached; the unsketched closed kernel on the same lane "
          f"{d_off_ms:.3f} ms, {d_chain_ms / d_off_ms:.3f}", flush=True)
    print(f"sketch_trace, fig_drift A's stream: {st_ms:.3f} ms per launch "
          f"({out['sketch_trace']['ns_per_key']:.1f} ns per key), plain "
          f"{st_plain_ms:.1f} ms, bound {sb:.5f} ms (chain: {FD_STREAM} "
          f"warp reductions of {red['ns']:.2f} ns, {red['cycles']:.1f} "
          f"cycles; bytes and operations {st_work:.5f} ms)", flush=True)
    for st_cap, r in st_rows.items():
        print(f"sketch_trace at cap {st_cap} (S={r['slots']}, "
              f"{SKETCH_FORMS[r['packed']]}): {r['ms']:.3f} ms "
              f"({r['ns_per_key']:.1f} ns per key; runs {r['ms_runs']}), "
              f"S=0 on the same inputs {r['s0_ms']:.3f} ms "
              f"({r['s0_ns_per_key']:.1f} ns per key; runs {r['s0_ms_runs']})"
              f"; {r['chain_share']:.3f} of the chain bound", flush=True)
    rec["ext_timing"] = out
    return [
        {"name": "event_sim_coalesced", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/core/simulator.py:162",
         "ms": co_ms, "plain_ms": co_plain_ms, "bound_ms": cb,
         "bound_by": cby, "library_ms": None},
        {"name": "event_sim_open", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/core/simulator.py:846",
         "ms": open_ms, "plain_ms": open_plain_ms, "bound_ms": ob,
         "bound_by": oby, "library_ms": None},
        {"name": "event_sim_count", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/core/simulator.py:162",
         "ms": cnt_ms, "plain_ms": cnt_plain_ms, "bound_ms": nb,
         "bound_by": nby, "library_ms": None},
        {"name": "event_sim_tiers", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/core/simulator.py:483",
         "ms": ti_ms, "plain_ms": ti_plain_ms, "bound_ms": tb,
         "bound_by": tby, "library_ms": None},
        {"name": "event_sim_traced_ext", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim_traced.cu",
         "replaces": "src/repro/core/simulator.py:273",
         "ms": tr_co_ms, "plain_ms": tr_plain_ms,
         "bound_ms": trb, "bound_by": trby, "library_ms": None},
        {"name": "event_sim_sketch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim_sketch.cu",
         "replaces": "src/repro/core/simulator.py:162",
         "ms": d_ms, "plain_ms": d_plain_ms, "bound_ms": db,
         "bound_by": dby, "library_ms": None},
        {"name": "sketch_trace", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sketch_trace.cu",
         "replaces": "src/repro/obs/streaming.py:408",
         "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": sb,
         "bound_by": sby, "library_ms": None},
    ]


def hold_trace(what, kern, plain, visits, exact) -> float:
    """Raise unless the decoded trace records of every lane agree field by
    field (stamps NaN-aware: exactly, or within SIM_RTOL); returns the
    largest stamp difference."""
    import numpy as np
    import torch
    from repro_torch.obs.trace import decode_trace_grid

    torch.cuda.synchronize()
    if not torch.equal(kern.rings.n_count, kern.completed):
        raise AssertionError(f"traced kernel: n_emitted != completed ({what})")
    n_l = kern.x.shape[0]
    err = 0.0
    for a, b in zip(decode_trace_grid(kern.rings, visits, 1, n_l)[0],
                    decode_trace_grid(plain.rings, visits, 1, n_l)[0]):
        if a.n_emitted != b.n_emitted or len(a) != len(b):
            raise AssertionError(f"trace record counts differ ({what})")
        for f in ("req", "branch", "cls", "nvis", "station"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"traced kernel != plain: {what} {f}")
        for f in ("parked_us", "enter_us", "leave_us"):
            x, y = getattr(a, f), getattr(b, f)
            if exact:
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
            else:
                np.testing.assert_allclose(x, y, rtol=SIM_RTOL,
                                           err_msg=f"{what} {f}")
            if x.size:
                err = max(err, float(np.nanmax(np.abs(x - y), initial=0.0)))
    print(f"event_sim_traced {what}: records identical in req/branch/cls/"
          f"nvis/station, max |d stamp| = {err:.3g} us", flush=True)
    return err


def check_trace(rec):
    """The traced kernel against its traced plain version, and against the
    untraced kernel, on the det and the LRU network (21 lanes x 2000
    requests, 512-record rings: every ring overflows)."""
    import numpy as np
    import torch
    from repro_torch.core.policy_models import lru_network
    from repro_torch.kernels import event_sim as es

    nets = {"det network": det_network(lru_network(disk_us=20.0)),
            "lru network": lru_network(disk_us=100.0)}
    err = 0.0
    for what, net in nets.items():
        spec, seeds, kw = es.grid_lanes(
            net, np.asarray(P_GRID), TRACE_CHECK_REQUESTS, SEEDS, 0.25,
            torch.device("cuda"), trace=TRACE_CHECK_CAP)
        kern = es.sim_lanes(spec, seeds, **kw)
        bare = es.sim_lanes(spec, seeds, **untraced(kw))
        plain = es.sim_lanes_plain(spec, seeds, **kw)
        torch.cuda.synchronize()
        for f in ("x", "completed", "events", "t_measured"):
            if not torch.equal(getattr(kern, f), getattr(bare, f)):
                raise AssertionError(f"traced kernel != untraced: {what} {f}")
        print(f"event_sim_traced {what}: x/completed/events == untraced "
              "kernel (bit-identical)", flush=True)
        hold_sim(f"traced {what}", kern, plain)
        err = max(err, hold_trace(what, kern, plain, spec.visits[0],
                                  exact=what.startswith("det")))
    rec["event_sim_traced_max_abs_err"] = max(
        rec.get("event_sim_traced_max_abs_err", 0.0), err)


def lru_inputs(n_slots, n_acc, padded, seed):
    """Timestamps with many ties and a batch of ids on the card; padded
    batches repeat ids and end in -1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 64, n_slots).astype(np.int32)
    acc = rng.choice(n_slots, n_acc, replace=False).astype(np.int32)
    if padded:
        acc[n_acc // 2: 3 * n_acc // 4] = acc[: n_acc // 4]
        acc[3 * n_acc // 4:] = -1
    return (torch.from_numpy(ts).cuda(), torch.from_numpy(acc).cuda())


def check_lru_update(rec):
    """The LRU-update kernel against its plain version, bit for bit, at
    three shapes.  The largest one is timed on the device (``device_ms``)
    beside the library calls ``index_fill_`` + ``argmin``, with an empty
    batch (the sweep without the marking of ids) and per kernel under
    ``torch.profiler``; the plain version and the wrapper, which
    synchronise, and the bare launch by CUDA events around calls made one
    after another (the host's cost per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cache_update as cu

    err = 0
    for i, (n_slots, n_acc, padded) in enumerate(LRU_SHAPES):
        ts, acc = lru_inputs(n_slots, n_acc, padded, seed=i)
        new_ts, victim = cu.lru_update(ts, acc, 99_999)
        want_ts, want_victim = cu.lru_update_plain(ts, acc, 99_999)
        torch.cuda.synchronize()
        err = max(err, int((new_ts - want_ts).abs().max()),
                  int(victim != want_victim))
        if not (torch.equal(new_ts, want_ts) and torch.equal(victim, want_victim)):
            raise AssertionError(f"LRU-update kernel != plain at C={n_slots}, "
                                 f"N={n_acc}")
        print(f"lru_batch_update C={n_slots} N={n_acc} padded={padded}: "
              f"kernel == plain (victim {int(victim)})", flush=True)
    # the largest shape, unpadded: one index_fill_ and one argmin compute
    # the same function
    idx = acc.long()
    empty = acc[:0]
    rec["lru_batch_update_max_abs_err"] = err
    timing = {
        "shape": [n_slots, n_acc],
        "ms": device_ms(lambda: cu.launch(ts, acc, 99_999), reps=50),
        "empty_batch_ms": device_ms(lambda: cu.launch(ts, empty, 99_999),
                                    reps=50),
        "library_ms": device_ms(lambda: torch.argmin(
            ts.clone().index_fill_(0, idx, 99_999)), reps=50),
        "launch_host_ms": cuda_ms(lambda: cu.launch(ts, acc, 99_999), reps=50),
        "wrapper_ms": cuda_ms(lambda: cu.lru_update(ts, acc, 99_999), reps=50),
        "plain_ms": cuda_ms(lambda: cu.lru_update_plain(ts, acc, 99_999),
                            reps=50),
        "bytes": 8 * n_slots + 4 * n_acc,
    }
    for what, batch in (("by_kernel_us", acc), ("empty_batch_by_kernel_us", empty)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                cu.launch(ts, batch, 99_999)
            torch.cuda.synchronize()
        timing[what] = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                name = ("sweep_kernel" if "sweep_kernel" in ev.key else
                        "argmin_kernel" if "argmin_kernel" in ev.key else
                        ev.key[:48])
                timing[what][name] = us / 20
    print("lru_batch_update C=2**22 N=4096: " + json.dumps(
        {k: v for k, v in timing.items() if k != "shape"}), flush=True)
    rec["lru_timing"] = timing


def main_path(rec):
    import numpy as np
    from repro_torch.core.harness import sweep_cache_sizes
    from repro_torch.core.policy_models import fifo_network, lru_network
    from repro_torch.core.simulator import simulate_network

    out = {"lru_sim": {}, "sweeps": {}}
    for disk in DISKS:
        sim = simulate_network(lru_network(disk_us=disk), P_GRID,
                               n_requests=16_000, seeds=(0, 1, 2))
        x = sim.throughput
        if x.shape != (len(P_GRID),) or not np.isfinite(x).all():
            raise AssertionError(f"bad LRU simulation at disk={disk}: {x}")
        if not x[-1] < max(x):
            raise AssertionError(f"no LRU inversion at disk={disk}: {x}")
        out["lru_sim"][disk] = {"x": x.tolist(), "ci95": sim.ci95.tolist()}
        print(f"lru disk={disk}: X(p) = {np.round(x.astype(float), 4).tolist()} "
              f"(inversion: X(0.99) < max)", flush=True)
    fifo = simulate_network(fifo_network(disk_us=100.0), P_GRID,
                            n_requests=16_000, seeds=(0, 1, 2)).throughput
    if not np.all(np.diff(fifo) > -0.02 * fifo[:-1]):
        raise AssertionError(f"FIFO throughput not monotone: {fifo}")
    out["fifo_sim"] = fifo.tolist()
    for policy, params in POLICY_PARAMS.items():
        kw = {} if policy == "lru" else {"miss_latency_requests": 8}
        sweep = sweep_cache_sizes(policy, IMPL_CAPS, key_space=4096,
                                  n_requests=60_000, simulate=True,
                                  sim_requests=16_000, **kw, **params)
        for k, v in sweep.items():
            if v.shape != (len(IMPL_CAPS),) or not np.isfinite(v).all():
                raise AssertionError(f"bad sweep column {policy}.{k}: {v}")
        if not np.all(np.diff(sweep["p_hit"]) > 0):
            raise AssertionError(f"{policy}: p_hit not increasing with size")
        if policy == "fifo" and not np.all(np.diff(sweep["x_bound"]) > -1e-9):
            raise AssertionError(f"FIFO bound not monotone: {sweep['x_bound']}")
        out["sweeps"][policy] = {k: v.tolist() for k, v in sweep.items()}
        print(f"sweep {policy}: p_hit {np.round(sweep['p_hit'].astype(float), 4).tolist()} "
              f"x_sim {np.round(sweep['x_sim'], 4).tolist()}", flush=True)
    rec["main_path"] = out


def hold_main_path(rec, launches):
    """The main path launched the event-sim kernel once per simulated grid
    and once per sweep and the replay kernel once per sweep, reproduced
    ``MAIN_PATH_X`` and each sweep's hit counts (``MAIN_PATH_HITS``)."""
    import numpy as np

    want = {"event_sim": len(DISKS) + 1 + len(POLICY_PARAMS),
            "replay": len(POLICY_PARAMS)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"the main path launched the {name} kernel "
                                 f"{launches[name]} times, not {n}")
    got = rec["main_path"]
    for policy, hits in MAIN_PATH_HITS.items():
        p_hit = got["sweeps"][policy]["p_hit"]
        if p_hit != [h / MAIN_PATH_MEASURED for h in hits]:
            raise AssertionError(f"{policy} sweep: p_hit {p_hit} is not "
                                 f"{hits} over {MAIN_PATH_MEASURED}")
    pairs = [(f"lru disk={d}", got["lru_sim"][d]["x"], x)
             for d, x in MAIN_PATH_X["lru_sim"].items()]
    pairs.append(("fifo", got["fifo_sim"], MAIN_PATH_X["fifo_sim"]))
    pairs += [(f"{p} sweep x_sim", got["sweeps"][p]["x_sim"], x)
              for p, x in MAIN_PATH_X["x_sim"].items()]
    worst = 0.0
    for what, x, ref in pairs:
        np.testing.assert_allclose(x, ref, rtol=MAIN_PATH_RTOL, err_msg=what)
        worst = max(worst, float(np.max(np.abs(np.subtract(x, ref))
                                        / np.abs(ref))))
    print(f"main path: {launches['event_sim']} event-sim and "
          f"{launches['replay']} replay launches; every sweep's p_hit equal "
          f"to the earlier kernel's hit counts; every throughput within "
          f"{MAIN_PATH_RTOL} of the earlier kernel's (largest relative "
          f"difference {worst:.3g})", flush=True)
    rec["main_path_vs_earlier_kernel"] = {"launches": dict(launches),
                                          "max_rel_diff": worst}


def hold_traced_lanes(what, traces, twin, warmup, jobs, n_b, names,
                      open_loop=False):
    """The lossless rings an entry point decoded onto its result
    (``traces``, ``[seed][p]``) against the per-lane counts of ``twin``,
    an untraced launch of the same lanes (lane ``s * P + p``; tracing is
    inert, so its counts are the traced launch's): each lane's records are
    exactly its completions 0..n-1; in the closed modes, from the warmup
    snapshot (``warmup`` .. ``warmup + jobs``: a fill may carry it past
    ``warmup``) the per-branch record counts are ``branch_done`` and the
    delayed records the delayed count, in the open loop each record's
    class is the one its completion index holds in the class buffer;
    ``parked_us`` is 0 on every record not delayed; every visit is left
    after it is entered.  Lane 0 goes to Perfetto and back: a slice per
    visit and per parked interval, a request per record, its delayed ones
    counted.  Returns what the records give the result (the closed modes:
    per-branch and delayed rates of the ``n_b`` branches over each lane's
    measured window and its delayed fraction, ``(S, P, ...)``; the open
    loop: per p the classes and sojourns of the records from ``warmup``
    on, every seed's pooled) and a summary."""
    import numpy as np
    from repro_torch.obs.export import (read_perfetto, summarize_events,
                                        write_perfetto)
    from repro_torch.obs.trace import CLS_DELAYED

    t0 = time.perf_counter()
    n_s, n_p = len(traces), len(traces[0])
    comp = twin.completed.cpu().numpy()
    rates = np.zeros((n_s, n_p, n_b))
    dl_rates = np.zeros((n_s, n_p, n_b))
    dl_frac = np.zeros((n_s, n_p))
    pooled = [([], []) for _ in range(n_p)]
    n_rec = n_delayed = 0
    for lane in range(n_s * n_p):
        s, p = divmod(lane, n_p)
        tr = traces[s][p]
        n = int(comp[lane])
        if (tr.n_emitted != n or tr.n_dropped
                or not np.array_equal(tr.req, np.arange(n))):
            raise AssertionError(f"{what} lane {lane}: {tr.n_emitted} records "
                                 f"emitted, {len(tr)} kept, {n} completed")
        if open_loop:
            if not np.array_equal(tr.cls, twin.cls[lane, :n].cpu().numpy()):
                raise AssertionError(f"{what} lane {lane}: record classes != "
                                     "the class buffer's")
            n_delayed += int((tr.cls == CLS_DELAYED).sum())
            pooled[p][0].append(tr.cls[warmup:])
            pooled[p][1].append(tr.sojourn_us[warmup:])
        else:
            done_b = twin.branch_done[lane].cpu().numpy()
            warm = n - int(done_b.sum())
            m = tr.req >= warm
            dl = m & (tr.cls == CLS_DELAYED)
            if not (warmup <= warm < warmup + jobs and np.array_equal(
                    np.bincount(tr.branch[m], minlength=len(done_b)), done_b)
                    and int(dl.sum()) == int(twin.branch_delayed[lane].sum())):
                raise AssertionError(f"{what} lane {lane}: records do not "
                                     "reconcile with the counts")
            n_delayed += int(dl.sum())
            # the measured window: from the event that took the warmup
            # snapshot (its records end then) to the last completion
            end = tr.end_us
            t_meas = end[n - 1] - end[warm - 1]
            rates[s, p] = np.bincount(tr.branch[m], minlength=n_b)[:n_b] / t_meas
            dl_rates[s, p] = np.bincount(tr.branch[dl], minlength=n_b)[:n_b] / t_meas
            dl_frac[s, p] = dl.sum() / m.sum()
        live = np.arange(tr.enter_us.shape[1])[None, :] < tr.nvis[:, None]
        if ((tr.parked_us[tr.cls != CLS_DELAYED] != 0).any()
                or not (tr.leave_us[live] >= tr.enter_us[live]).all()):
            raise AssertionError(f"{what} lane {lane}: stamps malformed")
        n_rec += len(tr)
    hold_s = time.perf_counter() - t0
    if bool(n_delayed) != bool(float(twin.delayed_frac.max()) > 0.0):
        raise AssertionError(f"{what}: {n_delayed} delayed records, delayed "
                             f"fractions {twin.delayed_frac.tolist()}")
    path = ROOT / "chiprun_out" / f"trace_{'_'.join(what.split())}.json"
    path.parent.mkdir(exist_ok=True)
    tr = traces[0][0]
    t0 = time.perf_counter()
    write_perfetto(path, tr, station_names=names)
    summ = summarize_events(read_perfetto(path))
    cats = summ["by_cat_count"]
    if (summ["requests_count"] != len(tr)
            or cats.get("visit", 0) != int(tr.nvis.sum())
            or cats.get("mshr", 0) != int((tr.parked_us > 0).sum())
            or summ["by_cls_count"].get("delayed", 0)
            != int((tr.cls == CLS_DELAYED).sum())):
        raise AssertionError(f"{what}: Perfetto round trip lost events: "
                             f"{summ}")
    print(f"traced {what}: {n_s * n_p} lanes, {n_rec} records = the "
          f"completions, {n_delayed} delayed; counts reconciled; Perfetto "
          f"lane 0: {summ['slices_count']} slices, {summ['requests_count']} "
          f"requests, {summ['by_cls_count']}", flush=True)
    if open_loop:
        got = {"cls": [np.concatenate(c) for c, _ in pooled],
               "sojourn": [np.concatenate(j) for _, j in pooled]}
    else:
        got = {"rates": rates, "delayed_rates": dl_rates,
               "delayed_frac": dl_frac}
    return got, {"records": n_rec, "delayed": n_delayed, "perfetto": summ,
                 "decode_and_hold_s": hold_s,
                 "perfetto_s": time.perf_counter() - t0}


def reconcile(what, pairs, rtol=TRACE_RECONCILE_RTOL):
    """Raise unless each (name, from the records, the result's field,
    absolute tolerance) pair agrees within ``rtol`` (and that tolerance);
    returns the largest relative difference."""
    import numpy as np

    worst = 0.0
    for name, got, want, atol in pairs:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name} from the records")
        nz = np.isfinite(want) & (want != 0)
        if nz.any():
            worst = max(worst, float(np.max(np.abs(got[nz] - want[nz])
                                            / np.abs(want[nz]))))
    print(f"traced {what}: the result's {', '.join(p[0] for p in pairs)} "
          f"equal the records' within {rtol} or the pair's absolute "
          f"tolerance (largest relative difference {worst:.3g})", flush=True)
    return worst


def traced_modes(rec, device="cuda"):
    """``trace=K`` through the entry points in every traced mode at the
    figures' widths, lossless rings: ``simulate_network`` on
    fig_delayed_hits B (LRU, 8-deep 100 us disk, 16 flows, 3 p x 2 seeds x
    FIG_REQUESTS), fig_latency B's open loop (5 us disk, 0.838
    lambda_max, 3 p x 3 seeds, 256 slots), fig_latency C's coalescing open
    loop (16 flows, 2 seeds) and fig_cluster E's bursts (2 seeds, 512
    slots); ``simulate_hierarchy`` on fig_hierarchy's network (K 18, mpl
    96, F 4, 9 p x 2 seeds x HI_REQUESTS: ``simulate_network(tiers=...)``);
    ``simulate_cluster`` on fig_cluster C (8 shards, 8 flows a shard, mpl
    96, 3 p x 2 seeds x FIG_REQUESTS).  Each result's decoded ``traces``
    are held by :func:`hold_traced_lanes` against an untraced launch of
    the same lanes (whose throughput must be the result's), and the
    result's own statistics are rebuilt from the records
    (:func:`reconcile`): throughput, per-branch (per-level, per-shard)
    and delayed rates and the delayed fraction over each lane's measured
    window in the closed modes; class fractions (and, within
    ``OPEN_SOJOURN_RTOL``, the mean sojourn) over the records from the
    warmup on in the open loop."""
    import numpy as np
    import torch
    from repro_torch.cluster.sim import simulate_cluster
    from repro_torch.core import build, exponential_analogue
    from repro_torch.core.simulator import simulate_network
    from repro_torch.hierarchy.sim import simulate_hierarchy
    from repro_torch.kernels import event_sim as es
    from repro_torch.latency import lambda_max
    from test_torch_event_sim_cuda import cluster_model, hierarchy_model

    dev = torch.device(device)
    out = {}

    def run(what, net, call, lanes, open_loop=False, **extra):
        t0 = time.perf_counter()
        res = call()
        sec = time.perf_counter() - t0
        spec, seeds, kw = lanes
        twin = (es.sim_open_lanes if open_loop else es.sim_lanes)(
            spec, seeds, **kw, **extra)
        n_s, n_p = len(res.traces), len(res.traces[0])
        if not np.array_equal(twin.x.cpu().numpy().reshape(n_s, n_p).mean(0),
                              res.throughput):
            raise AssertionError(f"{what}: the untraced launch is not the "
                                 "result's run")
        got, summ = hold_traced_lanes(
            what, res.traces, twin, kw["warmup"],
            kw["n_slots"] if open_loop else kw["mpl"], len(net.branches),
            [st.name for st in net.stations], open_loop)
        out[what] = dict(summ, call_s=sec)
        return res, got

    def closed_pairs(res, got, folds):
        rates = got["rates"].mean(0)
        pairs = [("throughput", got["rates"].sum(-1).mean(0), res.throughput,
                  0.0),
                 ("delayed_frac", got["delayed_frac"].mean(0),
                  res.delayed_frac, 0.0)]
        for name, fold in folds.items():
            pairs.append((name, fold(rates, got["delayed_rates"].mean(0)),
                          getattr(res, name), 0.0))
        return pairs

    def open_pairs(what, res, got):
        frac = np.array([[np.mean(c == k) for k in range(3)]
                         for c in got["cls"]])
        soj = np.array([j.mean() for j in got["sojourn"]])
        out["open_sojourn_max_rel_diff"] = max(
            out.get("open_sojourn_max_rel_diff", 0.0),
            reconcile(what, [("sojourn_mean", soj, res.sojourn_mean, 0.0)],
                      rtol=OPEN_SOJOURN_RTOL))
        return reconcile(what, [("class_frac", frac, res.class_frac, 0.0)])

    # fig_delayed_hits B: simulate_network with coalescing
    net_b = build("lru", disk_us=DH_DISK_US, disk_servers=DH_IO_DEPTH)
    ps = np.asarray(DH_P_SIM)
    res, got = run(
        "delayed_hits B", net_b,
        lambda: simulate_network(net_b, ps, n_requests=FIG_REQUESTS,
                                 seeds=(0, 1), coalesce_flows=16,
                                 trace=FIG_REQUESTS + net_b.mpl,
                                 device=device),
        es.grid_lanes(net_b, ps, FIG_REQUESTS, (0, 1), 0.25, dev,
                      coalesce_flows=16))
    worst = reconcile("delayed_hits B", closed_pairs(res, got, {
        "branch_throughput": lambda r, d: r,
        "branch_delayed": lambda r, d: d}))

    # fig_latency B's open loop, C's coalescing open loop, fig_cluster E's
    # bursts: simulate_network(arrival_rate=...)
    lat = build("lru", disk_us=LAT_DISK_US)
    lam = LAT_SIM_LOAD * float(np.max(lambda_max(lat, np.linspace(0, 1, 201))))
    net_l = exponential_analogue(build("lru", disk_us=LAT_DISK_US_SIM))
    ps = np.asarray(LAT_P_SIM)
    res, got = run(
        "latency B open loop", net_l,
        lambda: simulate_network(net_l, ps, arrival_rate=lam,
                                 n_requests=FIG_REQUESTS, seeds=(0, 1, 2),
                                 max_in_system=256,
                                 trace=FIG_REQUESTS + 256,
                                 device=device),
        es.open_lanes(net_l, ps, np.full(len(ps), lam), FIG_REQUESTS,
                      (0, 1, 2), 0.25, 256, device=dev), open_loop=True)
    worst = max(worst, open_pairs("latency B open loop", res, got))
    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations))
    res, got = run(
        "latency C coalescing open loop", net_c,
        lambda: simulate_network(net_c, [0.5], arrival_rate=LAT_CO_LAMBDA,
                                 n_requests=FIG_REQUESTS, seeds=(0, 1),
                                 coalesce_flows=LAT_CO_FLOWS,
                                 max_in_system=256,
                                 trace=FIG_REQUESTS + 256,
                                 device=device),
        es.open_lanes(net_c, np.array([0.5]), np.array([LAT_CO_LAMBDA]),
                      FIG_REQUESTS, (0, 1), 0.25, 256,
                      coalesce_flows=LAT_CO_FLOWS, device=dev),
        open_loop=True)
    worst = max(worst, open_pairs("latency C coalescing open loop", res, got))
    cm = cluster_model(CL_SHARDS, 12 * CL_SHARDS, key_space=CL_SIM_KEYS)
    net_e = exponential_analogue(cm.network)
    lam_e = 0.55 * float(cm.lambda_max(0.6, tail_mode="nominal"))
    burst = (0.55, 2_000.0)
    res, got = run(
        "cluster E burst open loop", net_e,
        lambda: simulate_network(net_e, [0.6], arrival_rate=lam_e,
                                 n_requests=FIG_REQUESTS, seeds=(0, 1),
                                 max_in_system=512, burst=burst,
                                 trace=FIG_REQUESTS + 512,
                                 device=device),
        es.open_lanes(net_e, np.array([0.6]), np.array([lam_e]),
                      FIG_REQUESTS, (0, 1), 0.25, 512, burst=burst,
                      device=dev), open_loop=True)
    worst = max(worst, open_pairs("cluster E burst open loop", res, got))

    # fig_hierarchy's network: simulate_hierarchy, the tiered tables
    hm = hierarchy_model("fig", HI_MPL)
    lo, hi = hm.profile.p_range()
    ps = np.linspace(lo + 1e-3, hi - 1e-3, HI_GRID_N)
    res, got = run(
        "hierarchy", hm.network,
        lambda: simulate_hierarchy(hm, ps, n_requests=HI_REQUESTS,
                                   seeds=(0, 1), coalesce_flows=4,
                                   trace=HI_REQUESTS + hm.network.mpl,
                                   device=device),
        es.grid_lanes(hm.network, ps, HI_REQUESTS, (0, 1), 0.25, dev,
                      coalesce_flows=4, tiers=hm.mshr))
    level, shard = np.asarray(hm.branch_level), np.asarray(hm.branch_shard)
    worst = max(worst, reconcile("hierarchy", closed_pairs(res, got, {
        "level_throughput": lambda r, d: np.stack(
            [r[:, level == lv].sum(1) for lv in range(3)], axis=1),
        "shard_throughput": lambda r, d: np.stack(
            [r[:, shard == k].sum(1) for k in range(hm.n_shards)], axis=1)})))

    # fig_cluster C: simulate_cluster with coalescing and its counts
    shard = np.asarray(cm.branch_shard)
    hit = ~np.asarray(cm.branch_has_disk)
    ps = np.asarray(CL_SIM_P)
    res, got = run(
        "cluster C", cm.network,
        lambda: simulate_cluster(cm, ps, n_requests=FIG_REQUESTS,
                                 seeds=(0, 1), coalesce_flows=8,
                                 trace=FIG_REQUESTS + cm.network.mpl,
                                 device=device),
        es.grid_lanes(cm.network, ps, FIG_REQUESTS, (0, 1), 0.25, dev,
                      coalesce_flows=8), count_branches=True)

    def per_shard(r, sel=True):
        return np.stack([r[:, (shard == k) & sel].sum(1)
                         for k in range(CL_SHARDS)], axis=1)

    worst = max(worst, reconcile("cluster C", closed_pairs(res, got, {
        "shard_throughput": lambda r, d: per_shard(r),
        "shard_hit_ratio": lambda r, d: per_shard(r, hit) / per_shard(r),
        "shard_delayed_frac": lambda r, d: per_shard(d) / per_shard(r)})))
    out["reconcile_max_rel_diff"] = worst
    rec["traced_modes"] = out


def traced_path(rec):
    """The LRU network at 100 us through ``simulate_network(trace=...)``
    with lossless rings: every lane's records are exactly requests
    0..n-1, and its post-warmup records over the measured interval (both
    read off the records' stamps) give the throughput; per-station
    utilization across P_GRID; one lane to Perfetto and back.  Then the
    traced coalescing, open-loop and tiered modes (:func:`traced_modes`)."""
    import numpy as np
    from repro_torch.core.policy_models import lru_network
    from repro_torch.core.simulator import simulate_network
    from repro_torch.obs.export import (read_perfetto, summarize_events,
                                        write_perfetto)
    from repro_torch.obs.metrics import trace_summary

    net = lru_network(disk_us=100.0)
    t0 = time.perf_counter()
    sim = simulate_network(net, P_GRID, n_requests=SIM_REQUESTS, seeds=SEEDS,
                           trace=TRACE_FULL)
    seconds = {"simulate_and_decode": time.perf_counter() - t0}
    warmup = int(SIM_REQUESTS * 0.25)
    names = [st.name for st in net.stations]
    util, rates = {}, {}
    for i, p in enumerate(P_GRID):
        xs = []
        for s in range(len(SEEDS)):
            tr = sim.traces[s][i]
            if tr.n_emitted != SIM_REQUESTS or tr.n_dropped:
                raise AssertionError(f"p={p} seed {s}: {tr.n_emitted} records "
                                     f"emitted, {tr.n_dropped} dropped")
            if not np.array_equal(tr.req, np.arange(SIM_REQUESTS)):
                raise AssertionError(f"p={p} seed {s}: req is not 0..n-1")
            end = tr.end_us
            t_meas = end[-1] - end[warmup - 1]
            counts = np.bincount(tr.branch[tr.req >= warmup],
                                 minlength=len(net.branches))
            xs.append(counts / t_meas)
        rate = np.mean(xs, axis=0)
        if not np.isclose(rate.sum(), sim.throughput[i], rtol=1e-5):
            raise AssertionError(f"p={p}: trace rate {rate.sum()} != "
                                 f"throughput {sim.throughput[i]}")
        rates[p] = rate.tolist()
        t0 = time.perf_counter()
        summ = trace_summary(sim.traces[0][i], len(names))
        seconds["trace_summary"] = (seconds.get("trace_summary", 0.0)
                                    + time.perf_counter() - t0)
        util[p] = {names[int(k)]: v for k, v in summ["stations"].items()}
    print("traced lru disk=100: records 0..n-1 per lane; per-branch rates "
          "from the records sum to X(p) at every p", flush=True)
    print("station busy_frac (mean occupancy) across P_GRID, seed 0:",
          flush=True)
    for p, row in util.items():
        print(f"  p={p}: " + ", ".join(
            f"{k} {v['busy_frac']:.4f} ({v['mean_occupancy_count']:.3f})"
            for k, v in row.items()), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "trace_lru_p0.7.json"
    tr = sim.traces[0][P_GRID.index(0.7)]
    t0 = time.perf_counter()
    write_perfetto(path, tr, station_names=names)
    seconds["write_perfetto"] = time.perf_counter() - t0
    summ = summarize_events(read_perfetto(path))
    if (summ["requests_count"] != len(tr)
            or summ["slices_count"] != int(tr.nvis.sum())):
        raise AssertionError(f"Perfetto round trip lost events: {summ}")
    print(f"perfetto p=0.7: {summ['slices_count']} slices, "
          f"{summ['requests_count']} requests, {summ['by_cls_count']}",
          flush=True)
    print("traced path host-clock seconds: "
          + json.dumps({k: round(v, 4) for k, v in seconds.items()}),
          flush=True)
    rec["traced_path"] = {"x": sim.throughput.tolist(),
                          "branch_rate": rates, "stations": util,
                          "perfetto": summ, "seconds": seconds}
    traced_modes(rec)


def lru_update_path(rec):
    """A stream of Zipf access batches through ``ops.lru_batch_update`` on
    a 2**22-slot recency table (now = batch number, the last batch padded
    with -1), held against each slot's last access computed in numpy."""
    import numpy as np
    import torch
    from repro_torch.core.harness import zipf_trace
    from repro_torch.kernels.ops import lru_batch_update

    n_slots, n_acc, n_batches = LRU_PATH
    stream = zipf_trace(n_acc * n_batches, n_slots, 0.99, seed=0).astype(
        np.int32).reshape(n_batches, n_acc)
    stream[-1, -n_acc // 8:] = -1
    ts0 = -np.random.default_rng(0).integers(0, 1000, n_slots).astype(np.int32)
    ts, batches = torch.from_numpy(ts0).cuda(), torch.from_numpy(stream).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(n_batches):
        ts, victim = lru_batch_update(ts, batches[b], b + 1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    want = ts0.copy()
    for b in range(n_batches):
        want[stream[b][stream[b] >= 0]] = b + 1
    if not (np.array_equal(ts.cpu().numpy(), want)
            and int(victim) == int(np.argmin(want))):
        raise AssertionError("batched LRU path: timestamps or victim wrong")
    print(f"lru_batch_update path: {n_batches} batches x {n_acc} ids on "
          f"{n_slots} slots in {wall_s:.4f} s; timestamps == last access, "
          f"victim {int(victim)} == first argmin", flush=True)
    rec["lru_update_path"] = {"wall_s": wall_s, "victim": int(victim)}


def profile_main_path(rec):
    """Re-run the main path under torch.profiler: device time by kernel,
    and its share of the unprofiled main path's wall time (the profiler
    itself slows the host several-fold)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        main_path(scratch)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # kernels only: a host operation's device time is its kernels'
        if us > 0 and ev.device_type == DeviceType.CUDA:
            name = ("replay" if "replay_kernel" in ev.key else
                    "event_sim" if "sim_kernel" in ev.key else "other")
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    wall_ms = rec["main_path_wall_s"] * 1e3
    rec["main_path_profile"] = {
        "profiled_wall_s": wall_s, "device_ms": by_kernel,
        "busy_share": busy_ms / wall_ms if by_kernel else None}
    print(f"main path: device ms by kernel "
          f"{json.dumps({k: round(v, 3) for k, v in by_kernel.items()})}; "
          f"busy share of the unprofiled {wall_ms:.1f} ms: "
          f"{rec['main_path_profile']['busy_share']}", flush=True)


def work_bound(nbytes, ops):
    """(ms, what bounds it): the larger of the bytes at the memory rate and
    the operations at the float32 rate outside the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed_plain(fn):
    """(result, ms) of one call of a plain version on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def chain_steps(policy, keys, acc) -> int:
    """Dependent loads on one lane's chain, as the kernel's steps make them
    for ``py_ref``'s answers ``acc`` to ``keys``: one per request (the
    lookup, with the candidates a miss would take loaded beside it), one
    per hit that relinks its slot (LRU and Prob-LRU off the list's head;
    every SLRU hit, and one more for its demotion), one per scan step
    (CLOCK's and S3-FIFO's reinsertions, SIEVE's walk).  A lower bound:
    S3-FIFO's ghost counts and free bitmap, and SLRU's eviction from T,
    are left out."""
    steps, head = len(acc), None
    for k, a in zip(keys, acc):
        delink, _, tail, scan = a.ops
        steps += scan
        if policy in ("lru", "prob_lru"):
            steps += int(a.hit and delink and k != head)
            head = k if (not a.hit or delink) else head
        elif policy == "slru" and a.hit:
            steps += 1 + tail
    return steps


def hold_py_ref(rec, policy, params, grid, trace, us, outs):
    """Hits, evicted keys and op vectors of every lane of a sweep's launch
    against the port's pure-Python policies (``cache/py_ref.py``), request
    by request.  Where they part, the plain version decides (and the
    case is recorded for ROADMAP queue 3).  Returns each lane's
    ``chain_steps``."""
    import numpy as np
    from repro_torch.cache.py_ref import PY_POLICIES
    from repro_torch.kernels import replay as kr

    # py_ref's S3-FIFO scans at most 3 reinsertions, max_scan's value here
    kw = {k: v for k, v in params.items()
          if not (policy == "s3fifo" and k == "max_scan")}
    got = [o.cpu().numpy() for o in outs[:3]]
    keys, coins = trace.tolist(), us.tolist()
    steps, parts = [], False
    for i, cap in enumerate(IMPL_CAPS):
        ref = PY_POLICIES[policy](cap, **kw)
        acc = [ref.access(k, u) for k, u in zip(keys, coins)]
        steps.append(chain_steps(policy, keys, acc))
        want = (np.array([a.hit for a in acc]),
                np.array([a.evicted_key for a in acc]),
                np.array([a.ops[0] | a.ops[1] << 1 | a.ops[2] << 9
                          | a.ops[3] << 12 for a in acc]))
        bad = [n for n, g, w in zip(("hits", "evicted", "ops"), got, want)
               if not np.array_equal(g[i], w)]
        if bad and not parts:
            hold_replay(f"{policy} {grid.shape} (py_ref parts at size {cap}: "
                        f"{bad})", outs, kr.replay_lanes_plain(
                            policy, *grid.args, grid.key_space, grid.pad))
            rec.setdefault("py_ref_parts", {})[f"{policy}@{cap}"] = bad
            parts = True
    if not parts:
        print(f"replay {policy} full size: kernel == py_ref (hits, evicted, "
              f"ops)", flush=True)
    return steps


def build_chase():
    """Compile ``CHASE_SRC`` with the library's flags (once per checkout)
    and load it."""
    import ctypes

    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "chase"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "chase.cu"
    if not ((out / "chase.so").exists() and src.exists()
            and src.read_text() == CHASE_SRC):  # else built by this checkout
        src.write_text(CHASE_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        str(src), "-o", str(out / "chase.so")],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "chase.so"))
    lib.chase_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p] * 3)
    lib.chase_launch.restype = ctypes.c_int
    for fn in (lib.redux_launch, lib.shfl_launch):
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def redux_latency(lib, which="redux") -> dict:
    """ns (CUDA events) and cycles (clock64) per step of one warp's chain
    of dependent ``redux.sync`` minima (``which`` "shfl": ``__shfl_sync``
    reads): the latency of one warp-wide reduction (shuffle), the unit of
    the sketch_trace and event-sim kernels' chain bounds."""
    import torch
    from repro_torch.kernels._build import check

    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    chain = getattr(lib, f"{which}_launch")

    def launch():
        return chain(REDUX_STEPS, cycles.data_ptr(), sink.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)

    check(launch(), f"{which} launch")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    check(launch(), f"{which} launch")
    end.record()
    torch.cuda.synchronize()
    return {"ns": start.elapsed_time(end) * 1e6 / REDUX_STEPS,
            "cycles": int(cycles.item()) / REDUX_STEPS}


def load_latency(lib) -> dict:
    """ns and cycles per dependent load of the pointer chase, in shared
    memory and in device memory (L1-resident after the warm-up lap)."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import check

    order = np.random.default_rng(0).permutation(CHASE_N)
    nxt = np.empty(CHASE_N, np.int32)
    nxt[order] = np.roll(order, -1)  # one cycle through every slot
    nxt_t = torch.from_numpy(nxt).cuda()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = {}
    for where, shared in (("shared", 1), ("device", 0)):
        def launch():
            return lib.chase_launch(nxt_t.data_ptr(), CHASE_N, CHASE_STEPS,
                                    shared, cycles.data_ptr(), sink.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
        check(launch(), "chase launch")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        check(launch(), "chase launch")
        end.record()
        torch.cuda.synchronize()
        out[where] = {"ns": start.elapsed_time(end) * 1e6 / CHASE_STEPS,
                      "cycles": int(cycles.item()) / CHASE_STEPS}
    return out


def full_size_grid():
    """full_size's event-sim grid: one disk speed's (p_hit x seed) lanes,
    21 x 16k requests, with its lossless-ring trace kwargs."""
    import numpy as np
    import torch
    from repro_torch.core.policy_models import lru_network
    from repro_torch.kernels import event_sim as es

    return es.grid_lanes(lru_network(disk_us=100.0), np.asarray(P_GRID),
                         SIM_REQUESTS, SEEDS, 0.25, torch.device("cuda"),
                         trace=TRACE_FULL)


def full_size_one_lane():
    """full_size's one measured-network lane (LRU at 384), as the sweeps
    launch 35 of the main path's 39 untraced lanes."""
    import numpy as np
    import torch
    from repro_torch.core.harness import measure_cache
    from repro_torch.kernels import event_sim as es

    meas = measure_cache("lru", 384, key_space=4096, n_requests=60_000,
                         device="cuda")
    return es.grid_lanes(meas.network, np.asarray([meas.hit_ratio]),
                         SIM_REQUESTS, (0,), 0.25, torch.device("cuda"))


def outputs_digest(*outs) -> str:
    """sha256 of the bytes of every tensor in ``outs`` (tensors, or tuples
    and NamedTuples of them; None skipped), with their dtypes and shapes:
    how full_size's timed launches are held to the launches its workers
    hold against the plain versions."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, torch.Tensor):
            h.update(f"{x.dtype} {tuple(x.shape)}".encode())
            h.update(x.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                feed(y)

    feed(outs)
    return h.hexdigest()


def plain_replay_lru(rec):
    """full_size's LRU replay launch (5 lanes x 60k requests) held against
    its plain version on the same inputs, which is timed; the launch's
    digest recorded."""
    from repro_torch.core.harness import coin_stream, zipf_trace
    from repro_torch.kernels import replay as kr

    grid = kr.grid_lanes("lru", zipf_trace(60_000, 4096, 0.99, 0),
                         coin_stream(60_000, 0), IMPL_CAPS, key_space=4096,
                         window=8, device="cuda")
    outs = kr.replay_lanes("lru", *grid.args, grid.key_space, grid.pad)
    plain, rec["replay_plain_ms"] = timed_plain(
        lambda: kr.replay_lanes_plain("lru", *grid.args, grid.key_space,
                                      grid.pad))
    hold_replay(f"lru {grid.shape}", outs, plain)
    rec["digest_replay_lru"] = outputs_digest(outs)


def plain_event_sim_grid(rec):
    """full_size's event-sim grid, untraced and traced, held against one
    run of the traced plain version (timed), whose throughput,
    completions and events are the untraced plain version's; the two
    launches' digest recorded."""
    from repro_torch.kernels import event_sim as es

    spec, seeds, kw_t = full_size_grid()
    out = es.sim_lanes(spec, seeds, **untraced(kw_t))
    out_t = es.sim_lanes(spec, seeds, **kw_t)
    plain, rec["traced_plain_ms"] = timed_plain(
        lambda: es.sim_lanes_plain(spec, seeds, **kw_t))
    what = f"lru network {len(P_GRID)}x{len(SEEDS)} lanes"
    rec["event_sim_max_abs_err"] = hold_sim(
        f"{what} (vs the traced plain version)", out, plain)
    hold_sim(f"traced {what}", out_t, plain)
    rec["event_sim_traced_max_abs_err"] = hold_trace(
        f"{what}, {TRACE_FULL}-record rings", out_t, plain, spec.visits[0],
        exact=False)
    rec["digest_event_sim_grid"] = outputs_digest(out, out_t)


def plain_event_sim_one(rec):
    """full_size's one measured-network lane held against its plain
    version, which is timed; the launch's digest recorded."""
    from repro_torch.kernels import event_sim as es

    spec, seeds, kw = full_size_one_lane()
    out = es.sim_lanes(spec, seeds, **kw)
    plain, rec["sim_one_lane_plain_ms"] = timed_plain(
        lambda: es.sim_lanes_plain(spec, seeds, **kw))
    rec["event_sim_max_abs_err"] = hold_sim("measured lru@384 network, 1 lane",
                                            out, plain)
    rec["digest_event_sim_one"] = outputs_digest(out)


# full_size's plain versions, each a check at the main path's shapes: run
# side by side in worker processes (run_workers), longest first
FULL_SIZE_PLAIN = {
    "event_sim_grid_plain": plain_event_sim_grid,
    "event_sim_one_lane_plain": plain_event_sim_one,
    "replay_lru_plain": plain_replay_lru,
}


def full_size(rec):
    """Each kernel at the main path's shapes: timed per launch (CUDA events)
    and against the work's bound, then held against its plain version, run
    once on the same inputs and timed, the three plain versions side by
    side in worker processes (``FULL_SIZE_PLAIN``)."""
    import numpy as np
    import torch
    from repro_torch.cache.flat import unpack_ops
    from repro_torch.cache.replay import classify_inflight, lru_sweep
    from repro_torch.core.harness import coin_stream, zipf_trace
    from repro_torch.kernels import event_sim as es
    from repro_torch.kernels import replay as kr

    # replay: each sweep's launch (5 lanes x 60k requests, ks 4096, window
    # 8), timed, held against py_ref and classify_inflight; LRU's also
    # against the plain version and the Mattson sweep
    trace = zipf_trace(60_000, 4096, 0.99, 0)
    us = coin_stream(60_000, 0)
    latency = load_latency(build_chase())
    rec["load_latency"] = latency
    print(f"dependent load: {json.dumps(latency)}", flush=True)
    per_policy, chains, outs_of = {}, {}, {}
    for policy, params in POLICY_PARAMS.items():
        grid = kr.grid_lanes(policy, trace, us, IMPL_CAPS, key_space=4096,
                             window=8, device="cuda", **params)
        per_policy[policy] = cuda_ms(
            lambda g=grid, p=policy: kr.replay_lanes(p, *g.args, g.key_space,
                                                     g.pad), reps=3)
        outs = kr.replay_lanes(policy, *grid.args, grid.key_space, grid.pad)
        # the chain of the longest lane, counted from the inputs by py_ref
        chains[policy] = max(hold_py_ref(rec, policy, params, grid, trace,
                                         us, outs))
        outs_of[policy] = outs
    classes = torch.stack([outs_of[p][3] for p in POLICY_PARAMS]).cpu()
    want = classify_inflight(trace, torch.stack(
        [outs_of[p][0] for p in POLICY_PARAMS]).cpu() != 0, 8,
        key_space=4096, device="cpu")
    if not np.array_equal(classes.numpy(), want):
        raise AssertionError("replay kernel classes != classify_inflight")
    print("replay full size, every policy: classes == classify_inflight "
          "(bit-identical)", flush=True)
    chain_ms = {p: n * latency["shared"]["ns"] * 1e-6
                for p, n in chains.items()}
    for policy, ms in per_policy.items():
        print(f"replay {policy}: {ms:.3f} ms per launch; chain bound "
              f"{chain_ms[policy]:.3f} ms ({chains[policy]} dependent steps "
              f"of {latency['shared']['ns']:.2f} ns); "
              f"{ms / chain_ms[policy]:.2f}x the bound", flush=True)
    grid = kr.grid_lanes("lru", trace, us, IMPL_CAPS, key_space=4096,
                         window=8, device="cuda")
    outs = outs_of["lru"]
    hits, ops = lru_sweep(trace, IMPL_CAPS)
    if not (np.array_equal(outs[0].cpu().numpy(), hits)
            and np.array_equal(unpack_ops(outs[2]).cpu().numpy(), ops)):
        raise AssertionError("LRU replay kernel != Mattson sweep at full size")
    print("replay lru full size: kernel == lru_sweep (bit-identical)",
          flush=True)
    n_l, n_t = grid.args[2].shape
    evictions = int(((outs[2] >> 9) & 0x7).sum())
    replay_bytes = 4 * (n_l * 7 + 3 * n_l * n_t + 4 * n_l * n_t)
    # a figure of work, not the bound: ~16 scalar operations per request
    # and one compare and select per padded slot per eviction, as if
    # they ran in parallel
    replay_ops = 16 * n_l * n_t + 2 * grid.pad * evictions

    # event sim, one disk speed's (p_hit x seed) grid, 21 lanes x 16k
    # requests, untraced and traced (lossless rings); held against one run
    # of the traced plain version in plain_event_sim_grid
    spec, seeds, kw_t = full_size_grid()
    kw = untraced(kw_t)
    sim_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw), reps=5)
    traced_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw_t), reps=5)
    out = es.sim_lanes(spec, seeds, **kw)
    out_t = es.sim_lanes(spec, seeds, **kw_t)
    for f in ("x", "completed", "events", "t_measured"):
        if not torch.equal(getattr(out_t, f), getattr(out, f)):
            raise AssertionError(f"traced kernel != untraced at full size: {f}")
    print(f"event_sim_traced full size: {traced_ms:.3f} ms vs untraced "
          f"{sim_ms:.3f} ms; x/completed/events identical", flush=True)
    # one of the sweeps' measured-network lanes: 35 of the main path's 39
    # untraced launches are one such lane (held in plain_event_sim_one)
    one = full_size_one_lane()
    sim_one_lane_ms = cuda_ms(lambda: es.sim_lanes(one[0], one[1], **one[2]),
                              reps=5)
    out_one = es.sim_lanes(one[0], one[1], **one[2])
    # one sweep's launch on the main path: the LRU sweep's five measured
    # networks as five lanes, bit for bit each network launched alone
    specs = sweep_specs("lru")
    sweep = es.pad_lanes(specs, [0] * len(specs), SIM_REQUESTS, 0.25)
    sweep_ms = cuda_ms(lambda: es.sim_lanes(*sweep[:2], **sweep[2]), reps=5)
    out_sweep = es.sim_lanes(*sweep[:2], **sweep[2])
    for i, net_spec in enumerate(specs):
        cell = es.pad_lanes([net_spec], [0], SIM_REQUESTS, 0.25)
        alone = es.sim_lanes(*cell[:2], **cell[2])
        for f in ("x", "completed", "events", "t_measured"):
            if not torch.equal(getattr(out_sweep, f)[i:i + 1],
                               getattr(alone, f)):
                raise AssertionError(f"sweep launch lane {i} != its network "
                                     f"launched alone: {f}")
    print("event_sim lru sweep, 5 lanes: each lane == its network launched "
          "alone (bit-identical)", flush=True)
    ns_per_event = {  # per event of the launch's longest lane
        "1 lane": sim_one_lane_ms * 1e6 / int(out_one.events.max()),
        "5 lanes (sweep)": sweep_ms * 1e6 / int(out_sweep.events.max()),
        "21 lanes": sim_ms * 1e6 / int(out.events.max()),
        "21 lanes traced": traced_ms * 1e6 / int(out.events.max())}
    print("event_sim ms per launch: 1 lane " f"{sim_one_lane_ms:.3f}, 5 lanes "
          f"{sweep_ms:.3f}, 21 lanes {sim_ms:.3f}, traced {traced_ms:.3f} "
          f"({traced_ms / sim_ms:.3f}x); ns per event "
          + json.dumps({k: round(v, 1) for k, v in ns_per_event.items()}),
          flush=True)

    def sim_work(spec, seeds, mpl, out):
        """(bytes, operations) of one untraced launch."""
        nbytes = sum(a.numel() * a.element_size() for a in spec) \
            + seeds.numel() * 8 + 16 * seeds.numel()
        # per event: two argmin passes over the mpl jobs (compare +
        # select), the ready-time rebase, three murmur3 draws and the
        # service draw
        return nbytes, int(out.events.long().sum()) * (5 * mpl + 60)

    one_bytes, one_ops = sim_work(*one[:2], one[2]["mpl"], out_one)
    sim_bytes, sim_ops = sim_work(spec, seeds, kw["mpl"], out)
    # the traced launch adds the (lanes, B) miss table and the rings: every
    # completed request's record written once
    route_len = spec.visits.shape[-1]
    ring_bytes = int(out.completed.long().sum()) * (5 * 4 + 2 * route_len * 4)

    # the replay launch is a chain of dependent loads per lane: its bound
    # is the longest lane's chain, far above its bytes and operations.  It
    # is a latency; the kernel line names it "operations", as it counts
    # dependent operations (each at one load's latency)
    rb = max(work_bound(replay_bytes, replay_ops)[0], chain_ms["lru"])
    rby = "operations"
    sb, sby = work_bound(one_bytes, one_ops)
    tb, tby = work_bound(sim_bytes + 4 * seeds.numel() * spec.visits.shape[1]
                         + ring_bytes, sim_ops)
    lru = rec["lru_timing"]
    lb, lby = work_bound(lru["bytes"], 2 * lru["shape"][0] + lru["shape"][1])
    # the three plain versions at these shapes, each a check too: side by
    # side in worker processes, after every kernel above is timed; each
    # worker's launch, held against its plain version, is the timed one
    # here, byte for byte
    plain_ms = run_workers(FULL_SIZE_PLAIN, len(FULL_SIZE_PLAIN), rec,
                           "full_size_plain_seconds")
    for key, timed in (("digest_replay_lru", (outs,)),
                       ("digest_event_sim_grid", (out, out_t)),
                       ("digest_event_sim_one", (out_one,))):
        if plain_ms[key] != outputs_digest(*timed):
            raise AssertionError(f"full_size: the timed launches' outputs != "
                                 f"the launch held against the plain version "
                                 f"({key})")
    print("full_size: the timed replay and event-sim launches == the launches "
          "held against their plain versions (sha256 of every output)",
          flush=True)
    replay_plain_ms = plain_ms["replay_plain_ms"]
    traced_plain_ms = plain_ms["traced_plain_ms"]
    sim_one_plain_ms = plain_ms["sim_one_lane_plain_ms"]
    rec["timing"] = {
        "replay_ms_per_policy": per_policy, "replay_plain_ms": replay_plain_ms,
        "replay_chain_steps": chains, "replay_chain_bound_ms": chain_ms,
        "replay_bytes": replay_bytes, "replay_ops": replay_ops,
        "replay_work_bound_ms": work_bound(replay_bytes, replay_ops)[0],
        "replay_shape": [n_l, n_t, grid.key_space, grid.pad],
        "sim_ms": sim_ms, "sim_events": int(out.events.long().sum()),
        "sim_bytes": sim_bytes, "sim_ops": sim_ops,
        "sim_one_lane_ms": sim_one_lane_ms,
        "sim_one_lane_plain_ms": sim_one_plain_ms,
        "sim_one_lane_events": int(out_one.events.long().sum()),
        "sim_one_lane_bytes": one_bytes, "sim_one_lane_ops": one_ops,
        "sim_sweep_ms": sweep_ms,
        "sim_sweep_events": out_sweep.events.tolist(),
        "sim_ns_per_event": ns_per_event,
        "traced_ms": traced_ms, "traced_plain_ms": traced_plain_ms,
        "ring_bytes": ring_bytes,
    }
    return [
        {"name": "replay", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/replay.cu",
         "replaces": "src/repro/kernels/replay.py:110",
         "ms": per_policy["lru"], "plain_ms": replay_plain_ms,
         "bound_ms": rb, "bound_by": rby, "library_ms": None},
        {"name": "event_sim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/kernels/event_sim.py:266",
         "ms": sim_one_lane_ms, "plain_ms": sim_one_plain_ms,
         "bound_ms": sb, "bound_by": sby, "library_ms": None},
        {"name": "event_sim_traced", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/kernels/event_sim.py:288",
         "ms": traced_ms, "plain_ms": traced_plain_ms,
         "bound_ms": tb, "bound_by": tby, "library_ms": None},
        {"name": "lru_batch_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cache_update.cu",
         "replaces": "src/repro/kernels/cache_update.py:34",
         "ms": lru["ms"], "plain_ms": lru["plain_ms"],
         "bound_ms": lb, "bound_by": lby, "library_ms": lru["library_ms"]},
    ] + attention_rows(rec) + wkv_rows(rec)


def attention_rows(rec):
    """The flash and paged rows of the kernels line, timed at their
    full-width shapes (flash: causal, no window, the prefill path's
    attention, each kernel in the type it takes there; the windowed times
    go to the record)."""
    rows = attention_timing()
    rec["timing"]["attention"] = rows
    sm90, f32, pg = rows["sm90_window0"], rows["f32_window0"], rows["paged"]
    return [
        {"name": "flash_attention_sm90", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "ms": sm90["ms"], "plain_ms": sm90["plain_ms"],
         "bound_ms": sm90["bound_ms"], "bound_by": sm90["bound_by"],
         "library_ms": sm90["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
         "bound_by": f32["bound_by"], "library_ms": f32["library_ms"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:28",
         "ms": pg["ms"], "plain_ms": pg["plain_ms"], "bound_ms": pg["bound_ms"],
         "bound_by": pg["bound_by"],
         "library_ms": pg["library_ms_excluding_gather"]},
    ]


def _dtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def flash_inputs(case, seed):
    """q (B, T, H, dh), k and v (B, S, KV, dh) on the card, from a seeded
    generator."""
    import torch

    B, T, S, H, KV, dh = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(_dtype(case[8]))
            for shape in ((B, T, H, dh), (B, S, KV, dh), (B, S, KV, dh))]


def paged_inputs(case, seed):
    """q, the K/V pool, a block table of distinct pages and seq_lens on the
    card.  Random seq_lens lie in [1, n_pages * page]; ragged ones in its
    upper half."""
    import numpy as np
    import torch

    B, H, KV, dh, page, n, P, dt, lens = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    q, pk, pv = [torch.randn(shape, generator=g, device="cuda").to(_dtype(dt))
                 for shape in ((B, H, dh), (P, page, KV, dh), (P, page, KV, dh))]
    bt = rng.permutation(P)[: B * n].reshape(B, n).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, n * page + 1, B)
    elif lens == "ragged":
        lens = rng.integers(n * page // 2, n * page + 1, B)
    return (q, pk, pv, torch.from_numpy(bt).cuda(),
            torch.tensor(np.asarray(lens), dtype=torch.int32, device="cuda"))


def hold_attention(what, got, want, dtype, tol=None) -> float:
    """Raise unless the kernel's output is finite and within the reference's
    tolerance (``tol``, else the attention tests' for ``dtype``) of the
    plain version's; returns max |d|."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    a, b = got.float().cpu().numpy(), want.float().cpu().numpy()
    if not np.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite output")
    tol = ATTN_TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)
    err = float(np.abs(a - b).max())
    print(f"{what}: kernel == plain within {tol}, max |d| = {err:.3g}",
          flush=True)
    return err


def hold_mean(what, got, want, rel) -> float:
    """Raise unless mean |got - want| <= rel * mean |want|; returns the
    ratio of the two means."""
    d = (got.float() - want.float()).abs().mean()
    ratio = float(d / want.float().abs().mean())
    if not ratio <= rel:
        raise AssertionError(f"{what}: mean |kernel - plain| is {ratio:.3g} of "
                             f"mean |plain|, above {rel}")
    print(f"{what}: mean |kernel - plain| = {ratio:.3g} of mean |plain| "
          f"(limit {rel})", flush=True)
    return ratio


def check_flash(rec):
    """Both flash kernels against their plain versions at the reference's
    FLASH_CASES, the ragged bf16 cases, the full-width prefill shape in
    bf16 and float32, and the head widths 80 and 168 (FLASH_WIDE).  Each
    case must launch the kernel ``kernel_for`` names, once; a bf16 case is
    held to FLASH_MEAN_REL as well."""
    import torch
    from repro_torch.kernels import flash_attention as fl

    err = {"flash_attention": 0.0, "flash_attention_sm90": 0.0}
    mean_rel = {"flash_attention": 0.0, "flash_attention_sm90": 0.0}
    cases = FLASH_CASES + FLASH_RAGGED_BF16 + FLASH_FULL + FLASH_FULL_F32 + FLASH_WIDE
    for i, case in enumerate(cases):
        q, k, v = flash_inputs(case, seed=i)
        causal, window = case[6], case[7]
        tc = fl.kernel_for(q.dtype, case[5]) == "tensor_core"
        name = "flash_attention_sm90" if tc else "flash_attention"
        n0, tc0 = fl.flash_attention.launches, fl.flash_attention.tensor_core_launches
        got = fl.flash_attention(q, k, v, causal=causal, window=window)
        if (fl.flash_attention.launches - n0,
                fl.flash_attention.tensor_core_launches - tc0) != (1, int(tc)):
            raise AssertionError(f"{case}: not one launch of the "
                                 f"{fl.kernel_for(q.dtype, case[5])} kernel")
        want = fl.flash_attention_plain(q, k, v, causal, window)
        err[name] = max(err[name], hold_attention(f"{name} {case}", got, want,
                                                  case[8]))
        if q.dtype == torch.bfloat16:
            mean_rel[name] = max(mean_rel[name], hold_mean(
                f"{name} {case}", got, want, FLASH_MEAN_REL))
    for name, e in err.items():
        rec[f"{name}_max_abs_err"] = e
        rec[f"{name}_bf16_mean_rel_err"] = mean_rel[name]


def check_paged(rec):
    """The paged kernel against its plain version at the reference's
    PAGED_CASES, seq_len 0 and 1, a float32 case of several steps, and the
    full-width decode batch in bf16 and float32."""
    from repro_torch.kernels import paged_attention as pg

    err = 0.0
    for i, case in enumerate(PAGED_CASES + (PAGED_FULL, PAGED_FULL_F32)):
        ins = paged_inputs(case, seed=i)
        err = max(err, hold_attention(
            f"paged_attention {case[:8]} seq_lens {ins[4].tolist()[:4]}",
            pg.paged_attention(*ins), pg.paged_attention_plain(*ins), case[7]))
    rec["paged_attention_max_abs_err"] = err


def prefill_path(rec, model, model32):
    """Full-width internlm2-1.8b: ``forward(use_pallas=True)`` (the flash
    kernel in every layer) against ``use_pallas=False``
    (``chunked_attention``) on 2 x 2048 tokens, in bf16 and in float32
    (the same bf16 weights, computed in float32).

    In float32 the two paths differ only in summation order: the logits
    must agree within 1e-4 of their scale (the CPU model tests' limit) and
    the next token at >= 99% of positions.  In bf16 they differ by
    design (the chunked path rounds q * dh**-0.5 to bf16 before the dot,
    the tensor-core kernel scales the float32 dot after; both round p to
    bf16), and
    with random weights the top two logits are often closer than that
    rounding moves them, so the bf16 agreement is reported, and the bf16
    kernel path must be as close to the float32 forward as the bf16
    chunked path is, to within 10% (mean |d logit|): both are dominated by
    the bf16 rounding of every activation, which the two paths share.
    Each timed forward follows an untimed one in its type."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models import transformer

    B, T = PREFILL_SHAPE
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model[0].vocab, (B, T)).astype(np.int32)).cuda()

    def run(cfg, params, use_pallas):
        before = fl.flash_attention.launches
        tc_before = fl.flash_attention.tensor_core_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = transformer.forward(params, toks, cfg, use_pallas=use_pallas)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = fl.flash_attention.launches - before
        tc = fl.flash_attention.tensor_core_launches - tc_before
        want_tc = cfg.n_layers if use_pallas and cfg.compute_dtype == "bfloat16" else 0
        if n != (cfg.n_layers if use_pallas else 0) or tc != want_tc:
            raise AssertionError(f"forward(use_pallas={use_pallas}) in "
                                 f"{cfg.compute_dtype} launched the flash "
                                 f"kernels {n} times, {tc} on the tensor cores")
        if logits.shape != (B, T, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError("prefill logits: bad shape or non-finite")
        return logits, seconds

    def compare(a, b):
        d = (a - b).abs()
        return {"max_abs_dlogit": float(d.max()), "mean_abs_dlogit": float(d.mean()),
                "argmax_agreement": float((a.argmax(-1) == b.argmax(-1)).float().mean())}

    out = {"shape": [B, T], "flash_launches_per_forward": model[0].n_layers,
           "tensor_core_launches_per_bf16_forward": model[0].n_layers}
    # one untimed chunked forward in each type first, so that no timed
    # forward pays for the first use of its type's matrix products
    run(*model32, False)
    ref32, t_ref = run(*model32, False)
    k32, t_k32 = run(*model32, True)
    out["float32"] = {**compare(k32, ref32), "logit_scale": float(ref32.abs().max()),
                      "flash_forward_s": t_k32, "chunked_forward_s": t_ref}
    del k32
    run(*model, False)
    k16, t_k16 = run(*model, True)
    c16, t_c16 = run(*model, False)
    out["bfloat16"] = {**compare(k16, c16), "logit_scale": float(c16.abs().max()),
                       "flash_forward_s": t_k16, "chunked_forward_s": t_c16,
                       "flash_vs_float32": compare(k16, ref32),
                       "chunked_vs_float32": compare(c16, ref32)}
    rec["prefill_path"] = out
    for dt in ("bfloat16", "float32"):
        r = out[dt]
        print(f"prefill {model[0].name} {dt} {B}x{T}: flash vs chunked max |d logit| "
              f"{r['max_abs_dlogit']:.4g}, mean {r['mean_abs_dlogit']:.4g} (logit "
              f"scale {r['logit_scale']:.4g}), next-token argmax agreement "
              f"{r['argmax_agreement']:.4f}; forward {r['flash_forward_s']:.4f} s "
              f"with the flash kernel, {r['chunked_forward_s']:.4f} s chunked",
              flush=True)
    b16 = out["bfloat16"]
    print(f"prefill bf16 against the float32 forward: flash mean |d logit| "
          f"{b16['flash_vs_float32']['mean_abs_dlogit']:.4g} (argmax agreement "
          f"{b16['flash_vs_float32']['argmax_agreement']:.4f}), chunked "
          f"{b16['chunked_vs_float32']['mean_abs_dlogit']:.4g} "
          f"({b16['chunked_vs_float32']['argmax_agreement']:.4f})", flush=True)
    f32 = out["float32"]
    if f32["max_abs_dlogit"] > 1e-4 * f32["logit_scale"]:
        raise AssertionError("float32 flash and chunked prefill logits differ "
                             f"by {f32['max_abs_dlogit']:.4g} at a scale of "
                             f"{f32['logit_scale']:.4g}")
    if f32["argmax_agreement"] < 0.99:
        raise AssertionError("float32 flash and chunked prefill agree on the "
                             f"next token at only {f32['argmax_agreement']:.4f}")
    if (b16["flash_vs_float32"]["mean_abs_dlogit"]
            > 1.1 * b16["chunked_vs_float32"]["mean_abs_dlogit"]):
        raise AssertionError("bf16 prefill through the flash kernel is farther "
                             "from the float32 forward than the chunked path")


def to_float32(tree):
    """A parameter dictionary with every tensor in float32."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_float32(v) for v in tree)
    return tree.float()


def serve_stream(cfg):
    from repro_torch.training.data import zipf_request_stream

    kw = dict(SERVE_STREAM)
    return zipf_request_stream(kw.pop("n_requests"), kw.pop("n_prefixes"),
                               kw.pop("prefix_len"), cfg.vocab, **kw)


def run_engine(cfg, params, **overrides):
    """The launch/serve.py engine on ``params``, the stream submitted and
    run; returns (engine, requests, wall seconds)."""
    import torch
    from repro_torch.serving import Engine, ServeConfig

    eng = Engine(cfg, params, ServeConfig(**{**SERVE, **overrides}))
    reqs = [eng.submit(t) for _, t in serve_stream(cfg)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def controller_replay(cfg, **overrides):
    """The stream through the port's PrefixCache with no model: the
    engine's admission order and draws.  Returns the engine's ``stats()``
    keys but ``decode_steps``."""
    import numpy as np
    from repro_torch.serving import PageAllocator, PrefixCache, chunk_hashes

    sc = {**SERVE, "bypass_fraction": 0.0, "seed": 0, **overrides}
    alloc = PageAllocator(sc["n_pages"])
    cache = PrefixCache(alloc, sc["prefix_capacity"], policy=sc["policy"])
    rng = np.random.default_rng(sc["seed"])
    for _, toks in serve_stream(cfg):
        if rng.random() < sc["bypass_fraction"]:
            cache.stats.bypassed += 1
            continue
        hashes = chunk_hashes(toks, sc["page_size"])
        _, n_hit = cache.lookup(hashes)
        for h in hashes[n_hit:]:
            cache.insert(h, rng.random())
    s = cache.stats
    return {"chunk_hit_ratio": s.hit_ratio, "controller_ops": s.ops.tolist(),
            "evictions": s.evictions, "bypassed": s.bypassed,
            "pages_free": alloc.n_free}


def hold_stats(what, eng, cfg):
    want = controller_replay(cfg)
    got = {k: v for k, v in eng.stats().items() if k != "decode_steps"}
    if got != want:
        raise AssertionError(f"{what}: engine stats {got} != controller "
                             f"replay {want}")
    print(f"{what}: stats == model-free controller replay {got}", flush=True)


def top2_gap(cfg, params, tokens):
    """Top-2 logit gap and logit scale of the next token after ``tokens``
    (a fresh cache-free forward)."""
    import torch
    from repro_torch.models import transformer

    logits = transformer.forward(params, torch.as_tensor(tokens)[None].cuda(),
                                 cfg, unembed_last_only=True)[0][0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def serve_path(rec, model, model32):
    """The port's Engine on full-width internlm2-1.8b serving the
    launch/serve.py stream: in bf16, timed; in float32 (TF32 off), the
    tokens equal those of the same stream with the prefix cache bypassed,
    and stats() equals a model-free replay of the controller."""
    import numpy as np
    import torch
    from repro_torch.models import transformer

    cfg, params = model
    eng, reqs, wall = run_engine(cfg, params)
    st = eng.stats()
    computed = sum(r.prefill_tokens_computed for r in reqs)
    skipped = sum(r.prefill_tokens_skipped for r in reqs)
    decode_tokens = eng.metrics.snapshot()["counters"]["decode_tokens_count"]
    if not all(r.done and len(r.out) == SERVE["max_new_tokens"] for r in reqs):
        raise AssertionError("bf16 engine: a request was not served in full")
    hold_stats("serve bf16", eng, cfg)
    # the forecast's inputs, measured on the card: one decode step of the
    # engine's batch, and one 8-token chunk prefill into a fresh slot cache
    toks = torch.zeros((SERVE["max_seqs"], 1), dtype=torch.int32, device="cuda")
    lens = torch.full((SERVE["max_seqs"],), 64, dtype=torch.int32,
                      device="cuda")
    caches = transformer.init_cache(cfg, SERVE["max_seqs"], SERVE["max_seq_len"])
    step_ms = cuda_ms(lambda: transformer.forward(
        params, toks, cfg, caches=caches, cache_len=lens), reps=10)
    chunk = torch.zeros((1, SERVE["page_size"]), dtype=torch.int32,
                        device="cuda")

    def prefill():
        one = transformer.init_cache(cfg, 1, SERVE["max_seq_len"])
        transformer.forward(params, chunk, cfg, caches=one, cache_len=[0])

    prefill_ms = cuda_ms(prefill, reps=10)
    net = eng.forecast_network(step_us=step_ms * 1e3, prefill_us=prefill_ms * 1e3)
    net.validate()
    p = st["chunk_hit_ratio"]
    out = {"bf16": {
        "wall_s": wall, "ticks": eng.ticks, "decode_steps": st["decode_steps"],
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / wall,
        "prefill_tokens_computed": computed, "prefill_tokens_skipped": skipped,
        "stats": st, "step_ms": step_ms, "chunk_prefill_ms": prefill_ms,
        "forecast_mpl": net.mpl,
        "forecast_x_upper_at_p": float(net.throughput_upper(p)),
        "forecast_p_star": net.p_star()}}
    print(f"serve {cfg.name} bf16: {wall:.3f} s, {eng.ticks} ticks, "
          f"{decode_tokens} decode tokens ({decode_tokens / wall:.1f} tok/s), "
          f"prefill tokens computed {computed} / skipped {skipped}, "
          f"hit ratio {p:.4f}; decode step {step_ms:.3f} ms, chunk prefill "
          f"{prefill_ms:.3f} ms -> forecast X_upper({p:.3f}) = "
          f"{out['bf16']['forecast_x_upper_at_p']:.4f} req/us, p* = "
          f"{out['bf16']['forecast_p_star']:.4f} at MPL {net.mpl}", flush=True)

    cfg32, params32 = model32
    eng32, reqs32, wall32 = run_engine(cfg32, params32)
    hold_stats("serve f32", eng32, cfg32)
    _, off32, _ = run_engine(cfg32, params32, bypass_fraction=1.0)
    if not eng32.prefix.stats.chunk_hits:
        raise AssertionError("f32 engine: the stream produced no prefix hit")
    diverged = []
    for r_on, r_off in zip(reqs32, off32):
        if r_on.out == r_off.out:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r_on.out, r_off.out)) if a != b)
        gap, scale = top2_gap(cfg32, params32,
                              np.concatenate([r_on.tokens, r_on.out[:j]]))
        diverged.append({"rid": r_on.rid, "step": j, "top2_gap": gap,
                         "logit_scale": scale})
        print(f"serve f32: request {r_on.rid} differs at token {j}: top-2 "
              f"gap {gap:.3g} of logit scale {scale:.3g}", flush=True)
        if gap > 1e-3 * scale:
            raise AssertionError(f"f32 tokens differ with and without the "
                                 f"prefix cache at a top-2 gap of {gap}")
    n_same = len(reqs32) - len(diverged)
    print(f"serve f32: {n_same}/{len(reqs32)} requests serve identical tokens "
          f"with and without the prefix cache ({wall32:.3f} s)", flush=True)
    out["f32"] = {"wall_s": wall32, "stats": eng32.stats(),
                  "identical_requests": n_same, "diverged": diverged}
    rec["serve_path"] = out
    return eng


def paged_on_pool(rec, eng):
    """The paged kernel on each layer of the bf16 engine's page pool: the
    block tables are the pages of the prefixes still resident in the prefix
    cache, q is seeded; held against the plain version and against dense
    attention over ``gather_pages`` of the same pages."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pg
    from repro_torch.models.attention import chunked_attention
    from repro_torch.serving import chunk_hashes, kv_pages

    cfg = eng.cfg
    page = eng.serve.page_size
    tables = []
    for _, toks in serve_stream(cfg):
        pages = []
        for h in chunk_hashes(toks, page):
            if h not in eng.prefix.pages:
                break
            pages.append(eng.prefix.pages[h])
        if pages and pages not in tables:
            tables.append(pages)
    if not tables:
        raise AssertionError("no prefix is resident in the prefix cache")
    n = max(map(len, tables))
    bt = torch.tensor([t + [0] * (n - len(t)) for t in tables],
                      dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(0)
    lens = torch.tensor([int(rng.integers(1, len(t) * page + 1)) for t in tables],
                        dtype=torch.int32, device="cuda")
    B = len(tables)
    g = torch.Generator(device="cuda").manual_seed(0)
    err, err_dense = 0.0, 0.0
    for li, (pk, pv) in enumerate(eng.layer_pools()):
        q = torch.randn((B, cfg.n_heads, cfg.d_head), generator=g,
                        device="cuda").to(pk.dtype)
        got = pg.paged_attention(q, pk, pv, bt, lens)
        want = pg.paged_attention_plain(q, pk, pv, bt, lens)
        err = max(err, hold_attention(f"paged_on_pool layer {li}", got, want,
                                      "bfloat16"))
        kd = torch.zeros((1, B, n * page, cfg.n_kv_heads, cfg.d_head),
                         dtype=pk.dtype, device="cuda")
        vd = torch.zeros_like(kd)
        for b, t in enumerate(tables):
            kv_pages.gather_pages(kd, pk[None], b, t)
            kv_pages.gather_pages(vd, pv[None], b, t)
        dense = chunked_attention(q[:, None], kd[0], vd[0],
                                  (lens - 1)[:, None], lens, causal=False,
                                  chunk=n * page)[:, 0]
        err_dense = max(err_dense, hold_attention(
            f"paged_on_pool layer {li} vs dense gather", got, dense,
            "bfloat16"))
    rec["paged_on_pool"] = {"tables": tables, "seq_lens": lens.tolist(),
                            "max_abs_err_plain": err,
                            "max_abs_err_dense": err_dense}
    rec["paged_attention_max_abs_err"] = max(rec["paged_attention_max_abs_err"],
                                             err)


def wkv_inputs(B, T, H, dh, io, wt, seed, decay="sigmoid"):
    """r, k, v (``io``), w (``wt``) and u (float32) on the card.  w is the
    sigmoid of a normal, as the reference's test ("sigmoid"; "exact": with
    a tenth of the entries exactly 0 and a tenth exactly 1), or the model's
    exp(-exp(x)) with x uniform in [-8, 4] ("model")."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, dh), generator=g, device="cuda").to(
        _dtype(io)) for _ in range(3))
    if decay in ("sigmoid", "exact"):
        w = torch.sigmoid(torch.randn((B, T, H, dh), generator=g, device="cuda"))
        if decay == "exact":
            pick = torch.rand((B, T, H, dh), generator=g, device="cuda")
            w = torch.where(pick < 0.1, 0.0, torch.where(pick > 0.9, 1.0, w))
    else:
        x = torch.rand((B, T, H, dh), generator=g, device="cuda") * 12.0 - 8.0
        w = torch.exp(-torch.exp(x))
    u = torch.randn((H, dh), generator=g, device="cuda")
    return r, k, v, w.to(_dtype(wt)), u


def hold_scaled(what, got, want, rel) -> float:
    """Raise unless ``got`` is finite and within ``rel`` of want's largest
    magnitude; returns max |d|."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if err > rel * scale:
        raise AssertionError(f"{what}: max |d| {err:.4g} > {rel} x scale "
                             f"{scale:.4g}")
    print(f"{what}: kernel == plain within {rel} of the scale {scale:.4g}, "
          f"max |d| = {err:.3g}", flush=True)
    return err


def check_wkv(rec):
    """The WKV kernels against their plain version: the reference's
    WKV_CASES from a zero state (through ``ops.wkv6_scan``), a random
    initial state in and out (y and the final state), one decode step, the
    full-width prefill shape in the model's types; then the chunked
    kernel's cases of ``tests/test_torch_wkv_cuda.py`` (every type
    combination and head width at T = 130, ragged T, decays of exactly 0
    and 1 on both routes), each case's route asserted."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops
    from test_torch_wkv_cuda import CHUNKED_CASES, RAGGED_T

    err = 0.0
    for i, (B, T, H, dh, chunk, dt) in enumerate(WKV_CASES):
        r, k, v, w, u = wkv_inputs(B, T, H, dh, dt, dt, seed=i)
        u = u.to(_dtype(dt))
        err = max(err, hold_attention(
            f"wkv6_scan {(B, T, H, dh, chunk, dt)}",
            ops.wkv6_scan(r, k, v, w, u, chunk=chunk),
            ls.wkv6_scan_plain(r, k, v, w, u)[1].to(_dtype(dt)), dt,
            tol=WKV_TOL[dt]))
    cases = WKV_STATE_CASES + ((*WKV_FULL, "bfloat16", "float32"),)
    for i, (B, T, H, dh, io, wt) in enumerate(cases):
        full = (B, T, H, dh) == WKV_FULL
        r, k, v, w, u = wkv_inputs(B, T, H, dh, io, wt, seed=10 + i,
                                   decay="model" if full else "sigmoid")
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        s0 = torch.randn((B, H, dh, dh), generator=g, device="cuda")
        if full:  # the model's prefill starts from zero
            s0.zero_()
        got_s, got_y = ls.wkv6_scan(r, k, v, w, u, s0.clone())
        want_s, want_y = ls.wkv6_scan_plain(r, k, v, w, u, s0.clone())
        what = f"wkv6_scan with state {(B, T, H, dh, io, wt)}"
        if full:  # the state grows over 2048 steps: held to its scale
            err = max(err, hold_scaled(f"{what} y", got_y, want_y, 1e-4),
                      hold_scaled(f"{what} state", got_s, want_s, 1e-4))
        else:
            err = max(err, hold_attention(f"{what} y", got_y, want_y,
                                          "float32", tol=WKV_TOL["float32"]),
                      hold_attention(f"{what} state", got_s, want_s,
                                     "float32", tol=WKV_TOL["float32"]))
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    cases = [(2, 130, 3, dh, *(names[d] for d in combo), "model")
             for combo, dh in CHUNKED_CASES]
    cases += [(1, T, 4, 64, "bfloat16", "float32", "float32", "model")
              for T in RAGGED_T]
    cases += [(2, T, 2, 32, *(names[d] for d in combo), "exact")
              for combo in ls.TYPE_COMBOS for T in (65, 33)]
    for i, (B, T, H, dh, io, wt, yt, decay) in enumerate(cases):
        r, k, v, w, u = wkv_inputs(B, T, H, dh, io, wt, seed=40 + i, decay=decay)
        g = torch.Generator(device="cuda").manual_seed(80 + i)
        s0 = torch.randn((B, H, dh, dh), generator=g, device="cuda")
        before = (ls.wkv6_scan.launches, ls.wkv6_scan.chunked_launches)
        got_s, got_y = ls.wkv6_scan(r, k, v, w, u, s0.clone(), y_dtype=_dtype(yt))
        chunked = ls.wkv6_scan.chunked_launches - before[1]
        if (ls.wkv6_scan.launches - before[0], chunked) != (
                1, int(ls.route_for(T) == "chunked")):
            raise AssertionError(f"wkv6_scan T {T} took the wrong route")
        want_s, want_y = ls.wkv6_scan_plain(r, k, v, w, u, s0.clone())
        what = (f"wkv6_scan {ls.route_for(T)} {(B, T, H, dh, io, wt, yt)} "
                f"{decay} decays")
        err = max(err, hold_attention(f"{what} y", got_y, want_y.to(_dtype(yt)),
                                      yt, tol=WKV_TOL[yt]),
                  hold_attention(f"{what} state", got_s, want_s, "float32",
                                 tol=WKV_TOL["float32"]))
    rec["wkv6_scan_max_abs_err"] = err


def rwkv_models(phases):
    """Full-width rwkv6-7b from seed 0 in bf16, and the same weights in
    float32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer

    cfg = get_config(RWKV_ARCH)
    model = (cfg, phases.run("rwkv_init", transformer.init_params, cfg))
    model32 = (dataclasses.replace(cfg, param_dtype="float32",
                                   compute_dtype="float32"),
               to_float32(model[1]))
    n = sum(t.numel() for t in leaves(model[1]))
    print(f"{cfg.name}: {n} parameters drawn ({cfg.param_count()} by "
          f"param_count), {n * 2 / 1e9:.2f} GB in bf16 and {n * 4 / 1e9:.2f} "
          f"GB in float32", flush=True)
    return model, model32


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def peak_memory(what):
    import torch

    gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{what}: peak device memory allocated {gb:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    return gb


def rwkv_prefill_path(rec, model, model32):
    """Full-width rwkv6-7b: a bf16 ``forward`` on 2 x 2048 tokens, timed
    (32 WKV launches per forward, all on the chunked route); in float32 on 1 x 256 tokens, the logits
    through the kernel against the same forward with ``_wkv_scan`` replaced
    by the plain version, and against a prefill of 240 tokens followed by
    16 single-token ``decode_step``s, each within 1e-4 of the logits'
    scale."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import transformer

    cfg, params = model
    cfg32, params32 = model32
    B, T = WKV_FULL[:2]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)).cuda()
    out = {"shape": [B, T]}
    for label in ("first", "timed"):
        before = (ls.wkv6_scan.launches, ls.wkv6_scan.chunked_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = transformer.forward(params, toks, cfg)[0]
        torch.cuda.synchronize()
        out[f"bf16_forward_s_{label}"] = time.perf_counter() - t0
        n = ls.wkv6_scan.launches - before[0]
        n_chunked = ls.wkv6_scan.chunked_launches - before[1]
        if not n == n_chunked == cfg.n_layers:
            raise AssertionError(f"a bf16 forward launched the WKV kernels {n} "
                                 f"times, {n_chunked} of them chunked, not "
                                 f"{cfg.n_layers} chunked")
        if logits.shape != (B, T, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError("rwkv bf16 prefill logits: bad shape or "
                                 "non-finite")
        del logits
    out["wkv_launches_per_forward"] = cfg.n_layers

    toks32 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, RWKV_CHECK_T)).astype(np.int32)).cuda()
    kern = transformer.forward(params32, toks32, cfg32)[0]
    with mock.patch("repro_torch.models.rwkv._wkv_scan", ls.wkv6_scan_plain):
        before = ls.wkv6_scan.launches
        plain = transformer.forward(params32, toks32, cfg32)[0]
        if ls.wkv6_scan.launches != before:
            raise AssertionError("the patched forward launched the kernel")
    scale = float(plain.abs().max())
    d_plain = float((kern - plain).abs().max())
    caches = transformer.init_cache(cfg32, 1, RWKV_CHECK_T)
    transformer.forward(params32, toks32[:, :RWKV_SPLIT], cfg32, caches=caches,
                        cache_len=[0])
    for s in range(RWKV_SPLIT, RWKV_CHECK_T):
        step, caches = transformer.decode_step(params32, toks32[:, s:s + 1],
                                               caches, [s], cfg32)
    d_rec = float((step[:, 0] - kern[:, -1]).abs().max())
    rec_scale = float(kern[:, -1].abs().max())
    out["float32"] = {
        "tokens": RWKV_CHECK_T, "logit_scale": scale,
        "kernel_vs_plain_max_abs_dlogit": d_plain,
        "argmax_agreement": float((kern.argmax(-1) == plain.argmax(-1)).float().mean()),
        "prefill_then_decode": [RWKV_SPLIT, RWKV_CHECK_T - RWKV_SPLIT],
        "decode_vs_forward_max_abs_dlogit": d_rec,
        "decode_vs_forward_scale": rec_scale}
    rec["rwkv_prefill_path"] = out
    print(f"rwkv prefill {cfg.name} bf16 {B}x{T}: forward "
          f"{out['bf16_forward_s_timed']:.4f} s (first "
          f"{out['bf16_forward_s_first']:.4f} s), {cfg.n_layers} WKV launches "
          f"per forward, all chunked", flush=True)
    print(f"rwkv prefill float32 1x{RWKV_CHECK_T}: kernel vs plain scan max "
          f"|d logit| {d_plain:.4g} of a {scale:.4g} scale (argmax agreement "
          f"{out['float32']['argmax_agreement']:.4f}); prefill {RWKV_SPLIT} + "
          f"{RWKV_CHECK_T - RWKV_SPLIT} decode steps vs one forward: max "
          f"|d logit| {d_rec:.4g} of {rec_scale:.4g}", flush=True)
    if not (torch.isfinite(kern).all() and torch.isfinite(step).all()):
        raise AssertionError("rwkv float32 logits are not finite")
    if d_plain > 1e-4 * scale:
        raise AssertionError("float32 rwkv logits through the WKV kernel and "
                             f"the plain scan differ by {d_plain:.4g}")
    if d_rec > 1e-4 * rec_scale:
        raise AssertionError("float32 rwkv prefill + decode differs from one "
                             f"forward by {d_rec:.4g}")
    out["peak_gb"] = peak_memory("rwkv_prefill_path")


def state_controller_replay(stream, **overrides):
    """The state-mode controller (``Engine._admit_state``) on ``stream``
    with no model: the engine's admission order and draws.  Returns the
    engine's ``stats()`` keys but ``decode_steps``, and the hits whose
    snapshot was stored by a prompt with another head (all tokens but the
    last): the reference fault of ROADMAP queue 3."""
    import numpy as np
    from repro_torch.serving import PageAllocator, PrefixCache, chunk_hashes

    sc = {**SERVE, "bypass_fraction": 0.0, "seed": 0, **overrides}
    alloc = PageAllocator(sc["n_pages"])
    cache = PrefixCache(alloc, sc["prefix_capacity"], policy=sc["policy"])
    rng = np.random.default_rng(sc["seed"])
    heads, unsound = {}, 0
    for toks in stream:
        if rng.random() < sc["bypass_fraction"]:
            cache.stats.bypassed += 1
            continue
        hashes = chunk_hashes(toks, sc["page_size"])
        if not hashes:
            continue
        if hashes[-1] in cache.pages:
            pages, _ = cache.lookup(hashes[-1:])
            unsound += heads[pages[0]] != tuple(toks[:-1].tolist())
            continue
        cache.stats.chunk_misses += 1
        page = cache.insert(hashes[-1], rng.random())
        if page is not None:
            heads[page] = tuple(toks[:-1].tolist())
    s = cache.stats
    return {"chunk_hit_ratio": s.hit_ratio, "controller_ops": s.ops.tolist(),
            "evictions": s.evictions, "bypassed": s.bypassed,
            "pages_free": alloc.n_free}, unsound


def run_state_engine(cfg, params, stream, **overrides):
    """The launch/serve.py engine on ``stream``, instrumented: each
    admission timed (host clock around synchronised work), and every
    restored snapshot checked against the head of the prompt that stored
    it.  Returns (engine, requests, wall seconds, log)."""
    from contextlib import ExitStack
    from unittest import mock

    import torch
    from repro_torch.serving import Engine, ServeConfig

    eng = Engine(cfg, params, ServeConfig(**{**SERVE, **overrides}))
    log = {"admit_s": [], "restored": 0, "unsound": 0}
    heads, cur = {}, {}
    admit, store, restore = eng._admit, eng._store_state, eng._restore_state

    def timed_admit(r, slot):
        cur["head"] = tuple(r.tokens[:-1].tolist())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit(r, slot)
        torch.cuda.synchronize()
        log["admit_s"].append(time.perf_counter() - t0)

    def stored(cache1, page):
        heads[page] = cur["head"]
        store(cache1, page)

    def restored(cache1, page):
        log["restored"] += 1
        log["unsound"] += heads[page] != cur["head"]
        restore(cache1, page)

    reqs = [eng.submit(t) for t in stream]
    with ExitStack() as stack:
        for name, fn in (("_admit", timed_admit), ("_store_state", stored),
                         ("_restore_state", restored)):
            stack.enter_context(mock.patch.object(eng, name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not all(r.done and len(r.out) == SERVE["max_new_tokens"] for r in reqs):
        raise AssertionError(f"{cfg.name}: a request was not served in full")
    return eng, reqs, wall, log


def rwkv_serve_path(rec, model, model32):
    """The Engine on full-width rwkv6-7b.  (a) bf16, timed, on
    ``launch/serve.py``'s stream (24-token prefixes + 6-token tails on
    8-token pages): stats() equal a model-free replay of the state-mode
    controller, and so does the count of hits that restored a snapshot
    holding another prompt's tail (the reference fault, ROADMAP queue 3).
    The same stream with the controller bypassed shows what the fault
    changes: the requests whose tokens differ are printed.  (b) float32 on
    whole-prefix prompts (new_tokens=0), where every hit is sound: tokens
    identical with the prefix cache on and off, and every hit skips all but
    the last token."""
    import torch
    from repro_torch.training.data import zipf_request_stream

    cfg, params = model
    stream = [t for _, t in serve_stream(cfg)]
    eng, reqs, wall, log = run_state_engine(cfg, params, stream)
    want, want_unsound = state_controller_replay(stream)
    got = {k: v for k, v in eng.stats().items() if k != "decode_steps"}
    if got != want:
        raise AssertionError(f"rwkv serve bf16: stats {got} != controller "
                             f"replay {want}")
    if log["unsound"] != want_unsound:
        raise AssertionError(f"rwkv serve bf16: {log['unsound']} hits restored "
                             f"another prompt's tail, the replay predicts "
                             f"{want_unsound}")
    decode_tokens = eng.metrics.snapshot()["counters"]["decode_tokens_count"]
    admit_s = sum(log["admit_s"])
    steps = eng.decode_steps
    out = {"bf16": {
        "wall_s": wall, "ticks": eng.ticks, "decode_steps": steps,
        "decode_tokens": decode_tokens, "decode_tokens_per_s": decode_tokens / wall,
        "admissions": len(log["admit_s"]),
        "ms_per_admission": 1e3 * admit_s / len(log["admit_s"]),
        "ms_per_decode_step": 1e3 * (wall - admit_s) / steps,
        "prefill_tokens_computed": sum(r.prefill_tokens_computed for r in reqs),
        "prefill_tokens_skipped": sum(r.prefill_tokens_skipped for r in reqs),
        "stats": eng.stats(), "restored_snapshots": log["restored"],
        "unsound_hits": log["unsound"], "unsound_hits_replay": want_unsound}}
    b = out["bf16"]
    print(f"rwkv serve {cfg.name} bf16: {wall:.3f} s, {eng.ticks} ticks, "
          f"{decode_tokens} decode tokens ({b['decode_tokens_per_s']:.1f} tok/s), "
          f"{b['ms_per_decode_step']:.2f} ms per decode step (wall less "
          f"admissions), {b['ms_per_admission']:.2f} ms per admission, prefill "
          f"tokens computed {b['prefill_tokens_computed']} / skipped "
          f"{b['prefill_tokens_skipped']}; stats == state-mode controller "
          f"replay {got}", flush=True)
    print(f"rwkv serve bf16: reference fault (ROADMAP queue 3): "
          f"{log['unsound']} of {log['restored']} restored snapshots hold "
          f"another prompt's tail (replay predicts {want_unsound})", flush=True)
    del eng
    torch.cuda.empty_cache()
    # what the fault costs: the same stream with the controller bypassed
    _, off16, _, _ = run_state_engine(cfg, params, stream, bypass_fraction=1.0)
    changed = sum(a.out != b.out for a, b in zip(reqs, off16))
    b["requests_changed_by_the_fault"] = changed
    print(f"rwkv serve bf16: {changed} of {len(reqs)} requests decode other "
          f"tokens than with the prefix cache bypassed", flush=True)
    b["peak_gb"] = peak_memory("rwkv_serve_path bf16")

    cfg32, params32 = model32
    whole = [t for _, t in zipf_request_stream(
        SERVE_STREAM["n_requests"], SERVE_STREAM["n_prefixes"],
        SERVE_STREAM["prefix_len"], cfg32.vocab, seed=SERVE_STREAM["seed"],
        new_tokens=0)]
    eng32, on, wall32, log32 = run_state_engine(cfg32, params32, whole)
    want32, unsound32 = state_controller_replay(whole)
    st32 = eng32.stats()
    del eng32
    torch.cuda.empty_cache()
    _, off, _, _ = run_state_engine(cfg32, params32, whole, bypass_fraction=1.0)
    hits = [r for r in on if r.prefill_tokens_skipped]
    if {k: v for k, v in st32.items() if k != "decode_steps"} != want32:
        raise AssertionError(f"rwkv serve f32: stats {st32} != replay {want32}")
    if not hits or log32["unsound"] or unsound32:
        raise AssertionError("rwkv serve f32: no hit, or an unsound hit on "
                             "whole-prefix prompts")
    if any(r.prefill_tokens_skipped != len(r.tokens) - 1 for r in hits):
        raise AssertionError("rwkv serve f32: a hit skipped other than len-1")
    same = sum(a.out == b.out for a, b in zip(on, off))
    print(f"rwkv serve f32 (whole-prefix prompts): {len(hits)} hits, each "
          f"skipping len-1 tokens; {same}/{len(on)} requests serve identical "
          f"tokens with and without the prefix cache ({wall32:.3f} s)",
          flush=True)
    if same != len(on):
        raise AssertionError("rwkv serve f32: tokens differ with and without "
                             "the prefix cache on sound hits")
    out["f32"] = {"wall_s": wall32, "stats": st32, "hits": len(hits),
                  "identical_requests": same,
                  "peak_gb": peak_memory("rwkv_serve_path f32")}
    rec["rwkv_serve_path"] = out


def wkv_chunked_flops(B, T, H, dh, chunk=64) -> int:
    """Operations of the chunked form's products, each taken once (split
    TF32 runs two or three tensor-core products for each): per chunk of
    each (b, h), (r D) S0 and (k D)^T V, 2 C dh^2 each, and the intra
    matrix A with A V, C^2 dh each over the block lower triangle."""
    return B * H * -(-T // chunk) * 2 * dh * chunk * (2 * dh + chunk)


def wkv_rows(rec):
    """The WKV kernels at the prefill path's shape (B 2, T 2048: the
    chunked route, and the sequential kernel on the same inputs) and at the
    engine's decode step (B 4, T 1: the sequential route), in the model's
    types with a state in and out: the device time per launch
    (``device_ms``), the host-inclusive time of launches one after another
    (CUDA events), the plain version's time, and the bound: the larger of
    the bytes (r/k/v bf16, w and y float32, u, the state read and written)
    over the memory rate and the route's operations, for the chunked route
    its products (``wkv_chunked_flops``) at the TF32 tensor-core rate, for
    the sequential route 6 B T H dh^2 operations at the float32 rate (also
    printed beside the chunked route's bound, as ``recurrence_bound_ms``,
    the sequential kernel's bound).  No single PyTorch call computes WKV6,
    so the library time is none."""
    import torch
    from repro_torch.kernels import linear_scan as ls

    rows = {}
    for name, shape, reps, plain_reps in (("prefill", WKV_FULL, 20, 2),
                                          ("decode", WKV_DECODE, 200, 20)):
        B, T, H, dh = shape
        r, k, v, w, u = wkv_inputs(B, T, H, dh, "bfloat16", "float32",
                                   seed=200, decay="model")
        state = torch.zeros((B, H, dh, dh), device="cuda")
        nbytes = (3 * r.numel() * r.element_size() + 2 * w.numel() * 4
                  + u.numel() * 4 + 2 * state.numel() * 4)
        route = ls.route_for(T)
        ops = (wkv_chunked_flops(B, T, H, dh) if route == "chunked"
               else 6 * B * T * H * dh * dh)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (TF32_TENSOR_FLOPS if route == "chunked"
                       else SCALAR_OPS_PER_S) * 1e3

        def kernel(route=route):
            ls.launch(r, k, v, w, u, state, torch.float32, route=route)

        rows[name] = {
            "shape": list(shape), "route": route, "bytes": nbytes, "ops": ops,
            "ms": device_ms(kernel, reps=reps),
            "launch_host_ms": cuda_ms(kernel, reps=reps),
            "plain_ms": cuda_ms(lambda: ls.wkv6_scan_plain(r, k, v, w, u, state),
                                reps=plain_reps),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if route == "chunked":
            rows[name]["sequential_ms"] = device_ms(
                lambda: kernel("sequential"), reps=reps)
            rows[name]["recurrence_bound_ms"] = (6 * B * T * H * dh * dh
                                                 / SCALAR_OPS_PER_S * 1e3)
        print(f"wkv6_scan {name} {shape}: " + json.dumps(rows[name]), flush=True)
    pf = rows["prefill"]
    if not pf["ms"] < pf["sequential_ms"]:
        raise AssertionError(f"the chunked WKV kernel ({pf['ms']:.4f} ms) is not "
                             f"faster than the sequential one "
                             f"({pf['sequential_ms']:.4f} ms) at the prefill shape")
    rec["timing"]["wkv"] = rows
    return [{"name": "wkv6_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
             "replaces": "src/repro/kernels/linear_scan.py:23",
             "ms": pf["ms"], "plain_ms": pf["plain_ms"],
             "bound_ms": pf["bound_ms"], "bound_by": pf["bound_by"],
             "library_ms": None}]


def attention_bound(r, ops_per_s):
    """(bound ms, "bytes" or "operations") of a timing row's work."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["flops"] / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_timing():
    """The flash and paged kernels at their full-width shapes: per-launch
    time (CUDA events), the plain version's, one PyTorch library call's
    (scaled_dot_product_attention in the inputs' type: a yardstick, never
    on a path) and the work's bound.  The flash kernels run each in its
    type at the prefill path's shape, with and without the window: the
    tensor-core kernel in bf16 (bound at the bf16 tensor-core rate), the
    split-TF32 kernel in float32 (bound by its three tensor-core products
    per product, two for bf16 inputs, at the TF32 rate; the same work at
    the float32-unit rate is kept as ``scalar_bound_ms``); each row has its
    achieved TFLOP/s and the share of its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import paged_attention as pg

    rows = {}
    for case in FLASH_FULL + FLASH_FULL_F32:
        B, T, S, H, KV, dh, causal, window = case[:8]
        q, k, v = flash_inputs(case, seed=100)
        tc = fl.kernel_for(q.dtype, dh) == "tensor_core"
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = (window * (window + 1) // 2 + (T - window) * window
                 if window else T * (T + 1) // 2)
        r = {"shape": list(case),
             "ms": cuda_ms(lambda: fl.launch(q, k, v, causal, window),
                           reps=20 if tc else 5),
             "plain_ms": cuda_ms(lambda: fl.flash_attention_plain(
                 q, k, v, causal, window), reps=3),
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
             if not window else None,
             "flops": 4 * B * H * dh * pairs,
             "bytes": (2 * B * T * H + 2 * B * S * KV) * dh * q.element_size()}
        if tc:
            r["bound_ms"], r["bound_by"] = attention_bound(r, BF16_TENSOR_FLOPS)
        else:
            products = 2 if q.dtype == torch.bfloat16 else 3  # split TF32
            r["bound_ms"], r["bound_by"] = attention_bound(
                r, TF32_TENSOR_FLOPS / products)
            r["scalar_bound_ms"] = r["flops"] / SCALAR_OPS_PER_S * 1e3
        r["tflops"] = r["flops"] / r["ms"] / 1e9
        r["bound_share"] = r["bound_ms"] / r["ms"]
        rows[f"{'sm90' if tc else 'f32'}_window{window}"] = r
    B, H, KV, dh, page, n, P = PAGED_FULL[:7]
    q, pk, pv, bt, lens = paged_inputs(PAGED_FULL, seed=100)
    need = (lens.long() + page - 1) // page * page  # positions of the pages read
    nbytes = int(need.sum()) * KV * dh * 2 * pk.element_size() \
        + 2 * q.numel() * q.element_size() + 4 * (bt.numel() + B)
    kd = pk[bt.long()].reshape(B, n * page, KV, dh).transpose(1, 2).contiguous()
    vd = pv[bt.long()].reshape(B, n * page, KV, dh).transpose(1, 2).contiguous()
    mask = (torch.arange(n * page, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    rows["paged"] = {
        "shape": list(PAGED_FULL[:7]), "seq_lens_sum": int(lens.sum()),
        "ms": cuda_ms(lambda: pg.launch(q, pk, pv, bt, lens), reps=20),
        "plain_ms": cuda_ms(lambda: pg.paged_attention_plain(q, pk, pv, bt, lens),
                            reps=5),
        "library_ms_excluding_gather": cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True),
            reps=20),
        "flops": 4 * H * dh * int(lens.sum()), "bytes": nbytes}
    pg_row = rows["paged"]
    pg_row["bound_ms"], pg_row["bound_by"] = attention_bound(pg_row,
                                                             BF16_TENSOR_FLOPS)
    pg_row["bound_share"] = pg_row["bound_ms"] / pg_row["ms"]
    for name, r in rows.items():
        print(f"{name}: " + json.dumps(r), flush=True)
    return rows


# the checks that time nothing, by name, in the order they are handed to
# the workers (longest first)
PARALLEL_CHECKS = {
    "event_sim_vs_plain": check_event_sim,
    "tiers_long_vs_plain": check_tiers_long,
    "sketch_ext_vs_plain": check_sketch_ext,
    "sketch_vs_plain": check_sketch,
    "sketch_tiers_vs_plain": check_sketch_tiers,
    "replay_vs_plain": check_replay,
    "trace_ext_vs_plain": check_trace_ext,
    "cluster_vs_plain": check_cluster,
    "tiers_vs_plain": check_tiers,
    "trace_ext_tiers_vs_plain": check_trace_ext_tiers,
    "trace_vs_plain": check_trace,
    "open_vs_plain": check_open,
    "trace_ext_fig_vs_plain": check_trace_ext_fig,
    "coalesce_vs_plain": check_coalesce,
    "sketch_trace_bc_vs_plain": check_sketch_trace_bc,
    "sketch_trace_vs_plain": check_sketch_trace,
}


def _check_worker_init():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


WORKER_JOBS = {**PARALLEL_CHECKS, **FULL_SIZE_PLAIN}


def _run_check(name):
    """One check in a worker: (name, seconds, what it recorded)."""
    rec = {}
    t0 = time.perf_counter()
    WORKER_JOBS[name](rec)
    seconds = time.perf_counter() - t0
    print(f"check {name}: {seconds:.3f} s", flush=True)
    return name, seconds, rec


def run_workers(jobs, n_workers, rec, seconds_key):
    """Run the checks ``jobs`` (names of ``WORKER_JOBS``) in ``n_workers``
    processes (spawned, so each has its own CUDA context; the kernels are
    the build's), and merge what each recorded into ``rec``: the largest of
    each ``*_max_abs_err``, the last of any other key; each check's seconds
    under ``rec[seconds_key]``.  Returns what they recorded, merged.  A
    check that fails fails the caller; leaving the pool stops every
    worker."""
    import multiprocessing

    seconds, merged = {}, {}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n_workers, initializer=_check_worker_init) as pool:
        for name, sec, got in pool.imap_unordered(_run_check, jobs):
            seconds[name] = sec
            for k, v in got.items():
                merged[k] = v
                rec[k] = (max(rec.get(k, 0.0), v)
                          if k.endswith("_max_abs_err") else v)
    rec[seconds_key] = seconds
    return merged


def parallel_checks(rec):
    """Run ``PARALLEL_CHECKS`` in ``CHECK_WORKERS`` processes
    (:func:`run_workers`); a check that fails fails the phase."""
    run_workers(PARALLEL_CHECKS, CHECK_WORKERS, rec, "check_seconds")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # the replay's edge lanes
    # float32 products in full float32, as the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import cache_update as cu
    from repro_torch.kernels import event_sim as es
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import paged_attention as pg
    from repro_torch.kernels import replay as kr
    from repro_torch.kernels import sketch as ksk
    from repro_torch.models import transformer

    from repro_torch.obs.provenance import collect

    phases = Phases()
    card = phases.run("device", card_line)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    prov = collect(config={"script": "chip_smoke.py"}, device="cuda")
    print(f"provenance: {json.dumps(prov)}", flush=True)
    ptxas = start_ptxas()
    phases.run("build", _build.load_library)
    rec = {"card": card, "provenance": prov}
    phases.run("event_sim_ptxas", event_sim_ptxas, rec)
    phases.run("replay_ptxas", replay_ptxas, ptxas, rec)
    phases.run("wkv_ptxas", wkv_ptxas, ptxas, rec)
    phases.run("flash_ptxas", flash_ptxas, ptxas, rec)
    sass = start_sass()
    phases.run("parallel_checks", parallel_checks, rec)
    phases.run("sass", sass_counts, sass, rec)
    phases.run("lru_update_vs_plain", check_lru_update, rec)
    phases.run("flash_vs_plain", check_flash, rec)
    phases.run("paged_vs_plain", check_paged, rec)
    phases.run("wkv_vs_plain", check_wkv, rec)

    kr.replay_lanes.launches = 0
    es.sim_lanes.launches = 0
    phases.run("main_path", main_path, rec)
    launches = {"replay": kr.replay_lanes.launches,
                "event_sim": es.sim_lanes.launches}
    hold_main_path(rec, launches)
    es.sim_lanes.traced_launches = 0
    es.sim_lanes.traced_flows_launches = es.sim_lanes.traced_tiers_launches = 0
    es.sim_open_lanes.traced_launches = 0
    phases.run("traced_path", traced_path, rec)
    launches["event_sim_traced"] = es.sim_lanes.traced_launches
    launches["event_sim_traced_ext"] = (es.sim_lanes.traced_flows_launches
                                        + es.sim_lanes.traced_tiers_launches
                                        + es.sim_open_lanes.traced_launches)
    cu.lru_update.launches = 0
    phases.run("lru_update_path", lru_update_path, rec)
    launches["lru_batch_update"] = cu.lru_update.launches
    es.sim_lanes.flows_launches = 0
    es.sim_open_lanes.launches = 0
    es.sim_lanes.tiers_launches = 0
    es.sim_lanes.sketch_launches = 0
    ksk.sketch_trace_lanes.launches = 0
    phases.run("figures_path", figures_path, rec)
    launches["event_sim_coalesced"] = es.sim_lanes.flows_launches
    launches["event_sim_open"] = es.sim_open_lanes.launches
    # the sketched instantiations and the sketch_trace kernel: fig_drift
    launches["event_sim_sketch"] = es.sim_lanes.sketch_launches
    launches["sketch_trace"] = ksk.sketch_trace_lanes.launches
    # the tiered kernel's path: fig_hierarchy (in figures_path) and the
    # hierarchy's differential
    phases.run("hierarchy_differential", hierarchy_differential, rec)
    launches["event_sim_tiers"] = es.sim_lanes.tiers_launches
    es.sim_lanes.count_launches = 0
    phases.run("cluster_differential", cluster_differential, rec)
    launches["event_sim_count"] = es.sim_lanes.count_launches
    # the full-width model in bf16, and the same weights in float32
    cfg = get_config(ARCH)
    model = (cfg, phases.run("model_init", transformer.init_params, cfg))
    model32 = (dataclasses.replace(cfg, param_dtype="float32",
                                   compute_dtype="float32"),
               to_float32(model[1]))
    fl.flash_attention.launches = 0
    fl.flash_attention.tensor_core_launches = 0
    phases.run("prefill_path", prefill_path, rec, model, model32)
    launches["flash_attention_sm90"] = fl.flash_attention.tensor_core_launches
    launches["flash_attention"] = (fl.flash_attention.launches
                                   - launches["flash_attention_sm90"])
    if not (launches["flash_attention_sm90"] == launches["flash_attention"]
            == cfg.n_layers):
        raise AssertionError(f"the prefill path launched the tensor-core flash "
                             f"kernel {launches['flash_attention_sm90']} times "
                             f"and the split-TF32 one "
                             f"{launches['flash_attention']}, not "
                             f"{cfg.n_layers} each (one bf16 and one float32 "
                             f"forward)")
    eng = phases.run("serve_path", serve_path, rec, model, model32)
    pg.paged_attention.launches = 0
    phases.run("paged_on_pool", paged_on_pool, rec, eng)
    launches["paged_attention"] = pg.paged_attention.launches
    del model, model32, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the rwkv6 family on full-width rwkv6-7b, bf16 and float32 copies
    model, model32 = rwkv_models(phases)
    peak_memory("rwkv_init")
    ls.wkv6_scan.launches = ls.wkv6_scan.chunked_launches = 0
    phases.run("rwkv_prefill_path", rwkv_prefill_path, rec, model, model32)
    phases.run("rwkv_serve_path", rwkv_serve_path, rec, model, model32)
    launches["wkv6_scan"] = ls.wkv6_scan.launches
    rec["wkv_route_launches"] = {
        "chunked": ls.wkv6_scan.chunked_launches,
        "sequential": ls.wkv6_scan.launches - ls.wkv6_scan.chunked_launches}
    del model, model32
    torch.cuda.empty_cache()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"its path never launched the {name} kernel")

    rec["main_path_wall_s"] = phases.seconds["main_path"]
    phases.run("main_path_profile", profile_main_path, rec)
    kernels = phases.run("full_size", full_size, rec)
    kernels += phases.run("ext_timing", ext_timing, rec)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = rec[f"{k['name']}_max_abs_err"]
    rec["kernels"] = kernels
    rec["phase_seconds"] = phases.seconds
    print(f"phases: {sum(phases.seconds.values()):.1f} s in all", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
