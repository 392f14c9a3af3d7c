"""The event-sim engine: the closed-loop (p_hit x seed) grid in one launch.

Port of ``repro.kernels.event_sim`` (the Pallas ``_sim_kernel``).  Each
lane is one (p_hit, seed) cell of a closed network with ``mpl`` jobs, run
on a **counter-based 32-bit hash stream** (a murmur3 finalizer over
``seed`` and an event counter) instead of threefry split chains.  Per
event: three uniforms, the argmin of the job ready times, FIFO release of
a c-server station by enqueue sequence, route advance (a fresh branch
when a request completes) and the warmup snapshot.

:func:`sim_lanes` is the kernel wrapper: on CUDA tensors it launches the
hand-written kernel (``csrc/event_sim.cu``: one warp per lane) or raises;
on CPU tensors it runs the plain version, :func:`sim_lanes_plain`, with
every lane batched and a per-lane active mask.  Both draw the very same
uniforms as the JAX engine (:func:`u01` is bit-identical to it), so a
network with deterministic service gives the same event sequence on all
three; exponential and Pareto draws go through float32 ``log``/``pow``,
whose last ulp may differ between libraries, so those are held
statistically.

The murmur3 arithmetic is uint32 with wraparound.  torch's CPU support for
``*``, ``>>`` and ``^`` on ``uint32`` is partial, so the plain version
computes in int64 masked with ``0xFFFFFFFF``.

With ``trace_cap=K > 0`` both versions also fill per-lane
:class:`~repro_torch.obs.trace.TraceRings` (the reference's
``_sim_kernel_traced``): per-job enter/leave stamps of the current
request's visits, and one record per completed request at ring row
``req % K``.  Tracing draws no random numbers, so the simulated system is
the untraced one bit for bit; with ``trace_cap=0`` no trace code runs
(the CUDA kernel's untraced instantiation compiles none).  Every mode
below traces too (the reference's threefry engine with ``trace_cap``):
the jobs a fill wakes write their records as delayed hits before the job
whose event it is (traced instantiations of its own source,
``csrc/event_sim_traced.cu``).

Two further modes, which the reference runs only on its threefry engine
(``repro.core.simulator._simulate`` with ``n_flows``, and
``_simulate_open``), run here on the counter engine, each an
instantiation of the same kernel with a plain version beside it:
**coalescing** (``n_flows > 0`` in :func:`sim_lanes`; plain
:func:`sim_lanes_plain`), an MSHR leader table per lane on which misses
for an in-flight flow park and complete as delayed hits at the fill, and
the **open loop** (:func:`sim_open_lanes`; plain
:func:`sim_open_lanes_plain`), Poisson or ON-OFF arrivals into a pool of
job slots with per-request sojourn and class records.  Their extra draws
come from a second keyed stream (:func:`lane_base2`), so the closed
loop's draws keep their counters and ``n_flows = 0`` runs the closed
kernel bit for bit as before.

**Per-branch counts** in the closed loop (``count_branches=True`` with
``n_flows = 0``): the measured completions per branch, which the
reference's threefry engine takes on every closed run and the cluster
prong reads per shard.  The closed kernel does not take them (its
instantiations keep their code); a fourth instantiation does
(``kCount``), with the closed loop's events draw for draw.

**Tiered MSHR tables** (``tiers`` with ``n_flows > 0``; the reference's
``_simulate_tiered``, threefry only): per-(branch, position) acquire and
release marks (:class:`LaneTiers`, from an
:class:`~repro_torch.core.simspec.MshrSpec`) in place of the disk ranks,
a leader table of ``n_groups * F`` entries, up to ``max_held`` held
entries per job, and fills that cascade: the jobs parked on a filled
entry complete as delayed hits and free the entries they hold, waking
their own followers.  A fifth instantiation of the kernel (``kTiers``);
its plain version is :func:`sim_lanes_plain` with ``tiers``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import fma_f32, resolve_device
from repro_torch.core.queueing import zipf_flow_weights
from repro_torch.core.simspec import (BIG_SEQ, INF_NS, SimResult, SimSpec,
                                      compile_network, stack_specs)
from repro_torch.kernels import _build
from repro_torch.kernels.sketch import sketch_args
from repro_torch.obs.streaming import (SketchState, decode_sketch_grid,
                                       pow_table, sketch_init, stream_arrival,
                                       stream_done, stream_done_many,
                                       stream_key, stream_tick)
from repro_torch.obs.trace import (CLS_DELAYED, CLS_HIT, CLS_MISS, TraceRings,
                                   decode_trace_grid, init_rings)

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x21F0AAAD
_MIX2 = 0x735A2D97
_INV24 = np.float32(1.0 / (1 << 24))
_U_LO = np.float32(1e-7)
_U_HI = np.float32(1.0 - 1e-7)
_NS_TO_US = np.float32(1e-3)
_T_MIN = np.float32(1e-6)
_CHUNK = 256  # events whose uniforms the plain version draws at once


def _f32(x: np.float32, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style 32-bit finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _M32
    x = x ^ (x >> 15)
    return x


def lane_base(seeds: torch.Tensor) -> torch.Tensor:
    """Per-lane stream base: ``_mix(uint32(seed) + GOLDEN)`` as int64."""
    return _mix((seeds.long() + _GOLDEN) & _M32)


def u01(base: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """The counter stream's uniforms in [1e-7, 1 - 1e-7], float32.

    ``base`` and ``ctr`` broadcast; the result is bit-identical to the
    reference ``u01`` closure of ``_sim_lane``.
    """
    ctr = torch.as_tensor(ctr, device=base.device)
    z = _mix((base + (ctr.long() & _M32) * _GOLDEN) & _M32)
    u = (z >> 8).to(torch.float32) * _f32(_INV24, z)
    return torch.clamp(u, min=_f32(_U_LO, z), max=_f32(_U_HI, z))


class _LaneSpec(NamedTuple):
    """The seven per-lane arrays of a compiled network the kernel reads."""

    is_queue: torch.Tensor     # (L, K) bool
    svc_ns: torch.Tensor       # (L, K) f32
    dist_id: torch.Tensor      # (L, K) i32
    dist_params: torch.Tensor  # (L, K, 4) f32
    branch_cum: torch.Tensor   # (L, B) f32
    visits: torch.Tensor       # (L, B, Lr) i32
    servers: torch.Tensor      # (L, K) i32


def _service_law(u: torch.Tensor, mean, dist, alpha, lo, hi,
                 raw_mean) -> torch.Tensor:
    """Service draws (ns, int64 >= 1) from uniforms ``u`` under the laws
    given elementwise (broadcast with ``u``): the reference formulas in
    float32, ``round`` half to even."""
    s_exp = -torch.log(u)
    ratio = 1.0 - torch.pow(lo / hi, alpha)
    # -1/alpha as a float32 division (a python scalar divided by a tensor
    # would go through reciprocal())
    s_par = lo * torch.pow(1.0 - u * ratio,
                           torch.full_like(alpha, -1.0) / alpha) / raw_mean
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    unit = torch.where(dist == 0, zero + 1.0,
                       torch.where(dist == 1, s_exp,
                                   torch.where(dist == 2, s_par, zero)))
    return torch.clamp(torch.round(unit * mean), min=1.0).to(torch.int64)


def _service_table(u: torch.Tensor, spec: _LaneSpec) -> torch.Tensor:
    """Service draws (ns, >= 1) from uniforms ``u`` (L, C) at every
    station: (L, C, K) int64."""
    return _service_law(u.unsqueeze(-1), spec.svc_ns[:, None, :],
                        spec.dist_id[:, None, :],
                        *(spec.dist_params[:, None, :, i] for i in range(4)))


def _service_at(u: torch.Tensor, spec: _LaneSpec,
                st: torch.Tensor) -> torch.Tensor:
    """Service draws from uniforms ``u`` (L, C) at the stations ``st`` (L,
    C): :func:`_service_table`'s values at ``st``."""
    lane = torch.arange(u.shape[0], device=u.device)[:, None]
    return _service_law(u, spec.svc_ns[lane, st], spec.dist_id[lane, st],
                        *(spec.dist_params[lane, st, i] for i in range(4)))


class LaneOutputs(NamedTuple):
    x: torch.Tensor           # (L,) f32 throughput, requests/µs
    completed: torch.Tensor   # (L,) i32
    events: torch.Tensor      # (L,) i32
    t_measured: torch.Tensor  # (L,) f32 µs
    rings: Optional[TraceRings] = None  # filled when trace_cap > 0
    # filled when n_flows > 0 or count_branches: the measured delayed-hit
    # fraction (L,) f32 (zero without coalescing), and the measured
    # completions and delayed hits per branch (L, B) i32
    delayed_frac: Optional[torch.Tensor] = None
    branch_done: Optional[torch.Tensor] = None
    branch_delayed: Optional[torch.Tensor] = None
    # filled with tiers: the measured delayed hits by the held level the
    # job parked at, (L, max_held) f32 fractions of measured completions
    delayed_tier: Optional[torch.Tensor] = None
    # filled when sketch_cap > 0: the lanes' streaming estimators
    sketch: Optional[SketchState] = None


class LaneTiers(NamedTuple):
    """The tiered MSHR tables of every lane (an
    :class:`~repro_torch.core.simspec.MshrSpec` per lane, see
    :func:`lane_tiers`): (L, B, Lr) int32 ``acq_group``, ``acq_slot`` and
    ``rel_slot`` (-1: nothing at that visit), and the leader groups and
    held levels of the widest lane."""

    acq_group: torch.Tensor
    acq_slot: torch.Tensor
    rel_slot: torch.Tensor
    n_groups: int
    max_held: int


def lane_tiers(mshrs, n_b: int, n_r: int, device) -> LaneTiers:
    """:class:`LaneTiers` of one MshrSpec per lane, padded as
    :func:`~repro_torch.core.simspec.stack_specs` pads the routes to
    ``n_b`` branches of ``n_r`` positions: past a route's end nothing is
    acquired or released, and a padded branch copies the lane's last
    real branch's marks, as it copies that branch's route."""
    def pad(a) -> np.ndarray:
        a = np.asarray(a, np.int32)
        b, r = a.shape
        a = np.concatenate([a, np.full((b, n_r - r), -1, np.int32)], axis=1)
        return np.concatenate([a, np.repeat(a[-1:], n_b - b, axis=0)])

    tables = [torch.from_numpy(np.stack([pad(getattr(m, f)) for m in mshrs]))
              .to(device) for f in ("acq_group", "acq_slot", "rel_slot")]
    return LaneTiers(*tables, n_groups=max(int(m.n_groups) for m in mshrs),
                     max_held=max(int(m.max_held) for m in mshrs))


def lane_base2(seeds: torch.Tensor) -> torch.Tensor:
    """Per-lane base of the second stream, ``_mix(uint32(seed) + 2 *
    GOLDEN)`` as int64: the draws of coalescing and of the open loop.

    Event ``e`` owns the counters ``(e + 1) * (2 * n + 4) + {0 .. 2n + 3}``
    of it (``n`` jobs or slots): ``2i`` and ``2i + 1`` the fresh branch and
    service of job ``i`` woken by a fill, ``2n`` the flow of a miss,
    ``2n + 1`` the next interarrival after an arrival, ``2n + 2`` and
    ``2n + 3`` the interarrival and the phase length drawn by a burst
    toggle.  The open loop's first interarrival and phase use the block of
    "event -1" (counters ``2n + 1`` and ``2n + 3``).  So a draw's counter
    is a pure function of the event and the job, and the three draws of
    the first stream keep their counters.
    """
    return _mix((seeds.long() + 2 * _GOLDEN) & _M32)


def flow_cdf(n_flows: int, theta: float) -> Optional[np.ndarray]:
    """The float32 CDF a miss samples its flow from, or None for uniform
    flows (``theta == 0``): the cumulative sum of
    :func:`~repro_torch.core.queueing.zipf_flow_weights`, as the
    reference's ``_sample_flow``."""
    if theta == 0.0:
        return None
    return np.cumsum(zipf_flow_weights(n_flows, theta)).astype(np.float32)


def flow_index(u: torch.Tensor, n_flows: int,
               cdf: Optional[torch.Tensor]) -> torch.Tensor:
    """The flow a miss fetches, from its uniform ``u``: ``floor(u * F)``
    in float32 for uniform flows, else searchsorted-left over ``cdf``;
    clamped to ``F - 1`` (a float32 CDF may end below the largest
    uniform)."""
    if cdf is None:
        f = (u * n_flows).long()
    else:
        f = (cdf < u.unsqueeze(-1)).sum(dim=-1)
    return f.clamp(max=n_flows - 1)


@torch.inference_mode()
def sim_lanes_plain(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
                    warmup: int, mpl: int, max_events: torch.Tensor,
                    trace_cap: int = 0,
                    bmiss: Optional[torch.Tensor] = None, n_flows: int = 0,
                    flow_theta: float = 0.0, n_disks: int = 1,
                    disk_rank: Optional[torch.Tensor] = None,
                    count_branches: bool = False,
                    tiers: Optional[LaneTiers] = None, sketch_cap: int = 0,
                    window_us: float = 0.0) -> LaneOutputs:
    """The kernel's plain PyTorch version, every lane batched, on the
    inputs' device (``is_queue`` may be bool or int32, as for the kernel).

    With ``trace_cap > 0``, ``bmiss`` is the (L, B) per-branch miss-class
    table and the result carries the filled rings (the reference
    ``_sim_lane`` with ``trace_cap``): on every event job ``j``'s visit
    ``pos[j]`` is stamped left at the new clock; a completing request
    writes its record (``req`` = completions so far, its branch, its
    class, ``nvis = pos[j] + 1``, ``parked_us = 0``, the job's enter and
    leave rows) at row ``req % trace_cap``; then the job's next visit is
    stamped entered.  Lanes that write nothing this event write the scrap
    row ``trace_cap``.

    With ``n_flows = F > 0`` a miss coalesces (the reference ``_simulate``
    with ``n_flows``): ``disk_rank`` is the (L, K) backing-store rank of
    each station, and each lane holds a leader table of ``n_disks * F``
    entries.  When job ``j`` ends service at a disk with a flow, every job
    parked on that flow wakes: it counts as a completion and as a delayed
    hit under the branch it parked on, and starts a fresh request (branch
    and service from the second stream, :func:`lane_base2`); the leader
    entry and the flows are cleared.  Then come the FIFO release and the
    advance.  Arriving at a disk station, ``j`` samples flow ``rank * F +
    f`` (:func:`flow_index`, Zipf(``flow_theta``) when it is > 0) and
    either parks on its in-flight fetch (no server, no queue place) or
    leads it.  The warmup snapshot also takes the delayed count and the
    per-branch counts.  ``n_flows = 0`` runs no coalescing code; with
    ``count_branches`` it still counts each lane's completions per branch
    (and no delayed hits), with the same warmup snapshot.

    With ``tiers`` (and ``n_flows = F > 0``) misses coalesce on the tiered
    tables (the reference ``_simulate_tiered``; ``disk_rank`` unused),
    each lane with a leader table of ``tiers.n_groups * F`` entries, and
    per job its flow (drawn at its first acquire of a request, as a miss
    draws it, and kept to the request's end), its held entry per level
    and the entry it is parked on.  Per event, in this order: the fill —
    completing visit ``(b, i)`` with ``rel_slot[b, i] = s`` frees the
    entry job ``j`` holds at level ``s``; the cascade — in at most
    ``max_held`` waves, every job parked on an entry freed by the last
    wave wakes and its held entries are freed; every freed entry's
    leader is cleared, every woken job completes as a delayed hit (counted
    under the branch it parked on and at the level it parked at) and
    starts a fresh request from the second stream; the FIFO release; the
    advance; the placement — at an acquire position ``j`` parks behind
    the leader of entry ``acq_group * F + flow``, or leads it and holds
    it at level ``acq_slot``; the warmup snapshot, which also takes the
    per-level counts.

    Traced with coalescing (tiered or not; the reference's ``_simulate``
    and ``_simulate_tiered`` with ``trace_cap``), the jobs a fill (or a
    cascade) wakes write their records first, in job order, before the
    wake draws their fresh requests (:func:`_trace_woken`: ``req`` the
    completions so far plus the job's rank among the woken, the branch it
    parked on, class delayed, ``nvis = pos + 1``, ``parked_us`` the time
    since it entered its park visit); each then enters visit 0 now.  Job
    ``j``'s record and stamps follow as in the closed loop, at the
    ``req`` after them.  ``bmiss`` gives the classes of ``j``'s records (a
    tiered network's acquiring branches are miss routes).

    With ``sketch_cap > 0`` the streaming estimators (a
    :class:`~repro_torch.obs.streaming.SketchState` of the L lanes,
    returned on ``sketch``) run at the reference's sites (``_simulate``
    and ``_simulate_tiered``), in its order: every event ticks the ring
    at the new clock (windows of
    ``window_us``); the jobs a fill wakes complete as one batch of delayed
    hits under the branch they parked on; a completing request is a hit
    unless ``bmiss`` ((L, B), needed) marks its branch a miss; and a miss
    arriving at a disk observes its flow ``rank * F + f`` as a key (the
    tiered tables: a request's flow ``f``, at its first acquire).  The
    sketch draws no random numbers, so the outputs are the unsketched
    run's bit for bit.

    The event loop of the reference ``_sim_lane``; a lane stops (its state
    is frozen by the active mask) once it completes ``n_requests`` or
    spends its own budget ``max_events[lane]`` ((L,) int32), and the loop
    ends when every lane has stopped.
    Active lanes share the event index, so the uniforms of event ``e``
    (counters ``2*mpl + 3e + {0, 1, 2}``), the service draw at every
    station and the branch draw are computed ``_CHUNK`` events at a time.
    """
    dev = seeds.device
    n_l = seeds.shape[0]
    n_b, route_len = spec.visits.shape[1], spec.visits.shape[2]
    lane = torch.arange(n_l, device=dev)
    base = lane_base(seeds)[:, None]
    visits = spec.visits.long()
    cum = spec.branch_cum[:, None, :]

    def pick_branch(u: torch.Tensor) -> torch.Tensor:
        # searchsorted-left over the cumulative branch law (may be B);
        # JAX clamps the later visits[B, .] gather, so clamp here
        return (cum < u.unsqueeze(-1)).sum(dim=-1)

    def visit(b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return visits[lane.view(-1, *[1] * (b.dim() - 1)),
                      b.clamp(max=n_b - 1), p]

    idx = torch.arange(mpl, device=dev)[None, :]
    branch = pick_branch(u01(base, idx))
    station = visit(branch, torch.zeros_like(branch))
    ready = _service_table(u01(base, mpl + idx), spec).gather(
        2, station.unsqueeze(-1)).squeeze(-1)
    pos = torch.zeros_like(branch)
    enq = torch.full_like(branch, int(BIG_SEQ))
    busy = torch.zeros(spec.is_queue.shape, dtype=torch.int64, device=dev)
    zeros = torch.zeros(n_l, dtype=torch.int64, device=dev)
    seq_ctr, completed, events = zeros.clone(), zeros.clone(), zeros.clone()
    max_events = max_events.long()
    warm_completed = zeros - 1
    elapsed = torch.zeros(n_l, dtype=torch.float32, device=dev)
    warm_elapsed = elapsed.clone()
    ns_to_us = _f32(_NS_TO_US, elapsed)
    inf, big = int(INF_NS), int(BIG_SEQ)
    is_queue = spec.is_queue.bool()
    servers = spec.servers.long()

    def put(a: torch.Tensor, i: torch.Tensor, v, mask: torch.Tensor) -> None:
        a[lane, i] = torch.where(mask, v, a[lane, i])

    rings = None
    if trace_cap:
        rings = init_rings(n_l, trace_cap, route_len, dev)
        enter_s = torch.zeros((n_l, mpl, route_len), dtype=torch.float32,
                              device=dev)
        leave_s = torch.zeros_like(enter_s)
        miss = bmiss.bool()
    co = None
    if tiers is not None:
        co = _TieredCoalescer(seeds, mpl, n_flows, flow_theta, tiers, n_b)
    elif n_flows:
        co = _Coalescer(seeds, mpl, n_flows, flow_theta, n_disks, disk_rank,
                        n_b)
    elif count_branches:
        co = _BranchCounts(n_l, n_b, dev)
    sketch = sketch_init(sketch_cap, n_b, n_l, device=dev)
    if sketch is not None:
        decay = pow_table(mpl, device=dev)
        hit_b = ~bmiss.bool()
        if co is not None:
            co.sketch = sketch

    e = 0
    while True:
        if e % _CHUNK == 0:
            active = (completed < n_requests) & (events < max_events)
            if not bool(active.any()):
                break
            ctr = 2 * mpl + 3 * (e + torch.arange(_CHUNK, device=dev))[None, :]
            svc1 = _service_table(u01(base, ctr), spec)
            svc2 = _service_table(u01(base, ctr + 1), spec)
            new_branches = pick_branch(u01(base, ctr + 2))
            if n_flows:
                co.draw_flows(e)
        c = e % _CHUNK
        e += 1
        active = (completed < n_requests) & (events < max_events)

        j = ready.argmin(dim=1)  # first index on ties, as jnp.argmin
        t = ready[lane, j]
        ready = torch.where(active[:, None] & (ready < inf),
                            ready - t[:, None], ready)
        elapsed = torch.where(active, fma_f32(t.to(torch.float32), ns_to_us,
                                              elapsed), elapsed)
        if sketch is not None:
            slot = stream_tick(sketch, elapsed, window_us, active)
        k_cur = station[lane, j]

        if tiers is not None:
            # j's visit may land a fill: the cascade's jobs complete as
            # delayed hits and start fresh requests
            woken = co.cascade(active, j, branch, pos)
            if woken is not None:
                co.count(woken, branch)
                if sketch is not None:
                    stream_done_many(sketch, slot, branch, woken, decay)
                co.count_levels(woken)
                if trace_cap:
                    _trace_woken(rings, enter_s, leave_s, woken, branch, pos,
                                 elapsed, completed, trace_cap, restart=True)
                wb, wst, wsvc = co.wake_draws(e - 1, pick_branch, visit, spec)
                ready = torch.where(woken, wsvc, ready)
                station = torch.where(woken, wst, station)
                branch = torch.where(woken, wb, branch)
                pos = torch.where(woken, 0, pos)
                completed = completed + woken.sum(dim=1)
                co.release(woken)
        elif n_flows:
            # j's fetch landed: the jobs parked on it complete as delayed
            # hits and start fresh requests
            woken, fill, f_cur = co.fill(active, j, k_cur)
            if bool(woken.any()):
                co.count(woken, branch)
                if sketch is not None:
                    stream_done_many(sketch, slot, branch, woken, decay)
                if trace_cap:
                    _trace_woken(rings, enter_s, leave_s, woken, branch, pos,
                                 elapsed, completed, trace_cap, restart=True)
                wb, wst, wsvc = co.wake_draws(e - 1, pick_branch, visit, spec)
                ready = torch.where(woken, wsvc, ready)
                station = torch.where(woken, wst, station)
                branch = torch.where(woken, wb, branch)
                pos = torch.where(woken, 0, pos)
                completed = completed + woken.sum(dim=1)
            co.clear(woken, fill, f_cur, j)

        # hand the server job j held (if any) to its FIFO successor
        waiting = (station == k_cur[:, None]) & (ready == inf)
        waiting[lane, j] = False
        seqs = torch.where(waiting, enq, big)
        w = seqs.argmin(dim=1)
        has_waiter = seqs[lane, w] < big
        release = active & is_queue[lane, k_cur]
        put(ready, w, svc1[lane, c, k_cur], release & has_waiter)
        put(enq, w, big, release & has_waiter)
        put(busy, k_cur, busy[lane, k_cur] - 1, release & ~has_waiter)

        # advance job j along its route (or complete and restart)
        nxt = pos[lane, j] + 1
        b_j = branch[lane, j]
        route_next = torch.where(nxt < route_len,
                                 visit(b_j, nxt % route_len), -1)
        done = route_next < 0
        new_branch = new_branches[:, c]
        k_next = torch.where(done, visit(new_branch, zeros), route_next)
        if trace_cap:
            _trace_event(rings, enter_s, leave_s, lane, j, pos[lane, j],
                         torch.where(done, 0, nxt), b_j, miss, elapsed,
                         completed, active, active & done, trace_cap)
        if sketch is not None:
            stream_done(sketch, slot, b_j, hit_b[lane, b_j.clamp(max=n_b - 1)],
                        False, active & done)
        completed = torch.where(active, completed + done.long(), completed)

        # place j at k_next: it starts, waits, or (coalescing) parks
        is_q = is_queue[lane, k_next]
        has_slot = busy[lane, k_next] < servers[lane, k_next]
        starts_now = ~is_q | has_slot
        waits = ~starts_now
        if co is not None:
            co.count_done(active & done, b_j)
        if tiers is not None:
            parks = co.place(active, j, torch.where(done, new_branch, b_j),
                             torch.where(done, 0, nxt), done, c)
            starts_now = starts_now & ~parks
            waits = waits & ~parks
        elif n_flows:
            parks = co.place(active, j, k_next, c)
            starts_now = starts_now & ~parks
            waits = waits & ~parks
        put(ready, j, torch.where(starts_now, svc2[lane, c, k_next], inf),
            active)
        put(enq, j, torch.where(waits, seq_ctr, big), active)
        seq_ctr = torch.where(active & waits, seq_ctr + 1, seq_ctr)
        put(busy, k_next, busy[lane, k_next] + 1, active & is_q & starts_now)
        put(station, j, k_next, active)
        put(branch, j, torch.where(done, new_branch, b_j), active)
        put(pos, j, torch.where(done, 0, nxt), active)

        # warmup bookkeeping
        warm_now = active & (completed >= warmup) & (warm_completed < 0)
        warm_completed = torch.where(warm_now, completed, warm_completed)
        warm_elapsed = torch.where(warm_now, elapsed, warm_elapsed)
        if co is not None:
            co.snapshot(warm_now)
        events = torch.where(active, events + 1, events)

    t_meas = torch.clamp(elapsed - warm_elapsed, min=_f32(_T_MIN, elapsed))
    x = (completed - warm_completed).to(torch.float32) / t_meas
    out = LaneOutputs(x, completed.to(torch.int32), events.to(torch.int32),
                      t_meas, rings, sketch=sketch)
    if co is not None:
        out = out._replace(**co.results(completed - warm_completed))
    return out


class _BranchCounts:
    """Per-branch measured completions and delayed hits of every lane,
    the delayed count, and their warmup snapshots (the closed loop's
    ``count_branches``; the base of :class:`_Coalescer`)."""

    def __init__(self, n_l: int, n_b: int, dev: torch.device):
        self.lane = torch.arange(n_l, device=dev)
        self.n_b = n_b
        self.delayed = torch.zeros(n_l, dtype=torch.int64, device=dev)
        self.done_b = torch.zeros((n_l, n_b), dtype=torch.int64, device=dev)
        self.delayed_b = torch.zeros_like(self.done_b)
        self.warm = [torch.zeros_like(self.delayed), self.done_b.clone(),
                     self.delayed_b.clone()]

    def count_done(self, done, b_j) -> None:
        keep = done & (b_j < self.n_b)
        self.done_b[self.lane, b_j.clamp(max=self.n_b - 1)] += keep.long()

    def snapshot(self, warm_now) -> None:
        for w, v in zip(self.warm, (self.delayed, self.done_b,
                                    self.delayed_b)):
            m = warm_now.view(-1, *[1] * (v.dim() - 1))
            w.copy_(torch.where(m, v, w))

    def results(self, n_measured: torch.Tensor) -> dict:
        frac = ((self.delayed - self.warm[0]).to(torch.float32)
                / n_measured.clamp(min=1).to(torch.float32))
        return dict(delayed_frac=frac,
                    branch_done=(self.done_b - self.warm[1]).to(torch.int32),
                    branch_delayed=(self.delayed_b
                                    - self.warm[2]).to(torch.int32))


class _Coalescer(_BranchCounts):
    """The MSHR state of :func:`sim_lanes_plain` with ``n_flows > 0`` (and
    of :func:`sim_open_lanes_plain`), every lane batched: each job's flow
    (-1: none), the leader table, and the counts of
    :class:`_BranchCounts`."""

    def __init__(self, seeds: torch.Tensor, n_jobs: int, n_flows: int,
                 flow_theta: float, n_disks: int, disk_rank: torch.Tensor,
                 n_b: int):
        dev = seeds.device
        n_l = seeds.shape[0]
        super().__init__(n_l, n_b, dev)
        self.base2 = lane_base2(seeds)[:, None]
        self.n, self.n_flows = n_jobs, n_flows
        cdf = flow_cdf(n_flows, flow_theta)
        self.cdf = None if cdf is None else torch.from_numpy(cdf).to(dev)
        self.rank = None if disk_rank is None else disk_rank.long()
        self.flow = torch.full((n_l, n_jobs), -1, dtype=torch.int64,
                               device=dev)
        self.leader = torch.full((n_l, max(n_disks, 1) * n_flows), -1,
                                 dtype=torch.int64, device=dev)
        self.sketch: Optional[SketchState] = None  # observes the flows

    def block(self, e) -> int:
        """First counter of event ``e``'s block of the second stream."""
        return (e + 1) * (2 * self.n + 4)

    def draw_flows(self, e0: int) -> None:
        """The flow uniforms of events ``e0 .. e0 + _CHUNK - 1``."""
        ev = e0 + torch.arange(_CHUNK, device=self.flow.device)[None, :]
        self.flows_u = u01(self.base2, self.block(ev) + 2 * self.n)

    def fill(self, active, j, k_cur):
        """The jobs woken by ``j``'s fill, the lanes that fill and their
        flow."""
        lane = self.lane
        f_cur = self.flow[lane, j]
        fill = active & (self.rank[lane, k_cur] >= 0) & (f_cur >= 0)
        woken = (self.flow == f_cur[:, None]) & fill[:, None]
        woken[lane, j] = False
        return woken, fill, f_cur

    def count(self, woken, branch) -> None:
        """The woken jobs complete as delayed hits, counted under the
        branch they parked on (a branch index past the table is dropped,
        as JAX drops an out-of-bounds scatter)."""
        n_w = woken.sum(dim=1)
        self.delayed += n_w
        keep = (woken & (branch < self.n_b)).long()
        b = branch.clamp(max=self.n_b - 1)
        self.done_b.scatter_add_(1, b, keep)
        self.delayed_b.scatter_add_(1, b, keep)

    def wake_draws(self, e: int, pick_branch, visit, spec):
        """Every job's fresh branch, first station and service for event
        ``e`` (used where it wakes)."""
        i = torch.arange(self.n, device=self.flow.device)[None, :]
        c0 = self.block(e)
        wb = pick_branch(u01(self.base2, c0 + 2 * i))
        wst = visit(wb, torch.zeros_like(wb))
        wsvc = _service_at(u01(self.base2, c0 + 2 * i + 1), spec, wst)
        return wb, wst, wsvc

    def clear(self, woken, fill, f_cur, j) -> None:
        """Free the filled flow's leader entry and the flows of its jobs."""
        lane = self.lane
        f = f_cur.clamp(min=0)
        self.leader[lane, f] = torch.where(fill, -1, self.leader[lane, f])
        self.flow[woken] = -1
        self.flow[lane, j] = torch.where(fill, -1, self.flow[lane, j])

    def place(self, active, j, k_next, c: int, at: Optional[torch.Tensor] = None):
        """Job ``j`` arrives at ``k_next`` (lanes ``at``, default every
        lane): at a disk it samples a flow and parks behind that flow's
        leader or leads it.  Returns the lanes where ``j`` parks."""
        lane = self.lane
        rank = self.rank[lane, k_next]
        at_disk = active & (rank >= 0)
        if at is not None:
            at_disk = at_disk & at
        f_new = (rank.clamp(min=0) * self.n_flows
                 + flow_index(self.flows_u[:, c], self.n_flows, self.cdf))
        if self.sketch is not None:
            stream_key(self.sketch, f_new, at_disk)
        parks = at_disk & (self.leader[lane, f_new] >= 0)
        lead = at_disk & ~parks
        self.leader[lane, f_new] = torch.where(lead, j, self.leader[lane, f_new])
        self.flow[lane, j] = torch.where(at_disk, f_new, self.flow[lane, j])
        return parks


class _TieredCoalescer(_Coalescer):
    """The tiered MSHR state of :func:`sim_lanes_plain` with ``tiers``,
    every lane batched: each job's flow, held entries (one per level) and
    the entry and level it is parked on (-1: none), the leader table of
    ``n_groups * F`` entries, the counts of :class:`_BranchCounts` and the
    delayed hits per level."""

    def __init__(self, seeds: torch.Tensor, n_jobs: int, n_flows: int,
                 flow_theta: float, tiers: LaneTiers, n_b: int):
        super().__init__(seeds, n_jobs, n_flows, flow_theta, tiers.n_groups,
                         None, n_b)
        dev, n_l = seeds.device, seeds.shape[0]
        self.acq_g, self.acq_s, self.rel_s = (
            t.long() for t in (tiers.acq_group, tiers.acq_slot,
                               tiers.rel_slot))
        self.max_held = tiers.max_held
        self.held = torch.full((n_l, n_jobs, tiers.max_held), -1,
                               dtype=torch.int64, device=dev)
        self.parked_on = torch.full((n_l, n_jobs), -1, dtype=torch.int64,
                                    device=dev)
        self.parked_lvl = self.parked_on.clone()
        self.dlvl = torch.zeros((n_l, tiers.max_held), dtype=torch.int64,
                                device=dev)
        self.warm_dlvl = self.dlvl.clone()

    def cascade(self, active, j, branch, pos) -> Optional[torch.Tensor]:
        """Job ``j`` completes its visit: the fill it releases, if any,
        frees its held entry, and the cascade's waves wake the jobs parked
        on freed entries (returned, (L, N) bool; None when no lane fills),
        whose held entries free in turn; the freed entries' leaders are
        cleared."""
        lane, n_gf = self.lane, self.leader.shape[1]
        b = branch[lane, j].clamp(max=self.n_b - 1)
        rel = self.rel_s[lane, b, pos[lane, j]]
        at = rel.clamp(min=0)
        entry = self.held[lane, j, at]
        self.held[lane, j, at] = torch.where(active & (rel >= 0), -1, entry)
        fills = active & (rel >= 0) & (entry >= 0)
        if not bool(fills.any()):
            return None
        freed = torch.zeros((lane.shape[0], n_gf + 1), dtype=torch.bool,
                            device=lane.device)
        freed[lane, torch.where(fills, entry, n_gf)] = True
        freed[:, n_gf] = False
        freed_all = freed.clone()
        woken = torch.zeros_like(self.parked_on, dtype=torch.bool)
        for _ in range(self.max_held):
            wave = ((self.parked_on >= 0) & ~woken
                    & freed.gather(1, self.parked_on.clamp(min=0)))
            freed = torch.zeros_like(freed)
            held = torch.where(wave[..., None] & (self.held >= 0), self.held,
                               n_gf)
            freed.scatter_(1, held.flatten(1), True)
            freed[:, n_gf] = False
            woken |= wave
            freed_all |= freed
        self.leader = torch.where(freed_all[:, :n_gf], -1, self.leader)
        return woken

    def count_levels(self, woken) -> None:
        """The woken jobs' delayed hits at the level each parked at."""
        self.dlvl.scatter_add_(1, self.parked_lvl.clamp(min=0), woken.long())

    def release(self, woken) -> None:
        """The woken jobs hold nothing, park nowhere and have no flow."""
        self.held[woken] = -1
        self.parked_on[woken] = -1
        self.parked_lvl[woken] = -1
        self.flow[woken] = -1

    def place(self, active, j, branch_j, pos_j, done, c: int):
        """Job ``j`` arrives at position ``pos_j`` of branch ``branch_j``:
        at an acquire it takes its request's flow (drawn now if it has
        none) and parks behind that entry's leader or leads it.  Returns
        the lanes where ``j`` parks."""
        lane, n_f = self.lane, self.n_flows
        b = branch_j.clamp(max=self.n_b - 1)
        g = self.acq_g[lane, b, pos_j]
        lvl = self.acq_s[lane, b, pos_j]
        at = active & (g >= 0)
        f_own = self.flow[lane, j]
        f_req = torch.where(f_own >= 0, f_own,
                            flow_index(self.flows_u[:, c], n_f, self.cdf))
        if self.sketch is not None:
            # a request's flow is observed once, at its first acquire
            stream_key(self.sketch, f_req, at & (f_own < 0))
        slot = g.clamp(min=0) * n_f + f_req
        parks = at & (self.leader[lane, slot] >= 0)
        leads = at & ~parks
        self.leader[lane, slot] = torch.where(leads, j, self.leader[lane, slot])
        lc = lvl.clamp(min=0)
        self.held[lane, j, lc] = torch.where(leads, slot,
                                             self.held[lane, j, lc])
        self.flow[lane, j] = torch.where(
            active, torch.where(at, f_req, torch.where(done, -1, f_own)),
            f_own)
        self.parked_on[lane, j] = torch.where(
            active, torch.where(parks, slot, -1), self.parked_on[lane, j])
        self.parked_lvl[lane, j] = torch.where(
            active, torch.where(parks, lvl, -1), self.parked_lvl[lane, j])
        return parks

    def snapshot(self, warm_now) -> None:
        super().snapshot(warm_now)
        self.warm_dlvl.copy_(torch.where(warm_now[:, None], self.dlvl,
                                         self.warm_dlvl))

    def results(self, n_measured: torch.Tensor) -> dict:
        out = super().results(n_measured)
        out["delayed_tier"] = ((self.dlvl - self.warm_dlvl).to(torch.float32)
                               / n_measured.clamp(min=1).to(torch.float32)
                               [:, None])
        return out


class OpenLaneOutputs(NamedTuple):
    x: torch.Tensor             # (L,) f32 completion rate, requests/µs
    completed: torch.Tensor     # (L,) i32
    events: torch.Tensor        # (L,) i32
    t_measured: torch.Tensor    # (L,) f32 µs
    delayed_frac: torch.Tensor  # (L,) f32
    dropped: torch.Tensor       # (L,) i32 arrivals that found no free slot
    sojourn_us: torch.Tensor    # (L, n_requests + N) f32, by completion
    cls: torch.Tensor           # (L, n_requests + N) i8 CLS_MISS/HIT/DELAYED
    sketch: Optional[SketchState] = None  # filled when sketch_cap > 0
    rings: Optional[TraceRings] = None  # filled when trace_cap > 0


def exp_ns(u: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """An exponential time in ns (int64, >= 1) of float32 ``mean`` from
    uniforms ``u``: ``round(-log(u) * mean)`` in float32, as the
    reference's ``exp_ns``."""
    return torch.clamp(torch.round(-torch.log(u) * mean), min=1.0).long()


@torch.inference_mode()
def sim_open_lanes_plain(spec: _LaneSpec, seeds: torch.Tensor, *,
                         n_requests: int, warmup: int, n_slots: int,
                         max_events: torch.Tensor, ia_mean: torch.Tensor,
                         bmiss: torch.Tensor, burst=None, n_flows: int = 0,
                         flow_theta: float = 0.0, n_disks: int = 1,
                         disk_rank: Optional[torch.Tensor] = None,
                         sketch_cap: int = 0, window_us: float = 0.0,
                         trace_cap: int = 0) -> OpenLaneOutputs:
    """The open-loop kernel's plain PyTorch version, every lane batched
    (the reference ``_simulate_open`` on the counter streams).

    Requests arrive with exponential interarrival times of mean
    ``ia_mean`` ((L,) float32 ns) into a pool of ``n_slots`` job slots;
    an arrival takes the lowest free slot (else it is counted as
    dropped), walks its branch's route and *leaves* when it completes,
    writing its sojourn (time in system, summed per event as float32
    increments) and class (:data:`CLS_MISS`, :data:`CLS_HIT`, or
    :data:`CLS_DELAYED` for a job parked on an in-flight fetch, which
    completes at the fill) at its completion index in a record buffer of
    ``n_requests + n_slots`` rows.  ``bmiss`` is the (L, B) per-branch
    miss class.  ``burst = (on_mean, off_mean)`` (float32 ns) makes the
    arrivals an ON-OFF process: the phase toggle is a third event type,
    arrivals pause while OFF and restart with a fresh interarrival when ON
    (``ia_mean`` is then the ON rate's mean).  Arrivals win ties against
    departures and toggles, toggles against departures, and the lowest
    index wins among equal ready times.  ``n_flows > 0`` coalesces misses
    as :func:`sim_lanes_plain` does.

    Draws: an arrival takes its branch and first service from the first
    stream's branch and placement draws (counters ``2n + 3e + {2, 1}``),
    a departure its release and placement draws (``+ {0, 1}``); the
    interarrival and toggle draws are the second stream's
    (:func:`lane_base2`).

    ``sketch_cap > 0`` runs the streaming estimators as
    :func:`sim_lanes_plain` does, at the sites of the reference's
    ``_simulate_open``: every event ticks, every offered arrival (dropped
    ones too) is counted, and a departure's fill, completion and disk
    arrival feed the sketch.

    ``trace_cap > 0`` fills the lanes' trace rings (returned on ``rings``)
    at the reference's sites: an admitted arrival enters visit 0 of its
    slot now (a dropped one writes nothing); the jobs a fill wakes write
    their records first, in slot order, at the completion indices their
    sojourns take (:func:`_trace_woken`, without a fresh request); then
    the departing job leaves its visit, writes its record if it completes
    (req = its completion index) and otherwise enters its next visit.
    Tracing draws no random numbers.
    """
    dev = seeds.device
    n_l, n = seeds.shape[0], n_slots
    n_b, route_len = spec.visits.shape[1], spec.visits.shape[2]
    lane = torch.arange(n_l, device=dev)
    base, base2 = lane_base(seeds)[:, None], lane_base2(seeds)
    visits = spec.visits.long()
    cum = spec.branch_cum[:, None, :]
    inf, big = int(INF_NS), int(BIG_SEQ)
    n_rec = n_requests + n

    def pick_branch(u: torch.Tensor) -> torch.Tensor:
        return (cum < u.unsqueeze(-1)).sum(dim=-1)

    def visit(b: torch.Tensor, p) -> torch.Tensor:
        return visits[lane, b.clamp(max=n_b - 1), p]

    def put(a: torch.Tensor, i: torch.Tensor, v, mask: torch.Tensor) -> None:
        a[lane, i] = torch.where(mask, v, a[lane, i])

    def block(e: int) -> int:  # first counter of event e's second-stream block
        return (e + 1) * (2 * n + 4)

    ready = torch.full((n_l, n), inf, dtype=torch.int64, device=dev)
    station = torch.full_like(ready, -1)
    branch = torch.zeros_like(ready)
    pos = torch.zeros_like(ready)
    enq = torch.full_like(ready, big)
    age = torch.zeros((n_l, n), dtype=torch.float32, device=dev)
    busy = torch.zeros(spec.is_queue.shape, dtype=torch.int64, device=dev)
    zeros = torch.zeros(n_l, dtype=torch.int64, device=dev)
    seq_ctr, completed, events = zeros.clone(), zeros.clone(), zeros.clone()
    dropped = zeros.clone()
    warm_completed = zeros - 1
    elapsed = torch.zeros(n_l, dtype=torch.float32, device=dev)
    warm_elapsed = elapsed.clone()
    soj = torch.zeros((n_l, n_rec + 1), dtype=torch.float32, device=dev)
    cls = torch.zeros((n_l, n_rec + 1), dtype=torch.int8, device=dev)
    ns_to_us = _f32(_NS_TO_US, elapsed)
    is_queue = spec.is_queue.bool()
    servers = spec.servers.long()
    miss = bmiss.bool()
    max_events = max_events.long()
    ia_mean = ia_mean.to(torch.float32)
    next_arr = exp_ns(u01(base2, 2 * n + 1), ia_mean)
    if burst is not None:
        on_mean, off_mean = (torch.tensor(np.float32(v), device=dev)
                             for v in burst)
        phase_on = torch.ones(n_l, dtype=torch.bool, device=dev)
        phase_to = exp_ns(u01(base2, 2 * n + 3), on_mean).expand(n_l).clone()
    sketch = sketch_init(sketch_cap, n_b, n_l, device=dev)
    if n_flows:
        co = _Coalescer(seeds, n, n_flows, flow_theta, n_disks, disk_rank,
                        n_b)
        co.sketch = sketch
    if sketch is not None:
        decay = pow_table(n, device=dev)
    rings = None
    if trace_cap:
        rings = init_rings(n_l, trace_cap, route_len, dev)
        enter_s = torch.zeros((n_l, n, route_len), dtype=torch.float32,
                              device=dev)
        leave_s = torch.zeros_like(enter_s)

    def record(at: torch.Tensor, value, c) -> None:
        # at: (L,) or (L, n) record index, n_rec = the scrap column
        col = at.clamp(max=n_rec)
        soj.scatter_(1, col.view(n_l, -1), value.view(n_l, -1))
        cls.scatter_(1, col.view(n_l, -1), c.to(torch.int8).view(n_l, -1))

    e = 0
    while True:
        if e % _CHUNK == 0:
            active = (completed < n_requests) & (events < max_events)
            if not bool(active.any()):
                break
            ev = e + torch.arange(_CHUNK, device=dev)[None, :]
            ctr = 2 * n + 3 * ev
            svc1 = _service_table(u01(base, ctr), spec)
            svc2 = _service_table(u01(base, ctr + 1), spec)
            new_branches = pick_branch(u01(base, ctr + 2))
            u_ia = u01(base2[:, None], block(ev) + 2 * n + 1)
            if burst is not None:
                u_toga = u01(base2[:, None], block(ev) + 2 * n + 2)
                u_togp = u01(base2[:, None], block(ev) + 2 * n + 3)
            if n_flows:
                co.draw_flows(e)
        c = e % _CHUNK
        e += 1
        active = (completed < n_requests) & (events < max_events)

        j = ready.argmin(dim=1)
        t_dep = ready[lane, j]
        if burst is not None:
            is_arr = next_arr <= torch.minimum(t_dep, phase_to)
            is_tog = ~is_arr & (phase_to <= t_dep)
            t = torch.minimum(torch.minimum(next_arr, t_dep), phase_to)
        else:
            is_arr = next_arr <= t_dep
            is_tog = torch.zeros_like(is_arr)
            t = torch.minimum(next_arr, t_dep)
        arr, tog = active & is_arr, active & is_tog
        dep = active & ~is_arr & ~is_tog
        ready = torch.where(active[:, None] & (ready < inf),
                            ready - t[:, None], ready)
        next_arr = torch.where(active & (next_arr < inf), next_arr - t,
                               next_arr)
        if burst is not None:
            phase_to = torch.where(active, phase_to - t, phase_to)
        dt = t.to(torch.float32) * ns_to_us
        elapsed = torch.where(active, elapsed + dt, elapsed)
        if sketch is not None:
            w_slot = stream_tick(sketch, elapsed, window_us, active)
            stream_arrival(sketch, w_slot, arr)
        age = torch.where(active[:, None] & (station >= 0),
                          age + dt[:, None], age)

        # an arrival takes the lowest free slot, or is dropped
        free = station < 0
        admit = arr & free.any(dim=1)
        slot = free.long().argmax(dim=1)
        b0 = new_branches[:, c]
        st0 = visit(b0, 0)
        put(ready, slot, svc2[lane, c, st0], admit)
        put(station, slot, st0, admit)
        put(branch, slot, b0, admit)
        put(pos, slot, 0, admit)
        put(age, slot, 0.0, admit)
        if trace_cap:
            enter_s[lane, slot, 0] = torch.where(admit, elapsed,
                                                 enter_s[lane, slot, 0])
        dropped = dropped + (arr & ~admit).long()
        next_arr = torch.where(arr, exp_ns(u_ia[:, c], ia_mean), next_arr)

        if burst is not None:
            # ON -> OFF: arrivals pause; OFF -> ON: a fresh arrival clock
            going_on = ~phase_on
            phase_on = torch.where(tog, going_on, phase_on)
            next_arr = torch.where(
                tog, torch.where(going_on, exp_ns(u_toga[:, c], ia_mean), inf),
                next_arr)
            phase_to = torch.where(
                tog, exp_ns(u_togp[:, c], torch.where(going_on, on_mean,
                                                      off_mean)), phase_to)

        # a departure: job j ends its visit
        k_cur = station[lane, j].clamp(min=0)
        if n_flows:
            # parked delayed hits complete at the fill, in slot order
            woken, fill, f_cur = co.fill(dep, j, k_cur)
            if bool(woken.any()):
                if sketch is not None:
                    stream_done_many(sketch, w_slot, branch, woken, decay)
                widx = completed[:, None] + woken.long().cumsum(dim=1) - 1
                record(torch.where(woken, widx, n_rec), age,
                       torch.full_like(widx, CLS_DELAYED))
                if trace_cap:
                    _trace_woken(rings, enter_s, leave_s, woken, branch, pos,
                                 elapsed, completed, trace_cap,
                                 restart=False)
                completed = completed + woken.sum(dim=1)
                co.delayed += woken.sum(dim=1)
                ready = torch.where(woken, inf, ready)
                station = torch.where(woken, -1, station)
            co.clear(woken, fill, f_cur, j)

        waiting = (station == k_cur[:, None]) & (ready == inf)
        waiting[lane, j] = False
        seqs = torch.where(waiting, enq, big)
        w = seqs.argmin(dim=1)
        has_waiter = seqs[lane, w] < big
        release = dep & is_queue[lane, k_cur]
        put(ready, w, svc1[lane, c, k_cur], release & has_waiter)
        put(enq, w, big, release & has_waiter)
        put(busy, k_cur, busy[lane, k_cur] - 1, release & ~has_waiter)

        nxt = pos[lane, j] + 1
        b_j = branch[lane, j]
        route_next = torch.where(nxt < route_len,
                                 visit(b_j, nxt % route_len), -1)
        done = dep & (route_next < 0)
        j_miss = miss[lane, b_j.clamp(max=n_b - 1)]
        record(torch.where(done, completed, n_rec), age[lane, j],
               torch.where(j_miss, CLS_MISS, CLS_HIT))
        if sketch is not None:
            stream_done(sketch, w_slot, b_j, ~j_miss, False, done)
        if trace_cap:
            _trace_event(rings, enter_s, leave_s, lane, j, pos[lane, j],
                         nxt.clamp(max=route_len - 1), b_j, miss, elapsed,
                         completed, dep, done, trace_cap,
                         enters=dep & ~done)
        completed = completed + done.long()

        k_next = route_next.clamp(min=0)
        is_q = is_queue[lane, k_next] & ~done
        has_slot = busy[lane, k_next] < servers[lane, k_next]
        starts_now = (~is_q | has_slot) & ~done
        waits = is_q & ~has_slot
        if n_flows:
            parks = co.place(dep, j, k_next, c, at=~done)
            starts_now = starts_now & ~parks
            waits = waits & ~parks
        put(ready, j, torch.where(starts_now, svc2[lane, c, k_next], inf), dep)
        put(enq, j, torch.where(waits, seq_ctr, big), dep)
        seq_ctr = torch.where(dep & waits, seq_ctr + 1, seq_ctr)
        put(busy, k_next, busy[lane, k_next] + 1, dep & is_q & starts_now)
        put(station, j, torch.where(done, -1, route_next), dep)
        put(pos, j, torch.where(done, 0, nxt), dep)

        warm_now = dep & (completed >= warmup) & (warm_completed < 0)
        warm_completed = torch.where(warm_now, completed, warm_completed)
        warm_elapsed = torch.where(warm_now, elapsed, warm_elapsed)
        if n_flows:
            co.snapshot(warm_now)
        events = torch.where(active, events + 1, events)

    t_meas = torch.clamp(elapsed - warm_elapsed, min=_f32(_T_MIN, elapsed))
    n_meas = completed - warm_completed
    x = n_meas.to(torch.float32) / t_meas
    frac = (co.results(n_meas)["delayed_frac"] if n_flows
            else torch.zeros(n_l, dtype=torch.float32, device=dev))
    return OpenLaneOutputs(x, completed.to(torch.int32),
                           events.to(torch.int32), t_meas, frac,
                           dropped.to(torch.int32), soj[:, :n_rec],
                           cls[:, :n_rec], sketch, rings)


def _trace_woken(rings: TraceRings, enter_s: torch.Tensor,
                 leave_s: torch.Tensor, woken: torch.Tensor,
                 branch: torch.Tensor, pos: torch.Tensor,
                 elapsed: torch.Tensor, completed: torch.Tensor, cap: int,
                 restart: bool) -> None:
    """The records of the jobs a fill wakes, in place, every lane at once
    (the reference's ``ring_write_many``): in job order, woken job ``i``
    leaves its park visit ``pos[i]`` now and completes as request
    ``completed + rank`` (its rank among the woken), a delayed hit under
    the branch it parked on, parked since it entered that visit; with
    ``restart`` its fresh request then enters visit 0 now.  Of woken jobs
    that land on one row (more woken than ``cap``) only the last writes;
    every other write goes to the scrap row ``cap``."""
    n_w = woken.sum(dim=1, keepdim=True)
    rank = woken.long().cumsum(dim=1) - 1
    req = completed[:, None] + rank
    row = torch.where(woken & (rank >= n_w - cap), req % cap, cap)
    lane = torch.arange(woken.shape[0], device=woken.device)[:, None]
    now = elapsed[:, None]
    at = pos.unsqueeze(-1)
    leave_s.scatter_(2, at, torch.where(
        woken, now, leave_s.gather(2, at).squeeze(-1)).unsqueeze(-1))
    rings.req[lane, row] = req.to(torch.int32)
    rings.branch[lane, row] = branch.to(torch.int32)
    rings.cls[lane, row] = CLS_DELAYED
    rings.nvis[lane, row] = (pos + 1).to(torch.int32)
    rings.parked_us[lane, row] = now - enter_s.gather(2, at).squeeze(-1)
    rings.enter_us[lane, row] = enter_s
    rings.leave_us[lane, row] = leave_s
    rings.n_count.add_(n_w.squeeze(1).to(torch.int32))
    if restart:
        enter_s[..., 0] = torch.where(woken, now, enter_s[..., 0])


def _trace_event(rings: TraceRings, enter_s: torch.Tensor,
                 leave_s: torch.Tensor, lane: torch.Tensor, j: torch.Tensor,
                 pos_j: torch.Tensor, pos_next: torch.Tensor,
                 b_j: torch.Tensor, miss: torch.Tensor, elapsed: torch.Tensor,
                 completed: torch.Tensor, active: torch.Tensor,
                 write: torch.Tensor, cap: int,
                 enters: Optional[torch.Tensor] = None) -> None:
    """One event's trace updates, in place, every lane at once: stamp job
    ``j`` leaving visit ``pos_j``, write the record of a completing request
    (scrap row ``cap`` otherwise), stamp ``j`` entering ``pos_next`` (on
    the lanes ``enters``, default ``active``)."""
    leave_s[lane, j, pos_j] = torch.where(active, elapsed,
                                          leave_s[lane, j, pos_j])
    row = torch.where(write, completed % cap, cap)
    n_b = miss.shape[1]
    cls = torch.where(miss[lane, b_j.clamp(max=n_b - 1)], CLS_MISS, CLS_HIT)
    rings.req[lane, row] = completed.to(torch.int32)
    rings.branch[lane, row] = b_j.to(torch.int32)
    rings.cls[lane, row] = cls.to(torch.int32)
    rings.nvis[lane, row] = (pos_j + 1).to(torch.int32)
    rings.parked_us[lane, row] = 0.0
    rings.enter_us[lane, row] = enter_s[lane, j]
    rings.leave_us[lane, row] = leave_s[lane, j]
    rings.n_count.add_(write.to(torch.int32))
    enters = active if enters is None else enters
    enter_s[lane, j, pos_next] = torch.where(enters, elapsed,
                                             enter_s[lane, j, pos_next])


class _ExtArgs(ctypes.Structure):
    """``ExtArgs`` of ``csrc/event_sim.cuh``: every launch's inputs and
    outputs (device pointers, then sizes)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "isq", "svc", "did", "dpar", "bcum", "visits", "servers", "seeds",
        "max_events", "disk_rank", "flow_cum", "bmiss", "ia_mean", "x",
        "completed", "events", "tmeas", "delayed_frac", "branch_done",
        "branch_delayed", "dropped", "soj", "cls", "acq_group", "acq_slot",
        "rel_slot", "delayed_tier")]
        + [(n, ctypes.c_int) for n in (
            "lanes", "n_k", "n_b", "n_l", "mpl", "n_requests", "warmup",
            "n_flows", "n_lead", "open", "burst", "rec_len", "tiers",
            "max_held")]
        + [("on_mean", ctypes.c_float), ("off_mean", ctypes.c_float)]
        + [("closed", ctypes.c_int), ("cap", ctypes.c_int)]
        + [(n, ctypes.c_void_p) for n in (
            "n_count", "req", "rbranch", "rcls", "nvis", "parked", "enter",
            "leave")])

# the tiered kernel's limits: held levels per job (registers), and leader
# groups and levels in its int8 tables
MAX_HELD = 2
MAX_GROUPS = 127


def _check_inputs(spec: _LaneSpec, seeds: torch.Tensor, extra: dict) -> None:
    """Shapes, dtypes and devices of a launch's per-lane inputs."""
    n_l = seeds.shape[0]
    n_k = spec.is_queue.shape[1]
    n_b, n_r = spec.visits.shape[1], spec.visits.shape[2]
    want = {"is_queue": ((n_l, n_k), (torch.bool, torch.int32)),
            "svc_ns": ((n_l, n_k), (torch.float32,)),
            "dist_id": ((n_l, n_k), (torch.int32,)),
            "dist_params": ((n_l, n_k, 4), (torch.float32,)),
            "branch_cum": ((n_l, n_b), (torch.float32,)),
            "visits": ((n_l, n_b, n_r), (torch.int32,)),
            "servers": ((n_l, n_k), (torch.int32,)),
            "max_events": ((n_l,), (torch.int32,)),
            "bmiss": ((n_l, n_b), (torch.bool, torch.int32)),
            "disk_rank": ((n_l, n_k), (torch.int32,)),
            "ia_mean": ((n_l,), (torch.float32,)),
            "acq_group": ((n_l, n_b, n_r), (torch.int32,)),
            "acq_slot": ((n_l, n_b, n_r), (torch.int32,)),
            "rel_slot": ((n_l, n_b, n_r), (torch.int32,))}
    arrays = dict(spec._asdict(), **extra)
    for name, a in arrays.items():
        shape, dtypes = want[name]
        if a.device != seeds.device:
            raise ValueError(f"{name} on {a.device}, seeds on {seeds.device}")
        if tuple(a.shape) != shape or a.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise ValueError("seeds must be (L,) int32")
    if seeds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no event-sim kernel for device {seeds.device}")


def sim_lanes(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
              warmup: int, mpl: int, max_events: torch.Tensor,
              trace_cap: int = 0,
              bmiss: Optional[torch.Tensor] = None, n_flows: int = 0,
              flow_theta: float = 0.0, n_disks: int = 1,
              disk_rank: Optional[torch.Tensor] = None,
              count_branches: bool = False,
              tiers: Optional[LaneTiers] = None, sketch_cap: int = 0,
              window_us: float = 0.0) -> LaneOutputs:
    """Simulate ``(L,)`` lanes: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``spec`` holds the per-lane network arrays (see :class:`_LaneSpec`;
    ``is_queue`` may be bool or int32), ``seeds`` the (L,) int32 lane
    seeds and ``max_events`` the (L,) int32 per-lane event budgets, all on
    one device.  ``trace_cap > 0`` runs the traced kernel
    and needs ``bmiss``, the (L, B) bool or int32 per-branch miss-class
    table; the result then carries the filled rings.  ``n_flows > 0``
    runs the coalescing kernel (see :func:`sim_lanes_plain`) and needs
    ``disk_rank``, the (L, K) int32 disk rank of each station; the result
    then carries the delayed fraction and the per-branch counts.
    ``count_branches`` with ``n_flows = 0`` runs the counting kernel
    (``kCount``): the closed loop's events with the per-branch counts (and
    a zero delayed fraction) on the result; traced as well, it is one
    traced closed and one counting launch, which simulate the same
    events.
    ``tiers`` (a :class:`LaneTiers`, with ``n_flows > 0``) runs the tiered
    kernel (``kTiers``, see :func:`sim_lanes_plain`) in place of the
    coalescing one; the result carries the per-branch counts and the
    delayed fraction per held level.
    ``sketch_cap > 0`` runs the streaming estimators (windows of
    ``window_us``) in the launch, the sketched instantiation of its mode,
    and needs ``bmiss`` (the miss routes: a completion on any other branch
    is a hit); the result carries the lanes' state on ``sketch``, and its
    other outputs are the unsketched launch's bit for bit.  Traced with
    the per-branch counts as well, the sketch rides the traced launch.
    ``trace_cap > 0`` with ``n_flows > 0`` runs the traced coalescing or
    tiered instantiation, one launch that carries the rings, the counts
    and (``sketch_cap > 0``) the sketch.
    Untraced, traced, coalescing, counting and tiered launches are counted
    apart (``sim_lanes.launches``, ``.traced_launches``,
    ``.flows_launches``, ``.count_launches``, ``.tiers_launches``), as are
    the traced coalescing and tiered ones (``.traced_flows_launches``,
    ``.traced_tiers_launches``), and every sketched launch, of any mode,
    in ``.sketch_launches``.
    """
    if trace_cap < 0:
        raise ValueError(f"trace_cap must be >= 0, got {trace_cap}")
    if n_flows < 0:
        raise ValueError(f"n_flows must be >= 0, got {n_flows}")
    extra = dict(max_events=max_events)
    if tiers is not None:
        if not n_flows:
            raise ValueError("tiers need n_flows > 0 (the flows per leader "
                             "group)")
        if not 1 <= tiers.max_held <= MAX_HELD:
            raise ValueError(f"tiers.max_held {tiers.max_held}: the tiered "
                             f"kernel holds 1 to MAX_HELD = {MAX_HELD} "
                             f"entries per job")
        if not 1 <= tiers.n_groups <= MAX_GROUPS:
            raise ValueError(f"tiers.n_groups {tiers.n_groups}: the tiered "
                             f"kernel's int8 tables take 1 to MAX_GROUPS = "
                             f"{MAX_GROUPS} leader groups")
        extra.update(acq_group=tiers.acq_group, acq_slot=tiers.acq_slot,
                     rel_slot=tiers.rel_slot)
    if trace_cap and bmiss is None:
        raise ValueError("trace_cap > 0 needs the (L, B) bmiss table")
    if sketch_cap:
        if bmiss is None:
            raise ValueError("sketch_cap > 0 needs the (L, B) bmiss table")
        if window_us <= 0:
            raise ValueError("sketch_cap > 0 requires window_us > 0")
    if trace_cap or sketch_cap:
        extra["bmiss"] = bmiss
    if n_flows and tiers is None:
        if disk_rank is None:
            raise ValueError("n_flows > 0 needs the (L, K) disk_rank table")
        extra["disk_rank"] = disk_rank
    _check_inputs(spec, seeds, extra)
    flows = dict(n_flows=n_flows, flow_theta=flow_theta, n_disks=n_disks,
                 disk_rank=disk_rank, tiers=tiers)
    if seeds.device.type == "cpu":
        return sim_lanes_plain(spec, seeds, n_requests=n_requests,
                               warmup=warmup, mpl=mpl, max_events=max_events,
                               trace_cap=trace_cap, bmiss=bmiss,
                               count_branches=count_branches,
                               sketch_cap=sketch_cap, window_us=window_us,
                               **flows)
    sk = sketch_init(sketch_cap, spec.visits.shape[1], seeds.shape[0],
                     device=seeds.device)
    sketched = None if sk is None else (sk, window_us)
    if n_flows:
        # coalescing or tiered, traced or not, with the sketch or not: one
        # launch
        out = _launch_ext(spec, seeds, n_requests=n_requests, warmup=warmup,
                          n_jobs=mpl, max_events=max_events, bmiss=bmiss,
                          trace_cap=trace_cap, sketch=sketched, **flows)
        tiered = tiers is not None
        if sketched is not None:
            sim_lanes.sketch_launches += 1
        elif trace_cap and tiered:
            sim_lanes.traced_tiers_launches += 1
        elif trace_cap:
            sim_lanes.traced_flows_launches += 1
        elif tiered:
            sim_lanes.tiers_launches += 1
        else:
            sim_lanes.flows_launches += 1
        return out
    count = {}
    if count_branches:
        out = _launch_ext(spec, seeds, n_requests=n_requests, warmup=warmup,
                          n_jobs=mpl, max_events=max_events, bmiss=bmiss,
                          sketch=None if trace_cap else sketched, **flows)
        if sketched is not None and not trace_cap:
            sim_lanes.sketch_launches += 1
        else:
            sim_lanes.count_launches += 1
        if not trace_cap:
            return out
        # traced as well: the traced launch simulates the same events
        count = dict(delayed_frac=out.delayed_frac,
                     branch_done=out.branch_done,
                     branch_delayed=out.branch_delayed)
    # the closed loop, traced or not, with the sketch or not
    out = _launch_ext(spec, seeds, n_requests=n_requests, warmup=warmup,
                      n_jobs=mpl, max_events=max_events, n_flows=0,
                      flow_theta=0.0, n_disks=1, disk_rank=None, closed=True,
                      trace_cap=trace_cap, bmiss=bmiss, sketch=sketched)
    if sketched is not None:
        sim_lanes.sketch_launches += 1
    elif trace_cap:
        sim_lanes.traced_launches += 1
    else:
        sim_lanes.launches += 1
    return out._replace(**count)


sim_lanes.launches = 0  # untraced kernel launches (CUDA path only)
sim_lanes.traced_launches = 0  # traced kernel launches (CUDA path only)
sim_lanes.flows_launches = 0  # coalescing kernel launches (CUDA path only)
sim_lanes.count_launches = 0  # counting kernel launches (CUDA path only)
sim_lanes.tiers_launches = 0  # tiered kernel launches (CUDA path only)
# traced coalescing and traced tiered launches (CUDA path only)
sim_lanes.traced_flows_launches = 0
sim_lanes.traced_tiers_launches = 0
# sketched launches of any mode, sim_open_lanes' too (CUDA path only)
sim_lanes.sketch_launches = 0


def sim_open_lanes(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
                   warmup: int, n_slots: int, max_events: torch.Tensor,
                   ia_mean: torch.Tensor, bmiss: torch.Tensor, burst=None,
                   n_flows: int = 0, flow_theta: float = 0.0,
                   n_disks: int = 1,
                   disk_rank: Optional[torch.Tensor] = None,
                   sketch_cap: int = 0, window_us: float = 0.0,
                   trace_cap: int = 0) -> OpenLaneOutputs:
    """Simulate ``(L,)`` open-loop lanes (see :func:`sim_open_lanes_plain`
    for the arguments): the CUDA kernel's open-loop instantiation for
    CUDA tensors, the plain version for CPU tensors.  ``ia_mean`` is the
    (L,) float32 mean interarrival in ns, ``bmiss`` the (L, B) per-branch
    miss class, ``burst`` None or the float32 ON and OFF phase means in
    ns.  ``sketch_cap > 0`` runs the streaming estimators (the sketched
    open-loop instantiation; see :func:`sim_lanes`) and returns their
    state on ``sketch``.  ``trace_cap > 0`` runs the traced open-loop
    instantiation and returns the lanes' trace rings on ``rings``.
    Launches are counted in ``sim_open_lanes.launches``, traced ones in
    ``sim_open_lanes.traced_launches`` and sketched ones (traced or not)
    in ``sim_lanes.sketch_launches``.
    """
    if trace_cap < 0:
        raise ValueError(f"trace_cap must be >= 0, got {trace_cap}")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    if n_flows < 0:
        raise ValueError(f"n_flows must be >= 0, got {n_flows}")
    extra = dict(max_events=max_events, ia_mean=ia_mean, bmiss=bmiss)
    if n_flows:
        if disk_rank is None:
            raise ValueError("n_flows > 0 needs the (L, K) disk_rank table")
        extra["disk_rank"] = disk_rank
    if sketch_cap and window_us <= 0:
        raise ValueError("sketch_cap > 0 requires window_us > 0")
    _check_inputs(spec, seeds, extra)
    kw = dict(n_requests=n_requests, warmup=warmup, max_events=max_events,
              n_flows=n_flows, flow_theta=flow_theta, n_disks=n_disks,
              disk_rank=disk_rank, trace_cap=trace_cap)
    if seeds.device.type == "cpu":
        return sim_open_lanes_plain(spec, seeds, n_slots=n_slots,
                                    ia_mean=ia_mean, bmiss=bmiss, burst=burst,
                                    sketch_cap=sketch_cap,
                                    window_us=window_us, **kw)
    sk = sketch_init(sketch_cap, spec.visits.shape[1], seeds.shape[0],
                     device=seeds.device)
    out = _launch_ext(spec, seeds, n_jobs=n_slots, open_loop=(ia_mean, burst),
                      bmiss=bmiss,
                      sketch=None if sk is None else (sk, window_us), **kw)
    if sk is not None:
        sim_lanes.sketch_launches += 1
    elif trace_cap:
        sim_open_lanes.traced_launches += 1
    else:
        sim_open_lanes.launches += 1
    return out


sim_open_lanes.launches = 0  # open-loop kernel launches (CUDA path only)
sim_open_lanes.traced_launches = 0  # traced ones (CUDA path only)


def _check_shared(nbytes: int, what: str) -> None:
    if nbytes > _build.MAX_SHARED_BYTES:
        raise ValueError(f"event-sim lane state needs {nbytes} bytes of "
                         f"shared memory ({what}); a block may use at most "
                         f"{_build.MAX_SHARED_BYTES}")


@functools.lru_cache(maxsize=None)
def _decay_table(n_jobs: int, device: torch.device) -> torch.Tensor:
    """:func:`~repro_torch.obs.streaming.pow_table` up to ``n_jobs`` on
    ``device``, made once: the sketched launches only read it, so no launch
    waits for a copy from the host."""
    return pow_table(n_jobs, device=device)


def _launch_ext(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
                warmup: int, n_jobs: int, max_events: torch.Tensor,
                n_flows: int, flow_theta: float, n_disks: int,
                disk_rank: Optional[torch.Tensor], open_loop=None,
                tiers: Optional[LaneTiers] = None, closed: bool = False,
                trace_cap: int = 0, bmiss: Optional[torch.Tensor] = None,
                sketch=None):
    """One launch of the closed-loop (``closed``), coalescing
    (``open_loop`` None, ``n_flows > 0``), counting (``open_loop`` None,
    ``n_flows = 0``), tiered (``tiers``) or open-loop (``open_loop =
    (ia_mean, burst)``) instantiation; traced when ``trace_cap > 0`` (the
    rings come back on the result; every mode but counting), with
    ``sketch = (state, window_us)`` sketched.  ``bmiss``, the (L, B) miss
    routes, feeds the rings, the open loop and the sketch."""
    dev = seeds.device
    n_l = seeds.shape[0]
    n_k = spec.is_queue.shape[1]
    n_b, n_r = spec.visits.shape[1], spec.visits.shape[2]
    keep = []  # the tensors the launch reads or writes, alive until it ends

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        if t is None:
            return None
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    def empty(dtype, *shape) -> torch.Tensor:
        t = torch.empty((n_l, *shape), dtype=dtype, device=dev)
        keep.append(t)
        return t

    cdf = flow_cdf(n_flows, flow_theta) if n_flows else None
    a = _ExtArgs()
    for name, t in zip(("isq", "svc", "did", "dpar", "bcum", "visits",
                        "servers"), spec._replace(
                            is_queue=spec.is_queue.to(torch.int32))):
        setattr(a, name, ptr(t))
    a.seeds, a.max_events = ptr(seeds), ptr(max_events)
    if n_flows:
        a.disk_rank = ptr(disk_rank)
        a.flow_cum = ptr(None if cdf is None else torch.from_numpy(cdf).to(dev))
    n_lead = max(n_disks, 1) * n_flows
    if tiers is not None:
        a.acq_group, a.acq_slot, a.rel_slot = (
            ptr(t) for t in (tiers.acq_group, tiers.acq_slot, tiers.rel_slot))
        a.tiers, a.max_held = 1, tiers.max_held
        n_lead = tiers.n_groups * n_flows
    outs = dict(x=empty(torch.float32), completed=empty(torch.int32),
                events=empty(torch.int32), tmeas=empty(torch.float32),
                delayed_frac=empty(torch.float32))
    n_rec = n_requests + n_jobs
    if closed:
        a.closed = 1
    elif open_loop is None:
        outs.update(branch_done=empty(torch.int32, n_b),
                    branch_delayed=empty(torch.int32, n_b))
        if tiers is not None:
            outs["delayed_tier"] = empty(torch.float32, tiers.max_held)
    else:
        ia_mean, burst = open_loop
        a.ia_mean, a.bmiss = ptr(ia_mean), ptr(bmiss.to(torch.int32))
        outs.update(dropped=empty(torch.int32),
                    soj=torch.zeros((n_l, n_rec), dtype=torch.float32,
                                    device=dev),
                    cls=torch.zeros((n_l, n_rec), dtype=torch.int8,
                                    device=dev))
        keep += [outs["soj"], outs["cls"]]
        a.open, a.rec_len = 1, n_rec
        if burst is not None:
            a.burst = 1
            a.on_mean, a.off_mean = (float(np.float32(v)) for v in burst)
    for name, t in outs.items():
        setattr(a, name, t.data_ptr())
    a.lanes, a.n_k, a.n_b, a.n_l, a.mpl = n_l, n_k, n_b, n_r, n_jobs
    a.n_requests, a.warmup = n_requests, warmup
    a.n_flows, a.n_lead = n_flows, n_lead
    rings = None
    if trace_cap:
        rings = init_rings(n_l, trace_cap, n_r, dev)
        keep.append(rings)
        a.cap, a.bmiss = trace_cap, ptr(bmiss.to(torch.int32))
        for name, t in zip(("n_count", "req", "rbranch", "rcls", "nvis",
                            "parked", "enter", "leave"), rings):
            setattr(a, name, t.data_ptr())
    s_args = None
    if sketch is not None:
        state, window_us = sketch
        decay = _decay_table(n_jobs, dev)
        s_args = sketch_args(state, window_us, decay)
        s_args.bmiss = ptr(bmiss.to(torch.int32))
    lib = _build.load_library()
    nbytes = lib.event_sim_ext_shared_bytes(ctypes.byref(a),
                                            int(sketch is not None))
    _check_shared(nbytes, f"n={n_jobs}, K={n_k}, B={n_b}, L={n_r}, "
                  f"flows={a.n_lead}, open={a.open}, tiers={a.tiers}, "
                  f"traced={trace_cap > 0}, sketch={sketch is not None}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.event_sim_ext_launch(
            ctypes.byref(a), None if s_args is None else ctypes.byref(s_args),
            stream)
    _build.check(err, "event-sim kernel launch")
    sk = None if sketch is None else sketch[0]
    if closed:
        return LaneOutputs(outs["x"], outs["completed"], outs["events"],
                           outs["tmeas"], rings, sketch=sk)
    if open_loop is None:
        return LaneOutputs(outs["x"], outs["completed"], outs["events"],
                           outs["tmeas"], rings, outs["delayed_frac"],
                           outs["branch_done"], outs["branch_delayed"],
                           outs.get("delayed_tier"), sketch=sk)
    return OpenLaneOutputs(outs["x"], outs["completed"], outs["events"],
                           outs["tmeas"], outs["delayed_frac"],
                           outs["dropped"], outs["soj"], outs["cls"], sk,
                           rings)


def branch_miss(spec: SimSpec) -> np.ndarray:
    """(B,) bool per-branch sojourn class of one compiled network: a
    branch whose route touches a backing store is a miss, any other a hit
    (the closed loop without coalescing has no delayed hits).  The formula
    of the reference ``simulate_grid_pallas``."""
    vis = spec.visits.cpu().numpy()
    dr = spec.disk_rank.cpu().numpy()
    return ((dr[np.maximum(vis, 0)] >= 0) & (vis >= 0)).any(axis=1)


def grid_lanes(net, p_hits, n_requests: int, seeds: Sequence[int],
               warmup_frac: float, device: torch.device, trace: int = 0,
               coalesce_flows: int = 0, coalesce_theta: float = 0.0,
               budget_visits: int = 2, tiers=None, sketch: bool = False):
    """The (seed x p_hit) lane grid of a network, lane = s * P + p.

    Returns ``(spec, seeds, kwargs)`` ready for :func:`sim_lanes`: the
    per-p_hit specs tiled across seeds, lane seeds ``seed*1000 + p_index``
    (int32 arithmetic, as the reference) and the warmup / per-lane event
    budget ``max_events = n_requests * (Lr + budget_visits) * 3``; with
    ``trace > 0`` also ``trace_cap``; with ``coalesce_flows > 0`` the
    coalescing arguments, with ``n_disks`` taken from the first network's
    disk ranks, as the reference does, and with ``tiers`` (the network's
    :class:`~repro_torch.core.simspec.MshrSpec`) also its
    :class:`LaneTiers`.  ``trace`` and ``sketch`` add the (L, B)
    ``bmiss`` table the rings and the sketch read (:func:`branch_miss` of
    the first p_hit's network, the same for every lane; a tiered
    network's acquiring branches are miss routes too).
    """
    specs = [compile_network(net, float(p), device=device) for p in p_hits]
    n_p = len(specs)
    seed_v = np.concatenate(
        [np.full(n_p, s, np.int32) * np.int32(1000)
         + np.arange(n_p, dtype=np.int32) for s in seeds])
    lane_spec, seed_t, kwargs = pad_lanes(specs * len(seeds), seed_v.tolist(),
                                          n_requests, warmup_frac,
                                          budget_visits)
    if trace or sketch:
        kwargs["bmiss"] = _bmiss(specs[0], len(seed_v), device,
                                 tiers if coalesce_flows else None)
    if trace:
        kwargs["trace_cap"] = int(trace)
    if coalesce_flows:
        disk_rank = torch.stack([s.disk_rank for s in specs] * len(seeds))
        kwargs.update(n_flows=int(coalesce_flows),
                      flow_theta=float(coalesce_theta),
                      n_disks=_n_disks(specs[0]),
                      disk_rank=disk_rank.to(torch.int32))
        if tiers is not None:
            kwargs["tiers"] = lane_tiers([tiers] * len(seed_v),
                                         *lane_spec.visits.shape[1:], device)
    return lane_spec, seed_t, kwargs


def _n_disks(spec: SimSpec) -> int:
    """Disk groups of a network: ``max(disk_rank) + 1``, at least 1."""
    return max(1, int(spec.disk_rank.max()) + 1)


def _bmiss(spec: SimSpec, n_lanes: int, device, tiers=None) -> torch.Tensor:
    """The (L, B) miss routes: :func:`branch_miss`, and with ``tiers`` every
    branch that acquires an MSHR entry (the reference's
    ``branch_is_miss``)."""
    miss = branch_miss(spec)
    if tiers is not None:
        miss = miss | (np.asarray(tiers.acq_group) >= 0).any(axis=1)
    bmiss = np.broadcast_to(miss, (n_lanes, spec.visits.shape[0]))
    return torch.from_numpy(bmiss.astype(np.int32)).to(device)


def _budget(n_requests: int, spec: SimSpec, visits: int = 2) -> int:
    """The reference's event budget of one network: ``n_requests * (Lr +
    visits) * 3`` events, ``Lr`` its own route length (``visits`` 2 in the
    closed loop, 3 in the open loop, whose arrivals are events too)."""
    return int(n_requests * (spec.visits.shape[-1] + visits) * 3)


def pad_lanes(specs: Sequence[SimSpec], seeds: Sequence[int],
              n_requests: int, warmup_frac: float, budget_visits: int = 2):
    """One lane per compiled spec, networks of different shapes padded into
    one grid (:func:`~repro_torch.core.simspec.stack_specs`).

    Returns ``(spec, seeds, kwargs)`` ready for :func:`sim_lanes`, on the
    specs' device: lane ``i`` runs ``specs[i]`` on lane seed ``seeds[i]``
    with its own network's event budget, so each lane's outputs are
    those of its network simulated alone on that seed.  The specs must
    share one ``mpl``.
    """
    if len(specs) != len(seeds):
        raise ValueError(f"{len(specs)} specs but {len(seeds)} seeds")
    spec = stack_specs(specs)
    dev = spec.visits.device
    budgets = torch.tensor([_budget(n_requests, s, budget_visits)
                            for s in specs], dtype=torch.int32, device=dev)
    kwargs = dict(n_requests=n_requests, warmup=int(n_requests * warmup_frac),
                  mpl=spec.mpl, max_events=budgets)
    seed_v = torch.tensor(list(seeds), dtype=torch.int32, device=dev)
    return _LaneSpec(*spec[:7]), seed_v, kwargs


def simulate_cells(cells, n_requests: int, warmup_frac: float = 0.25,
                   device: str = "cuda") -> np.ndarray:
    """Throughput (requests/µs) of each ``(network, p_hit, lane_seed)``
    cell, every cell a lane of ONE launch.

    A cell's result is bit for bit that of its network simulated alone at
    ``p_hit`` on that lane seed (``simulate_network(net, [p_hit],
    seeds=(s,))`` runs lane seed ``s * 1000``).  The networks may differ
    in shape but must share one ``mpl``.
    """
    dev = resolve_device(device)
    specs = [compile_network(net, float(p), device=dev) for net, p, _ in cells]
    spec, seed_v, kwargs = pad_lanes(specs, [int(s) for _, _, s in cells],
                                     n_requests, warmup_frac)
    return sim_lanes(spec, seed_v, **kwargs).x.cpu().numpy()


def simulate_grid(net, p_hits, n_requests: int = 40_000,
                  seeds: Sequence[int] = (0, 1, 2),
                  warmup_frac: float = 0.25, trace: int = 0,
                  coalesce_flows: int = 0, coalesce_theta: float = 0.0,
                  count_branches: bool = False, tiers=None,
                  sketch_cap: int = 0, window_us: float = 0.0,
                  device: str = "cuda") -> SimResult:
    """Closed-loop (p_hit x seed) grid on the counter-RNG event engine.

    The grid construction, warmup and summary of the reference
    ``simulate_grid_pallas``: per-p_hit specs tiled across seeds, one lane
    per cell, ONE launch for the whole grid on the card; the mean and
    CI95 half-width of the throughput across seeds.  ``trace=K`` keeps the
    last K per-request records of every lane and decodes them onto the
    result's ``traces`` (``[seed][p]``
    :class:`~repro_torch.obs.trace.TraceRecords`).

    ``coalesce_flows = F > 0`` coalesces misses over F flows per disk
    group (Zipf(``coalesce_theta``)-weighted when it is > 0) and fills
    ``delayed_frac``, ``branch_throughput`` and ``branch_delayed`` (per
    branch of ``net``, completions per µs of the measured window) as the
    reference's ``simulate_network`` does.  With ``F = 0`` no coalescing
    code runs, ``delayed_frac`` is zero and the branch columns are None,
    unless ``count_branches``: then the counting kernel fills them (the
    reference's threefry engine fills them on every closed run; the
    cluster prong asks for them).  ``tiers`` (an
    :class:`~repro_torch.core.simspec.MshrSpec`, with ``F > 0``) runs the
    tiered tables in place of the disk groups and also fills
    ``delayed_tier_frac``.  ``sketch_cap > 0`` runs the streaming
    estimators in the launch (windows of ``window_us``) and decodes them
    onto ``sketches`` (``[seed][p]``
    :class:`~repro_torch.obs.streaming.SketchEstimates`); every other field
    is the unsketched run's bit for bit.
    """
    dev = resolve_device(device)
    p_hits = np.atleast_1d(np.asarray(p_hits, dtype=np.float64))
    n_s, n_p = len(seeds), len(p_hits)
    trace = int(trace)
    spec, seed_v, kwargs = grid_lanes(net, p_hits, n_requests, seeds,
                                      warmup_frac, dev, trace=trace,
                                      coalesce_flows=int(coalesce_flows),
                                      coalesce_theta=float(coalesce_theta),
                                      tiers=tiers, sketch=sketch_cap > 0)
    out = sim_lanes(spec, seed_v, count_branches=count_branches,
                    sketch_cap=int(sketch_cap), window_us=float(window_us),
                    **kwargs)
    return _grid_result(out, p_hits, n_s, len(net.branches), n_requests,
                       visits=spec.visits[0] if trace else None,
                       window_us=float(window_us))


def _grid_result(out: LaneOutputs, p_hits: np.ndarray, n_s: int, n_b: int,
                n_requests: int, visits=None,
                window_us: float = 0.0) -> SimResult:
    """The reference's summary of a closed-loop grid's lanes ``out`` (lane
    ``s * P + p`` of ``n_s`` seeds): the mean throughput and CI95 across
    seeds; with per-branch counts on ``out``, the delayed fraction and the
    per-branch rates of the network's ``n_b`` branches, each lane's
    counts over its measured window, averaged over seeds (and with
    per-level counts the delayed fractions per level); with ``visits``,
    the lanes' rings decoded onto ``traces``; with a sketch on ``out``,
    its lanes decoded onto ``sketches`` (windows of ``window_us``)."""
    n_p = len(p_hits)
    traces = None
    if visits is not None:
        traces = decode_trace_grid(out.rings, visits, n_s, n_p)
    sketches = None
    if out.sketch is not None:
        sketches = decode_sketch_grid(out.sketch, n_s, n_p, window_us)
    xs = out.x.cpu().numpy().reshape(n_s, n_p)
    mean = xs.mean(axis=0)
    ci = (1.96 * xs.std(axis=0, ddof=1) / math.sqrt(n_s) if n_s > 1
          else np.zeros_like(mean))
    extra = dict(delayed_frac=np.zeros(n_p, dtype=np.float32))
    if out.branch_done is not None:
        t_meas = out.t_measured.cpu().numpy().reshape(n_s, n_p, 1)
        per_branch = [a.cpu().numpy()[:, :n_b].reshape(n_s, n_p, n_b)
                      / t_meas for a in (out.branch_done, out.branch_delayed)]
        extra = dict(
            delayed_frac=out.delayed_frac.cpu().numpy().reshape(
                n_s, n_p).mean(axis=0),
            branch_throughput=per_branch[0].mean(axis=0),
            branch_delayed=per_branch[1].mean(axis=0))
    if out.delayed_tier is not None:
        extra["delayed_tier_frac"] = out.delayed_tier.cpu().numpy().reshape(
            n_s, n_p, -1).mean(axis=0)
    return SimResult(p_hit=p_hits, throughput=mean, ci95=ci,
                     n_requests=n_requests, traces=traces, sketches=sketches,
                     **extra)


def open_lanes(net, p_hits, rates: np.ndarray, n_requests: int,
               seeds: Sequence[int], warmup_frac: float, max_in_system: int,
               burst=None, coalesce_flows: int = 0,
               coalesce_theta: float = 0.0, sketch_cap: int = 0,
               window_us: float = 0.0, device: str = "cuda",
               trace: int = 0):
    """The open-loop (seed x p_hit) lane grid (lane = s * P + p, lane seeds
    as :func:`grid_lanes`) at the (P,) arrival ``rates`` (requests/µs).

    Returns ``(spec, seeds, kwargs)`` ready for :func:`sim_open_lanes`:
    mean interarrival ``float32(1e3 / rate)`` ns, times ``duty`` while ON
    under ``burst = (duty, mean_on_us)``, whose ON and OFF phases have
    means ``mean_on_us * 1e3`` and ``mean_on_us * 1e3 * (1 - duty) /
    duty`` ns (float32, as the reference's); the event budget
    ``n_requests * (Lr + 3) * 3``, as the reference's; ``sketch_cap`` and
    ``window_us`` as :func:`sim_open_lanes` takes them, and ``trace`` as
    its ``trace_cap``.
    """
    dev = resolve_device(device)
    spec, seed_v, kwargs = grid_lanes(net, p_hits, n_requests, seeds,
                                      warmup_frac, dev,
                                      coalesce_flows=coalesce_flows,
                                      coalesce_theta=coalesce_theta,
                                      budget_visits=3)
    first = compile_network(net, float(p_hits[0]), device=dev)
    mean_ns = np.tile((1e3 / np.asarray(rates, np.float64)).astype(np.float32),
                      len(seeds))
    phases = None
    if burst is not None:
        duty, mean_on_us = float(burst[0]), float(burst[1])
        mean_ns = mean_ns * np.float32(duty)
        on_ns = mean_on_us * 1e3
        phases = (np.float32(on_ns), np.float32(on_ns * (1.0 - duty) / duty))
    kwargs.pop("mpl")
    kwargs.update(n_slots=int(max_in_system),
                  ia_mean=torch.from_numpy(mean_ns).to(dev),
                  bmiss=_bmiss(first, len(seed_v), dev), burst=phases,
                  sketch_cap=int(sketch_cap), window_us=float(window_us),
                  trace_cap=int(trace))
    return spec, seed_v, kwargs


def open_grid(net, p_hits, rates: np.ndarray, n_requests: int,
              seeds: Sequence[int], warmup_frac: float, max_in_system: int,
              burst=None, coalesce_flows: int = 0,
              coalesce_theta: float = 0.0, sketch_cap: int = 0,
              window_us: float = 0.0, device: str = "cuda",
              trace: int = 0) -> OpenLaneOutputs:
    """The open-loop grid of :func:`open_lanes` in ONE launch (the plain
    version on the CPU); returns the lanes' raw outputs."""
    spec, seed_v, kwargs = open_lanes(net, p_hits, rates, n_requests, seeds,
                                      warmup_frac, max_in_system, burst,
                                      coalesce_flows, coalesce_theta,
                                      sketch_cap, window_us, device, trace)
    return sim_open_lanes(spec, seed_v, **kwargs)
