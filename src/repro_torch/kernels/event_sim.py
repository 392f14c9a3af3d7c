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
(the CUDA kernel's untraced instantiation compiles none).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.simspec import (BIG_SEQ, INF_NS, SimResult, SimSpec,
                                      compile_network, stack_specs)
from repro_torch.kernels import _build
from repro_torch.obs.trace import (CLS_HIT, CLS_MISS, TraceRings,
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
    z = _mix((base + (ctr.long() & _M32) * _GOLDEN) & _M32)
    u = (z >> 8).to(torch.float32) * _f32(_INV24, z)
    return torch.clamp(u, min=_f32(_U_LO, z), max=_f32(_U_HI, z))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The reference's ``elapsed_us + t * 1e-3`` is compiled by XLA's CPU
    backend into one fused multiply-add, and the CUDA kernel computes it
    with ``__fmaf_rn``.  Here the product of two float32 values is exact in
    float64; the float64 sum is made round-to-odd (its error, from
    TwoSum, picks the odd neighbour), which then rounds to the same float32
    as the exact ``a * b + c``.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & (bits & 1 == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


class _LaneSpec(NamedTuple):
    """The seven per-lane arrays of a compiled network the kernel reads."""

    is_queue: torch.Tensor     # (L, K) bool
    svc_ns: torch.Tensor       # (L, K) f32
    dist_id: torch.Tensor      # (L, K) i32
    dist_params: torch.Tensor  # (L, K, 4) f32
    branch_cum: torch.Tensor   # (L, B) f32
    visits: torch.Tensor       # (L, B, Lr) i32
    servers: torch.Tensor      # (L, K) i32


def _service_table(u: torch.Tensor, spec: _LaneSpec) -> torch.Tensor:
    """Service draws (ns, >= 1) from uniforms ``u`` (L, C) at every
    station: (L, C, K) int64.  The reference formulas in float32, ``round``
    half to even."""
    u = u.unsqueeze(-1)
    mean = spec.svc_ns[:, None, :]
    dist = spec.dist_id[:, None, :]
    alpha, lo, hi, raw_mean = (spec.dist_params[:, None, :, i]
                               for i in range(4))
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


class LaneOutputs(NamedTuple):
    x: torch.Tensor           # (L,) f32 throughput, requests/µs
    completed: torch.Tensor   # (L,) i32
    events: torch.Tensor      # (L,) i32
    t_measured: torch.Tensor  # (L,) f32 µs
    rings: Optional[TraceRings] = None  # filled when trace_cap > 0


def sim_lanes_plain(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
                    warmup: int, mpl: int, max_events: torch.Tensor,
                    trace_cap: int = 0,
                    bmiss: Optional[torch.Tensor] = None) -> LaneOutputs:
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
        c = e % _CHUNK
        e += 1
        active = (completed < n_requests) & (events < max_events)

        j = ready.argmin(dim=1)  # first index on ties, as jnp.argmin
        t = ready[lane, j]
        ready = torch.where(active[:, None] & (ready < inf),
                            ready - t[:, None], ready)
        elapsed = torch.where(active, fma_f32(t.to(torch.float32), ns_to_us,
                                              elapsed), elapsed)
        k_cur = station[lane, j]

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
        completed = torch.where(active, completed + done.long(), completed)

        # place j at k_next
        is_q = is_queue[lane, k_next]
        starts_now = ~is_q | (busy[lane, k_next] < servers[lane, k_next])
        put(ready, j, torch.where(starts_now, svc2[lane, c, k_next], inf),
            active)
        put(enq, j, torch.where(starts_now, big, seq_ctr), active)
        seq_ctr = torch.where(active & ~starts_now, seq_ctr + 1, seq_ctr)
        put(busy, k_next, busy[lane, k_next] + 1, active & is_q & starts_now)
        put(station, j, k_next, active)
        put(branch, j, torch.where(done, new_branch, b_j), active)
        put(pos, j, torch.where(done, 0, nxt), active)

        # warmup bookkeeping
        warm_now = active & (completed >= warmup) & (warm_completed < 0)
        warm_completed = torch.where(warm_now, completed, warm_completed)
        warm_elapsed = torch.where(warm_now, elapsed, warm_elapsed)
        events = torch.where(active, events + 1, events)

    t_meas = torch.clamp(elapsed - warm_elapsed, min=_f32(_T_MIN, elapsed))
    x = (completed - warm_completed).to(torch.float32) / t_meas
    return LaneOutputs(x, completed.to(torch.int32), events.to(torch.int32),
                       t_meas, rings)


def _trace_event(rings: TraceRings, enter_s: torch.Tensor,
                 leave_s: torch.Tensor, lane: torch.Tensor, j: torch.Tensor,
                 pos_j: torch.Tensor, pos_next: torch.Tensor,
                 b_j: torch.Tensor, miss: torch.Tensor, elapsed: torch.Tensor,
                 completed: torch.Tensor, active: torch.Tensor,
                 write: torch.Tensor, cap: int) -> None:
    """One event's trace updates, in place, every lane at once: stamp job
    ``j`` leaving visit ``pos_j``, write the record of a completing request
    (scrap row ``cap`` otherwise), stamp ``j`` entering ``pos_next``."""
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
    enter_s[lane, j, pos_next] = torch.where(active, elapsed,
                                             enter_s[lane, j, pos_next])


def sim_lanes(spec: _LaneSpec, seeds: torch.Tensor, *, n_requests: int,
              warmup: int, mpl: int, max_events: torch.Tensor,
              trace_cap: int = 0,
              bmiss: Optional[torch.Tensor] = None) -> LaneOutputs:
    """Simulate ``(L,)`` lanes: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``spec`` holds the per-lane network arrays (see :class:`_LaneSpec`;
    ``is_queue`` may be bool or int32), ``seeds`` the (L,) int32 lane
    seeds and ``max_events`` the (L,) int32 per-lane event budgets, all on
    one device.  ``trace_cap > 0`` runs the traced kernel
    and needs ``bmiss``, the (L, B) bool or int32 per-branch miss-class
    table; the result then carries the filled rings.  Untraced and traced
    launches are counted apart (``sim_lanes.launches``,
    ``sim_lanes.traced_launches``).
    """
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
            "max_events": ((n_l,), (torch.int32,))}
    arrays = dict(spec._asdict(), max_events=max_events)
    if trace_cap < 0:
        raise ValueError(f"trace_cap must be >= 0, got {trace_cap}")
    if trace_cap:
        if bmiss is None:
            raise ValueError("trace_cap > 0 needs the (L, B) bmiss table")
        want["bmiss"] = ((n_l, n_b), (torch.bool, torch.int32))
        arrays["bmiss"] = bmiss
    for name, (shape, dtypes) in want.items():
        a = arrays[name]
        if a.device != seeds.device:
            raise ValueError(f"{name} on {a.device}, seeds on {seeds.device}")
        if tuple(a.shape) != shape or a.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise ValueError("seeds must be (L,) int32")
    if seeds.device.type == "cpu":
        return sim_lanes_plain(spec, seeds, n_requests=n_requests,
                               warmup=warmup, mpl=mpl, max_events=max_events,
                               trace_cap=trace_cap, bmiss=bmiss)
    if seeds.device.type != "cuda":
        raise ValueError(f"no event-sim kernel for device {seeds.device}")
    lib = _build.load_library()
    nbytes = lib.event_sim_shared_bytes(n_k, n_b, n_r, mpl,
                                        int(trace_cap > 0))
    if nbytes > _build.MAX_SHARED_BYTES:
        raise ValueError(f"event-sim lane state needs {nbytes} bytes of "
                         f"shared memory (mpl={mpl}, K={n_k}, B={n_b}, "
                         f"L={n_r}, traced={trace_cap > 0}); a block may use "
                         f"at most {_build.MAX_SHARED_BYTES}")
    ins = [a.contiguous() for a in spec._replace(
        is_queue=spec.is_queue.to(torch.int32))] + [
            seeds.contiguous(), max_events.contiguous()]
    dev = seeds.device
    outs = [torch.empty(n_l, dtype=dt, device=dev) for dt in
            (torch.float32, torch.int32, torch.int32, torch.float32)]
    rings = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if trace_cap:
            rings = init_rings(n_l, trace_cap, n_r, dev)
            err = lib.event_sim_traced_launch(
                *(a.data_ptr() for a in ins),
                bmiss.to(torch.int32).contiguous().data_ptr(),
                *(a.data_ptr() for a in outs),
                *(a.data_ptr() for a in rings),
                n_l, n_k, n_b, n_r, mpl, n_requests, warmup, trace_cap,
                stream)
        else:
            err = lib.event_sim_launch(
                *(a.data_ptr() for a in ins), *(a.data_ptr() for a in outs),
                n_l, n_k, n_b, n_r, mpl, n_requests, warmup, stream)
    _build.check(err, "event-sim kernel launch")
    if trace_cap:
        sim_lanes.traced_launches += 1
    else:
        sim_lanes.launches += 1
    return LaneOutputs(*outs, rings)


sim_lanes.launches = 0  # untraced kernel launches (CUDA path only)
sim_lanes.traced_launches = 0  # traced kernel launches (CUDA path only)


def branch_miss(spec: SimSpec) -> np.ndarray:
    """(B,) bool per-branch sojourn class of one compiled network: a
    branch whose route touches a backing store is a miss, any other a hit
    (the closed loop without coalescing has no delayed hits).  The formula
    of the reference ``simulate_grid_pallas``."""
    vis = spec.visits.cpu().numpy()
    dr = spec.disk_rank.cpu().numpy()
    return ((dr[np.maximum(vis, 0)] >= 0) & (vis >= 0)).any(axis=1)


def grid_lanes(net, p_hits, n_requests: int, seeds: Sequence[int],
               warmup_frac: float, device: torch.device, trace: int = 0):
    """The (seed x p_hit) lane grid of a network, lane = s * P + p.

    Returns ``(spec, seeds, kwargs)`` ready for :func:`sim_lanes`: the
    per-p_hit specs tiled across seeds, lane seeds ``seed*1000 + p_index``
    (int32 arithmetic, as the reference) and the warmup / per-lane event
    budget ``max_events = n_requests * (Lr + 2) * 3``; with ``trace > 0`` also
    ``trace_cap`` and the (L, B) ``bmiss`` table (:func:`branch_miss` of
    the first p_hit's network, the same for every lane).
    """
    specs = [compile_network(net, float(p), device=device) for p in p_hits]
    n_p = len(specs)
    seed_v = np.concatenate(
        [np.full(n_p, s, np.int32) * np.int32(1000)
         + np.arange(n_p, dtype=np.int32) for s in seeds])
    lane_spec, seed_t, kwargs = pad_lanes(specs * len(seeds), seed_v.tolist(),
                                          n_requests, warmup_frac)
    if trace:
        bmiss = np.broadcast_to(branch_miss(specs[0]),
                                (len(seed_v), lane_spec.visits.shape[1]))
        kwargs.update(trace_cap=int(trace),
                      bmiss=torch.from_numpy(bmiss.astype(np.int32)).to(device))
    return lane_spec, seed_t, kwargs


def _budget(n_requests: int, spec: SimSpec) -> int:
    """The reference's event budget of one network: ``n_requests * (Lr +
    2) * 3`` events, ``Lr`` its own route length."""
    return int(n_requests * (spec.visits.shape[-1] + 2) * 3)


def pad_lanes(specs: Sequence[SimSpec], seeds: Sequence[int],
              n_requests: int, warmup_frac: float):
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
    budgets = torch.tensor([_budget(n_requests, s) for s in specs],
                           dtype=torch.int32, device=dev)
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
                  device: str = "cuda") -> SimResult:
    """Closed-loop (p_hit x seed) grid on the counter-RNG event engine.

    The grid construction, warmup and summary of the reference
    ``simulate_grid_pallas``: per-p_hit specs tiled across seeds, one lane
    per cell, ONE launch for the whole grid on the card; the mean and
    CI95 half-width of the throughput across seeds.  ``trace=K`` keeps the
    last K per-request records of every lane and decodes them onto the
    result's ``traces`` (``[seed][p]``
    :class:`~repro_torch.obs.trace.TraceRecords`).
    """
    dev = resolve_device(device)
    p_hits = np.atleast_1d(np.asarray(p_hits, dtype=np.float64))
    n_s = len(seeds)
    trace = int(trace)
    spec, seed_v, kwargs = grid_lanes(net, p_hits, n_requests, seeds,
                                      warmup_frac, dev, trace=trace)
    out = sim_lanes(spec, seed_v, **kwargs)
    traces = None
    if trace:
        traces = decode_trace_grid(out.rings, spec.visits[0], n_s,
                                   len(p_hits))
    xs = out.x.cpu().numpy().reshape(n_s, len(p_hits))
    mean = xs.mean(axis=0)
    ci = (1.96 * xs.std(axis=0, ddof=1) / math.sqrt(n_s) if n_s > 1
          else np.zeros_like(mean))
    return SimResult(p_hit=p_hits, throughput=mean, ci95=ci,
                     n_requests=n_requests, traces=traces)
