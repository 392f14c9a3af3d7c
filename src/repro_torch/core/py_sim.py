"""Pure-Python reference simulator (heapq event loop): the host oracle.

The port's own copy of ``repro.core.py_sim`` (``src/repro/core/py_sim.py``):
the same heapq loop over the same network semantics, drawing from a
``random.Random(seed)`` in the reference's order, so that for one network,
hit ratio and seed it returns exactly the reference's numbers.  Networks
are compiled by the port's :func:`~repro_torch.core.simspec.compile_network`
on the CPU and read back as numpy arrays.  It is an oracle for the
simulator (:mod:`repro_torch.core.simulator`), run on the host; it is not
an entry point on the card.  ~100x slower than the simulator, so keep
``n_requests`` modest.

Supports the same miss-coalescing (delayed hits) semantics as the
simulator: with ``coalesce_flows > 0`` a job arriving at the ``disk``
station samples a flow (hot key, uniformly or Zipf(``coalesce_theta``)-
weighted); if a fetch for that flow is already in flight it parks on an
outstanding-miss table — no duplicate disk I/O, no bounded-``disk_servers``
slot — and completes when the fill lands.

Supports the open-loop latency mode as well (``arrival_rate`` set):
Poisson arrivals into a bounded pool of ``max_in_system`` job slots, with
per-request sojourns and true-hit / true-miss / delayed-hit classes
recorded per completion — the differential twin of
``simulate_network(arrival_rate=...)``.

With ``sketch_cap > 0`` each mode runs the exact-counting streaming
estimator twin (:class:`repro_torch.obs.streaming.PyStreamSketch`) at the
reference's sites, as the reference does.
"""

from __future__ import annotations

import heapq
import random

import numpy as np

from repro_torch.core.queueing import ClosedNetwork, zipf_flow_weights
from repro_torch.core.simspec import compile_network
from repro_torch.obs.streaming import PyStreamSketch
from repro_torch.obs.trace import (CLS_DELAYED, CLS_HIT, CLS_MISS,
                                   PyTraceCollector)


def _flow_sampler(rng: random.Random, flows: int, theta: float):
    """Uniform (theta=0) or Zipf(theta)-weighted flow draw, cf.
    simulator._sample_flow — same weight convention as the model's
    queueing.zipf_flow_weights."""
    if theta == 0.0:
        return lambda: rng.randrange(flows)
    cum = np.cumsum(zipf_flow_weights(flows, theta))
    return lambda: int(np.searchsorted(cum, rng.random()))


def simulate_py(
    net: ClosedNetwork,
    p_hit: float,
    n_requests: int = 20_000,
    seed: int = 0,
    warmup_frac: float = 0.25,
    coalesce_flows: int = 0,
    coalesce_theta: float = 0.0,
    full: bool = False,
    arrival_rate: float | None = None,
    max_in_system: int = 128,
    burst=None,
    tiers=None,
    trace: int = 0,
    sketch_cap: int = 0,
    window_us: float = 0.0,
):
    """Simulate and return throughput in requests/µs.

    Service distributions: det and exp are honored; bounded-Pareto stations
    are sampled at their mean (det) — the paper (and our tests) show the
    throughput is insensitive to this.

    With ``full=True`` returns a dict with ``x`` (throughput),
    ``delayed_frac`` (fraction of measured completions that were delayed
    hits), ``delayed`` (their count), plus per-branch measured completion
    counts ``branch_done`` / ``branch_delayed`` in ``net.branches`` order
    (the cluster prong's per-shard accounting); the bare float return
    stays the default for backward compatibility.

    Multi-disk networks (a cluster composition with per-shard ``sK:disk``
    replicas) coalesce shard-locally: each disk station owns its own flow
    group, mirroring the event-sim kernel's ``disk_rank`` tables.  ``burst``
    (open mode only) matches ``simulate_network``'s ON-OFF MMPP knob.

    With ``arrival_rate`` set the loop runs **open**: Poisson arrivals at
    that rate (requests/µs) enter a pool of ``max_in_system`` slots
    (arrivals beyond it are dropped and counted), each completion records
    its sojourn and class, and the return value is always a dict with the
    sojourn statistics (``sojourn_mean``/``sojourn_p50``/``sojourn_p99``,
    ``class_frac``, ``class_sojourn``, ``drop_frac`` — the oracle twin of
    :class:`repro_torch.core.simulator.OpenSimResult`).

    ``tiers`` (a :class:`~repro_torch.core.simspec.MshrSpec`, or any
    object with its ``acq_group``/``acq_slot``/``rel_slot`` annotation
    arrays, ``max_held`` and ``validate``) switches MSHR
    coalescing to the **cross-tier** tables of a composed hierarchy
    network: acquire/park/release points come from the annotation arrays
    instead of the ``disk_rank`` convention, and fills cascade across
    tiers (a woken delayed hit force-frees its own held entries, waking
    its followers).  Needs ``coalesce_flows > 0``; with 0 the annotations
    are ignored (the no-coalescing reference).  The oracle twin of the
    simulators' ``simulate_network(tiers=...)``.

    ``trace > 0`` collects per-request trace records in the
    :mod:`repro_torch.obs.trace` schema (same capping semantics as the
    event-sim kernel's ring buffers: the last ``trace`` records survive) and
    returns them under the ``"trace"`` key as a decoded
    :class:`~repro_torch.obs.trace.TraceRecords` — the oracle side of the
    trace twin contract.  Closed/tiered modes require ``full=True``
    (the bare-float return has nowhere to put the trace).

    ``sketch_cap > 0`` runs the exact-counting streaming-estimator twin
    (:class:`repro_torch.obs.streaming.PyStreamSketch`, windowed every
    ``window_us`` simulated µs) over the same event stream the simulators
    feed their sketches, returning its decoded
    :class:`~repro_torch.obs.streaming.SketchEstimates` under
    ``"sketch"`` — the oracle side of the sketch twin contract.  Same
    ``full=True`` requirement as tracing in closed/tiered modes.
    """
    rng = random.Random(seed)
    spec = compile_network(net, p_hit, device="cpu")
    is_q = spec.is_queue.numpy()
    svc = spec.svc_ns.numpy() / 1e3  # µs
    dist = spec.dist_id.numpy()
    cum = spec.branch_cum.numpy()
    visits = spec.visits.numpy()
    servers = spec.servers.numpy()
    disk_rank = spec.disk_rank.numpy()
    K = len(is_q)
    B = len(cum)
    F = max(coalesce_flows, 1)
    if coalesce_flows and disk_rank.max() < 0:
        raise ValueError(f"{net.name} has no 'disk' station to coalesce on")
    sample_flow = (
        _flow_sampler(rng, coalesce_flows, coalesce_theta)
        if coalesce_flows else None
    )

    def sample(k: int) -> float:
        if dist[k] == 1:
            return svc[k] * rng.expovariate(1.0)
        return float(svc[k])

    def new_branch() -> int:
        return int(np.searchsorted(cum, rng.random()))

    vis_rank = disk_rank[np.maximum(visits, 0)]
    branch_has_disk = ((vis_rank >= 0) & (visits >= 0)).any(axis=1)
    if trace and arrival_rate is None and not full:
        raise ValueError("trace > 0 requires full=True in closed/tiered "
                         "modes (the bare-float return drops the records)")
    if sketch_cap:
        if window_us <= 0.0:
            raise ValueError("sketch_cap > 0 requires window_us > 0")
        if arrival_rate is None and not full:
            raise ValueError("sketch_cap > 0 requires full=True in "
                             "closed/tiered modes (the bare-float return "
                             "drops the estimates)")
    if tiers is not None and coalesce_flows:
        if arrival_rate is not None or burst is not None:
            raise ValueError("tiered MSHR coalescing runs the closed loop "
                             "only (no arrival_rate/burst)")
        tiers.validate(visits)
        branch_is_miss = (branch_has_disk
                          | (np.asarray(tiers.acq_group) >= 0).any(axis=1))
        return _simulate_py_tiered(
            rng, is_q, visits, servers, sample, new_branch, sample_flow,
            tiers, coalesce_flows, net.mpl, n_requests, warmup_frac, full,
            branch_is_miss, trace, sketch_cap, window_us,
        )
    if arrival_rate is not None:
        return _simulate_py_open(
            rng, is_q, svc, dist, cum, visits, servers, disk_rank, sample,
            new_branch, sample_flow, n_requests, warmup_frac,
            coalesce_flows, float(arrival_rate), max_in_system, burst,
            trace, sketch_cap, window_us,
        )
    if burst is not None:
        raise ValueError("burst arrivals require arrival_rate "
                         "(open-loop mode)")

    N = net.mpl
    tr = PyTraceCollector(trace, N, visits.shape[1]) if trace else None
    sk = (PyStreamSketch(sketch_cap, n_branches=B, window_us=window_us)
          if sketch_cap else None)
    heap: list = []
    queues = {k: [] for k in range(K) if is_q[k]}
    # busy count per queue station: jobs in service, <= servers[k] (matches
    # the simulator's busy-count semantics; c-server FCFS).
    busy = {k: 0 for k in range(K) if is_q[k]}
    # outstanding-miss table: flow -> leader job; parked jobs ride along.
    leader: dict = {}
    parked: dict = {}  # flow -> [job ids]
    job_flow = [-1] * N
    job_branch = [0] * N
    job_pos = [0] * N
    for j in range(N):
        b = new_branch()
        job_branch[j] = b
        k = int(visits[b, 0])
        if tr is not None:
            tr.start(j, 0.0)
        heapq.heappush(heap, (sample(k), j, k))

    t = 0.0
    done = 0
    delayed = 0
    branch_done = [0] * B
    branch_delayed = [0] * B
    warm_target = int(n_requests * warmup_frac)
    warm_t = warm_c = None
    warm_d = 0
    warm_bd = [0] * B
    warm_bdel = [0] * B

    def complete(j: int, now: float, was_delayed: bool = False) -> None:
        """Finish j's request and start a fresh one at a think station."""
        nonlocal done, warm_c, warm_t, warm_d
        branch_done[job_branch[j]] += 1
        if was_delayed:
            branch_delayed[job_branch[j]] += 1
        if tr is not None:
            if was_delayed:  # the park visit ends with the fill, now
                parked_us = now - tr.enter_at(j, job_pos[j])
                tr.leave(j, job_pos[j], now)
                cls_j = CLS_DELAYED
            else:
                parked_us = 0.0
                cls_j = (CLS_MISS if branch_has_disk[job_branch[j]]
                         else CLS_HIT)
            tr.complete(j, job_branch[j], cls_j, job_pos[j] + 1, parked_us)
            tr.start(j, now)  # the fresh request enters its think station
        if sk is not None:  # delayed hits count as misses (miss branches)
            sk.done(now, job_branch[j],
                    is_hit=not branch_has_disk[job_branch[j]],
                    delayed=was_delayed)
        done += 1
        if warm_c is None and done >= warm_target:
            warm_c, warm_t, warm_d = done, now, delayed
            warm_bd[:] = branch_done
            warm_bdel[:] = branch_delayed
        b = new_branch()
        job_branch[j] = b
        job_pos[j] = 0
        k0 = int(visits[b, 0])
        heapq.heappush(heap, (now + sample(k0), j, k0))

    while done < n_requests:
        t, j, k = heapq.heappop(heap)
        if tr is not None:  # j's service at its current visit ends now
            tr.leave(j, job_pos[j], t)

        # MSHR fill: j's fetch landed — wake everyone parked on its flow.
        if coalesce_flows and disk_rank[k] >= 0 and job_flow[j] >= 0:
            f = job_flow[j]
            for w in parked.pop(f, []):
                delayed += 1
                job_flow[w] = -1
                complete(w, t, was_delayed=True)
            del leader[f]
            job_flow[j] = -1

        if is_q[k]:
            if queues[k]:
                w = queues[k].pop(0)  # waiter takes over the freed server
                heapq.heappush(heap, (t + sample(k), w, k))
            else:
                busy[k] -= 1
        b = job_branch[j]
        pos = job_pos[j] + 1
        if pos >= visits.shape[1] or visits[b, pos] < 0:
            complete(j, t)
            continue
        job_pos[j] = pos
        if tr is not None:  # j enters its next visit now (queue, park or svc)
            tr.enter(j, pos, t)
        k2 = int(visits[b, pos])
        if coalesce_flows and disk_rank[k2] >= 0:
            # flows are local to the disk (shard) the miss arrives at
            f = int(disk_rank[k2]) * F + sample_flow()
            job_flow[j] = f
            if sk is not None:  # every disk arrival, park or lead
                sk.key(f)
            if f in leader:  # fetch already in flight: park, no new I/O
                parked.setdefault(f, []).append(j)
                continue
            leader[f] = j
        if is_q[k2]:
            if busy[k2] >= servers[k2]:
                queues[k2].append(j)
                continue
            busy[k2] += 1
        heapq.heappush(heap, (t + sample(k2), j, k2))

    n_meas = done - warm_c
    x = n_meas / (t - warm_t)
    if not full:
        return x
    return {
        "x": x,
        "delayed": delayed - warm_d,
        "delayed_frac": (delayed - warm_d) / n_meas,
        "branch_done": np.array(branch_done) - np.array(warm_bd),
        "branch_delayed": np.array(branch_delayed) - np.array(warm_bdel),
        "t_measured": t - warm_t,
        "warm_done": warm_c,
        "trace": tr.finish(visits) if tr is not None else None,
        "sketch": sk.estimates() if sk is not None else None,
    }


def _simulate_py_tiered(
    rng, is_q, visits, servers, sample, new_branch, sample_flow,
    tiers, coalesce_flows, mpl, n_requests, warmup_frac, full,
    branch_is_miss=None, trace: int = 0, sketch_cap: int = 0,
    window_us: float = 0.0,
):
    """Closed-loop heapq twin of simulator._simulate_tiered: cross-tier
    MSHR acquire/park/release driven by the MshrSpec annotation arrays,
    with cascading fills (a woken delayed hit frees its own held entries,
    recursively waking their followers at the same instant)."""
    acq_group = np.asarray(tiers.acq_group)
    acq_slot = np.asarray(tiers.acq_slot)
    rel_slot = np.asarray(tiers.rel_slot)
    max_held = int(tiers.max_held)
    F = coalesce_flows
    K = len(is_q)
    B = acq_group.shape[0]
    N = mpl

    heap: list = []
    queues = {k: [] for k in range(K) if is_q[k]}
    busy = {k: 0 for k in range(K) if is_q[k]}
    leader: dict = {}  # slot (group*F + f) -> leader job
    parked: dict = {}  # slot -> [(job, level)]
    job_flow = [-1] * N  # per-request flow, sampled at the first acquire
    job_held = [[-1] * max_held for _ in range(N)]
    job_branch = [0] * N
    job_pos = [0] * N
    tr = PyTraceCollector(trace, N, visits.shape[1]) if trace else None
    sk = (PyStreamSketch(sketch_cap, n_branches=B, window_us=window_us)
          if sketch_cap else None)
    for j in range(N):
        b = new_branch()
        job_branch[j] = b
        k = int(visits[b, 0])
        if tr is not None:
            tr.start(j, 0.0)
        heapq.heappush(heap, (sample(k), j, k))

    t = 0.0
    done = 0
    delayed = 0
    delayed_lvl = [0] * max_held
    branch_done = [0] * B
    branch_delayed = [0] * B
    warm_target = int(n_requests * warmup_frac)
    warm_t = warm_c = None
    warm_d = 0
    warm_dlvl = [0] * max_held
    warm_bd = [0] * B
    warm_bdel = [0] * B

    def complete(j: int, now: float, was_delayed: bool = False) -> None:
        nonlocal done, warm_c, warm_t, warm_d
        branch_done[job_branch[j]] += 1
        if was_delayed:
            branch_delayed[job_branch[j]] += 1
        if tr is not None:
            if was_delayed:  # the park visit ends with the fill, now
                parked_us = now - tr.enter_at(j, job_pos[j])
                tr.leave(j, job_pos[j], now)
                cls_j = CLS_DELAYED
            else:
                parked_us = 0.0
                cls_j = (CLS_MISS if branch_is_miss[job_branch[j]]
                         else CLS_HIT)
            tr.complete(j, job_branch[j], cls_j, job_pos[j] + 1, parked_us)
            tr.start(j, now)
        if sk is not None:  # delayed hits count as misses (miss branches)
            sk.done(now, job_branch[j],
                    is_hit=not branch_is_miss[job_branch[j]],
                    delayed=was_delayed)
        done += 1
        if warm_c is None and done >= warm_target:
            warm_c, warm_t, warm_d = done, now, delayed
            warm_dlvl[:] = delayed_lvl
            warm_bd[:] = branch_done
            warm_bdel[:] = branch_delayed
        job_flow[j] = -1
        b = new_branch()
        job_branch[j] = b
        job_pos[j] = 0
        k0 = int(visits[b, 0])
        heapq.heappush(heap, (now + sample(k0), j, k0))

    def free_slot(slot: int, now: float) -> None:
        """The fill for ``slot`` landed: retire the leader entry and
        complete everyone parked on it as delayed hits; their own held
        entries are fills that just landed too — free them recursively
        (strictly shallower levels, so the recursion is bounded)."""
        nonlocal delayed
        leader.pop(slot, None)
        for w, lvl in parked.pop(slot, []):
            delayed += 1
            delayed_lvl[lvl] += 1
            held_w = job_held[w]
            job_held[w] = [-1] * max_held
            complete(w, now, was_delayed=True)
            for sl in held_w:
                if sl >= 0:
                    free_slot(sl, now)

    while done < n_requests:
        t, j, k = heapq.heappop(heap)
        if tr is not None:
            tr.leave(j, job_pos[j], t)

        # fill: completing this visit may release one of j's held entries.
        b = job_branch[j]
        rel = int(rel_slot[b, job_pos[j]])
        if rel >= 0 and job_held[j][rel] >= 0:
            slot = job_held[j][rel]
            job_held[j][rel] = -1
            free_slot(slot, t)

        if is_q[k]:
            if queues[k]:
                w = queues[k].pop(0)
                heapq.heappush(heap, (t + sample(k), w, k))
            else:
                busy[k] -= 1
        pos = job_pos[j] + 1
        if pos >= visits.shape[1] or visits[b, pos] < 0:
            complete(j, t)
            continue
        job_pos[j] = pos
        if tr is not None:
            tr.enter(j, pos, t)
        k2 = int(visits[b, pos])
        g = int(acq_group[b, pos])
        if g >= 0:
            if job_flow[j] < 0:
                job_flow[j] = sample_flow()
                if sk is not None:  # first (shallowest) acquire only
                    sk.key(job_flow[j])
            slot = g * F + job_flow[j]
            if slot in leader:  # fetch in flight: park across the tier
                parked.setdefault(slot, []).append(
                    (j, int(acq_slot[b, pos])))
                continue
            leader[slot] = j
            job_held[j][int(acq_slot[b, pos])] = slot
        if is_q[k2]:
            if busy[k2] >= servers[k2]:
                queues[k2].append(j)
                continue
            busy[k2] += 1
        heapq.heappush(heap, (t + sample(k2), j, k2))

    n_meas = done - warm_c
    x = n_meas / (t - warm_t)
    if not full:
        return x
    return {
        "x": x,
        "delayed": delayed - warm_d,
        "delayed_frac": (delayed - warm_d) / n_meas,
        "delayed_tier_frac": (np.array(delayed_lvl)
                              - np.array(warm_dlvl)) / n_meas,
        "branch_done": np.array(branch_done) - np.array(warm_bd),
        "branch_delayed": np.array(branch_delayed) - np.array(warm_bdel),
        "t_measured": t - warm_t,
        "warm_done": warm_c,
        "trace": tr.finish(visits) if tr is not None else None,
        "sketch": sk.estimates() if sk is not None else None,
    }


def _simulate_py_open(
    rng, is_q, svc, dist, cum, visits, servers, disk_rank, sample,
    new_branch, sample_flow, n_requests, warmup_frac, coalesce_flows,
    arrival_rate, max_in_system, burst=None, trace: int = 0,
    sketch_cap: int = 0, window_us: float = 0.0,
):
    """Open-loop heapq twin of simulator._simulate_open (same semantics:
    Poisson — or ON-OFF burst — arrivals into a bounded slot pool,
    sojourn + class records per completion, parked delayed hits completing
    at fill time, shard-local MSHR flow groups per disk station)."""
    K = len(is_q)
    N = max_in_system
    F = max(coalesce_flows, 1)
    vis_rank = disk_rank[np.maximum(visits, 0)]
    branch_has_disk = ((vis_rank >= 0) & (visits >= 0)).any(axis=1)
    use_burst = burst is not None
    if use_burst:
        duty, mean_on_us = float(burst[0]), float(burst[1])
        if not 0.0 < duty <= 1.0 or mean_on_us <= 0.0:
            raise ValueError(f"burst=(duty, mean_on_us) needs 0<duty<=1 and "
                             f"mean_on_us>0, got {burst}")
        mean_off_us = mean_on_us * (1.0 - duty) / duty
        on_rate = arrival_rate / duty
        phase_on = True
        arr_gen = 0  # invalidates pending arrivals across OFF periods

    heap: list = []  # (t, j, k); j == -1 arrival, j == -2 phase toggle
    queues = {k: [] for k in range(K) if is_q[k]}
    busy = {k: 0 for k in range(K) if is_q[k]}
    leader: dict = {}
    parked: dict = {}
    job_flow = [-1] * N
    job_branch = [0] * N
    job_pos = [0] * N
    arrive_t = [0.0] * N
    free = list(range(N))
    tr = PyTraceCollector(trace, N, visits.shape[1]) if trace else None
    sk = (PyStreamSketch(sketch_cap, n_branches=len(cum),
                         window_us=window_us) if sketch_cap else None)

    records: list = []  # (sojourn, class) in completion order
    done = 0
    delayed = 0
    dropped = 0
    warm_target = int(n_requests * warmup_frac)
    warm_c = warm_t = None

    def record(j: int, now: float, c: int) -> None:
        nonlocal done, warm_c, warm_t
        if tr is not None:
            if c == CLS_DELAYED:  # the park visit ends with the fill, now
                parked_us = now - tr.enter_at(j, job_pos[j])
                tr.leave(j, job_pos[j], now)
            else:
                parked_us = 0.0
            tr.complete(j, job_branch[j], c, job_pos[j] + 1, parked_us)
        if sk is not None:  # delayed hits count as misses (miss branches)
            sk.done(now, job_branch[j], is_hit=(c == CLS_HIT),
                    delayed=(c == CLS_DELAYED))
        done += 1
        records.append((now - arrive_t[j], c))
        free.append(j)
        if warm_c is None and done >= warm_target:
            warm_c, warm_t = done, now

    if use_burst:
        heapq.heappush(heap, (rng.expovariate(on_rate), -1, arr_gen))
        heapq.heappush(heap, (rng.expovariate(1.0 / mean_on_us), -2, 0))
    else:
        heapq.heappush(heap, (rng.expovariate(arrival_rate), -1, -1))
    t = 0.0
    while done < n_requests:
        t, j, k = heapq.heappop(heap)

        if j == -2:  # ON/OFF phase toggle
            phase_on = not phase_on
            if phase_on:
                heapq.heappush(heap, (t + rng.expovariate(on_rate), -1,
                                      arr_gen))
                heapq.heappush(heap, (t + rng.expovariate(1.0 / mean_on_us),
                                      -2, 0))
            else:
                arr_gen += 1  # invalidate the arrival pending from ON
                off = (rng.expovariate(1.0 / mean_off_us)
                       if mean_off_us > 0.0 else 0.0)
                heapq.heappush(heap, (t + off, -2, 0))
            continue

        if j == -1:  # arrival
            if use_burst:
                if k != arr_gen:  # pending arrival from a closed ON period
                    continue
                heapq.heappush(heap, (t + rng.expovariate(on_rate), -1,
                                      arr_gen))
            else:
                heapq.heappush(heap, (t + rng.expovariate(arrival_rate),
                                      -1, -1))
            if sk is not None:  # every offered arrival, admitted or not
                sk.arrival(t)
            if not free:
                dropped += 1
                continue
            s = free.pop(0)
            b = new_branch()
            job_branch[s] = b
            job_pos[s] = 0
            arrive_t[s] = t
            if tr is not None:
                tr.start(s, t)
            k0 = int(visits[b, 0])  # think station by network validation
            heapq.heappush(heap, (t + sample(k0), s, k0))
            continue

        if tr is not None:  # j's service at its current visit ends now
            tr.leave(j, job_pos[j], t)

        # MSHR fill: parked delayed hits complete with the fill.
        if coalesce_flows and disk_rank[k] >= 0 and job_flow[j] >= 0:
            f = job_flow[j]
            for w in parked.pop(f, []):
                delayed += 1
                job_flow[w] = -1
                record(w, t, CLS_DELAYED)
            del leader[f]
            job_flow[j] = -1

        if is_q[k]:
            if queues[k]:
                w = queues[k].pop(0)
                heapq.heappush(heap, (t + sample(k), w, k))
            else:
                busy[k] -= 1
        b = job_branch[j]
        pos = job_pos[j] + 1
        if pos >= visits.shape[1] or visits[b, pos] < 0:
            record(j, t, CLS_MISS if branch_has_disk[b] else CLS_HIT)
            continue
        job_pos[j] = pos
        if tr is not None:
            tr.enter(j, pos, t)
        k2 = int(visits[b, pos])
        if coalesce_flows and disk_rank[k2] >= 0:
            f = int(disk_rank[k2]) * F + sample_flow()
            job_flow[j] = f
            if sk is not None:  # every disk arrival, park or lead
                sk.key(f)
            if f in leader:
                parked.setdefault(f, []).append(j)
                continue
            leader[f] = j
        if is_q[k2]:
            if busy[k2] >= servers[k2]:
                queues[k2].append(j)
                continue
            busy[k2] += 1
        heapq.heappush(heap, (t + sample(k2), j, k2))

    n_meas = done - warm_c
    soj = np.array([r[0] for r in records[warm_c:]])
    cls = np.array([r[1] for r in records[warm_c:]])
    class_frac = np.array([(cls == c).mean() for c in range(3)])
    class_soj = np.array([
        soj[cls == c].mean() if (cls == c).any() else np.nan
        for c in range(3)
    ])
    return {
        "x": n_meas / (t - warm_t),
        "sojourn_mean": float(soj.mean()),
        "sojourn_p50": float(np.percentile(soj, 50)),
        "sojourn_p99": float(np.percentile(soj, 99)),
        "class_frac": class_frac,
        "class_sojourn": class_soj,
        "delayed_frac": float((cls == CLS_DELAYED).mean()),
        "dropped": dropped,
        "drop_frac": dropped / max(done + dropped, 1),
        "warm_done": warm_c,
        "trace": tr.finish(visits) if tr is not None else None,
        "sketch": sk.estimates() if sk is not None else None,
    }
