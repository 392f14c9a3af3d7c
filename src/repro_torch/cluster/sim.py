"""Event-level cluster simulation: prong B lifted to N shards.

The port's copy of ``repro.cluster.sim`` (``src/repro/cluster/sim.py``).
Two differential twins:

* :func:`simulate_cluster` — the composed cluster network on the port's
  event-sim engine: the (global-p x seed) grid is ONE launch of the
  event-sim kernel on the card (its plain version on the CPU), with every
  shard's station set, disk and — when coalescing is on — its own MSHR
  flow group in each lane (``sK:disk`` stations each own a slice of the
  leader table, so delayed hits never coalesce across shards).
  Per-branch completion counters fold back into per-shard throughput /
  hit-ratio / delayed-hit breakdowns: with coalescing the coalescing
  kernel (``kFlows``) takes them, without it the counting kernel
  (``kCount``).  The reference runs this on its threefry engine, the
  port on its counter engine, so the two agree statistically.
* :func:`simulate_cluster_py` — an independent heapq oracle that does
  what a real router does: every request draws a *key* from the workload
  popularity, hashes it through the ring's assignment to pick its shard,
  and then walks that shard's station copies.  Per-shard traffic shares
  are never configured — they *emerge* from the key stream — which is
  what makes the oracle a genuine check of the simulator's
  weight-compiled branch probabilities.  It draws from
  ``random.Random(seed)`` in the reference's order and equals the
  reference's oracle exactly.

Both run the same closed loop (``mpl`` clients that immediately start a
new request on completion); open-loop cluster runs go straight through
``simulate_network(model.network, arrival_rate=...)``.

``sketch_cap > 0`` runs the streaming estimators on both: the simulator's
observe the coalescing flows (``simulate_network``'s sketch), the oracle's
exact twin counts the routed keys themselves.  ``trace > 0`` keeps
per-request records on both, with coalescing or without: one traced launch
of the coalescing kernel carries the records and the counts (without
coalescing, a traced closed launch beside the counting one).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import random

import numpy as np

from repro_torch.cluster.model import ClusterModel
from repro_torch.core.py_sim import _flow_sampler
from repro_torch.core.simspec import compile_network
from repro_torch.kernels.event_sim import simulate_grid
from repro_torch.obs.streaming import PyStreamSketch

__all__ = ["ClusterSimResult", "simulate_cluster", "simulate_cluster_py"]

@dataclasses.dataclass(frozen=True)
class ClusterSimResult:
    """Cluster-level and per-shard statistics over the global-p grid.

    ``shard_hit_ratio`` counts delayed hits as misses (they ride miss
    branches on both twins), matching the policy-level convention.
    Shards with no measured completions report NaN ratios.
    """

    p_hit: np.ndarray  # (P,) global hit-ratio grid
    throughput: np.ndarray  # (P,) cluster completions / µs
    ci95: np.ndarray  # (P,)
    shard_throughput: np.ndarray  # (P, N)
    shard_hit_ratio: np.ndarray  # (P, N)
    shard_delayed_frac: np.ndarray  # (P, N)
    delayed_frac: np.ndarray  # (P,)
    n_requests: int
    # [seed][p] per-request TraceRecords when trace=K was requested (the
    # record's branch id resolves to a shard via model.branch_shard).
    traces: list | None = None
    # [seed][p] SketchEstimates when sketch_cap=K was requested (flow keys
    # on the simulator's side; shard heat via SketchEstimates.shard_heat +
    # model.branch_shard).
    sketches: list | None = None


def simulate_cluster(model: ClusterModel, p_hits, n_requests: int = 40_000,
                     seeds=(0, 1, 2), warmup_frac: float = 0.25,
                     coalesce_flows: int = 0, coalesce_theta: float = 0.0,
                     trace: int = 0, sketch_cap: int = 0,
                     window_us: float = 0.0,
                     device: str = "cuda") -> ClusterSimResult:
    """Simulate the composed cluster over a grid of *global* hit ratios.

    ``coalesce_flows`` is the per-shard MSHR hot-flow count (each shard's
    disk owns its own flow group); ``trace=K`` keeps the last K
    per-request trace records per lane (see :mod:`repro_torch.obs.trace`;
    with coalescing, the jobs a fill wakes are delayed records).
    Everything else matches
    :func:`repro_torch.core.simulator.simulate_network`, whose grid this
    runs (:func:`repro_torch.kernels.event_sim.simulate_grid`, with the
    per-branch counts).  ``sketch_cap=K`` threads the streaming estimators
    (:mod:`repro_torch.obs.streaming`, windowed every ``window_us``
    simulated µs) onto ``sketches``.
    """
    if sketch_cap and window_us <= 0.0:
        raise ValueError("sketch_cap > 0 requires window_us > 0 (the "
                         "tumbling-window width in simulated µs)")
    res = simulate_grid(model.network, p_hits, n_requests=n_requests,
                        seeds=seeds, warmup_frac=warmup_frac, trace=trace,
                        coalesce_flows=coalesce_flows,
                        coalesce_theta=coalesce_theta, count_branches=True,
                        sketch_cap=sketch_cap, window_us=window_us,
                        device=device)
    return _shard_result(model, res)


def _shard_result(model: ClusterModel, res) -> ClusterSimResult:
    """Fold a simulation of ``model.network`` with per-branch rates
    (``res``, a :class:`~repro_torch.core.simspec.SimResult`) back into
    per-shard throughput, hit ratio and delayed fraction, as the
    reference's ``simulate_cluster`` does."""
    shard = np.asarray(model.branch_shard)
    is_hit = ~np.asarray(model.branch_has_disk)
    N = model.n_shards
    P = len(res.p_hit)
    sx = np.zeros((P, N))
    shit = np.full((P, N), np.nan)
    sdel = np.zeros((P, N))
    for k in range(N):
        sel = shard == k
        tot = res.branch_throughput[:, sel].sum(axis=1)
        hits = res.branch_throughput[:, sel & is_hit].sum(axis=1)
        dl = res.branch_delayed[:, sel].sum(axis=1)
        sx[:, k] = tot
        nz = tot > 0
        shit[nz, k] = hits[nz] / tot[nz]
        sdel[nz, k] = dl[nz] / tot[nz]
    return ClusterSimResult(
        p_hit=res.p_hit, throughput=res.throughput, ci95=res.ci95,
        shard_throughput=sx, shard_hit_ratio=shit, shard_delayed_frac=sdel,
        delayed_frac=res.delayed_frac, n_requests=res.n_requests,
        traces=res.traces, sketches=res.sketches,
    )


def simulate_cluster_py(model: ClusterModel, key_probs, assign,
                        p_hit: float, n_requests: int = 20_000,
                        seed: int = 0, warmup_frac: float = 0.25,
                        coalesce_flows: int = 0,
                        coalesce_theta: float = 0.0,
                        sketch_cap: int = 0,
                        window_us: float = 0.0) -> dict:
    """Key-routing heapq oracle for :func:`simulate_cluster` at one
    global hit ratio.

    ``model.network.mpl`` closed-loop clients; each fresh request samples
    a key from ``key_probs``, routes through ``assign`` (the hash ring's
    key → shard map), then samples a route of the *base* network at that
    shard's local hit ratio ``model.profile.shard_p(p_hit)[k]``.  Station
    state (c-server FCFS queues, bounded disks, MSHR flow groups) is kept
    per (shard, base-station) — fully shard-local, like the simulator.

    Returns a dict with cluster ``x``, per-shard ``shard_x`` /
    ``shard_hit_ratio`` / ``shard_delayed_frac``, measured ``shard_share``
    (the emergent routing weights), and ``delayed_frac``.

    ``sketch_cap > 0`` attaches the exact-counting estimator twin
    (:class:`repro_torch.obs.streaming.PyStreamSketch`): because this
    oracle is the one engine that sees *true workload keys* (not
    coalescing flows), its sketch counts the routed key stream itself —
    the decoded estimates under ``"sketch"`` feed
    :func:`repro_torch.obs.profile.observed_profile` /
    ``observed_shard_profile`` directly.  Branch lanes in its windowed
    per-branch counters are ``shard * B + base_branch`` (so
    ``SketchEstimates.shard_heat`` recovers per-shard completion heat
    with an ``assign`` of ``lane // B``).
    """
    rng = random.Random(seed)
    base = model.base
    pk = model.profile.shard_p(p_hit)
    N = model.n_shards
    assign = np.asarray(assign)
    key_cum = np.cumsum(np.asarray(key_probs, np.float64))
    key_cum = key_cum / key_cum[-1]

    specs = [compile_network(base, float(pk[k]), device="cpu")
             for k in range(N)]
    is_q = specs[0].is_queue.numpy()
    servers = specs[0].servers.numpy()
    disk_rank = specs[0].disk_rank.numpy()
    visits = np.stack([s.visits.numpy() for s in specs])  # (N, B, L)
    svc = np.stack([s.svc_ns.numpy() for s in specs]) / 1e3  # (N, K) µs
    dist = specs[0].dist_id.numpy()
    cum = np.stack([s.branch_cum.numpy() for s in specs])  # (N, B)
    B = cum.shape[1]
    hit_branch = ~(((disk_rank[np.maximum(visits[0], 0)] >= 0)
                    & (visits[0] >= 0)).any(axis=1))
    sample_flow = (_flow_sampler(rng, coalesce_flows, coalesce_theta)
                   if coalesce_flows else None)
    sk = (PyStreamSketch(sketch_cap, n_branches=N * B, window_us=window_us)
          if sketch_cap else None)

    def sample(sh: int, k: int) -> float:
        if dist[k] == 1:
            return svc[sh, k] * rng.expovariate(1.0)
        return float(svc[sh, k])

    def new_request() -> tuple:
        key = int(np.searchsorted(key_cum, rng.random()))
        sh = int(assign[key])
        b = int(np.searchsorted(cum[sh], rng.random()))
        if sk is not None:  # the true routed key, pre-hash
            sk.key(key)
        return sh, b

    M = model.network.mpl
    heap: list = []
    queues: dict = {}  # (shard, station) -> waiters
    busy: dict = {}  # (shard, station) -> in-service count
    leader: dict = {}  # (shard, flow) -> leading job
    parked: dict = {}  # (shard, flow) -> parked jobs
    job_shard = [0] * M
    job_branch = [0] * M
    job_pos = [0] * M
    job_flow: list = [None] * M

    done = 0
    delayed = 0
    sh_done = np.zeros(N, np.int64)
    sh_hit = np.zeros(N, np.int64)
    sh_del = np.zeros(N, np.int64)
    warm_target = int(n_requests * warmup_frac)
    warm = None  # (done, t, delayed, sh_done, sh_hit, sh_del)

    def complete(j: int, now: float, was_delayed: bool = False) -> None:
        nonlocal done, delayed, warm
        sh, b = job_shard[j], job_branch[j]
        if sk is not None:  # delayed hits count as misses (miss branches)
            sk.done(now, sh * B + b, is_hit=bool(hit_branch[b]),
                    delayed=was_delayed)
        done += 1
        sh_done[sh] += 1
        if hit_branch[b]:
            sh_hit[sh] += 1
        if was_delayed:
            delayed += 1
            sh_del[sh] += 1
        if warm is None and done >= warm_target:
            warm = (done, now, delayed, sh_done.copy(), sh_hit.copy(),
                    sh_del.copy())
        sh2, b2 = new_request()
        job_shard[j], job_branch[j], job_pos[j] = sh2, b2, 0
        k0 = int(visits[sh2, b2, 0])
        heapq.heappush(heap, (now + sample(sh2, k0), j, k0))

    for j in range(M):
        sh, b = new_request()
        job_shard[j], job_branch[j] = sh, b
        k0 = int(visits[sh, b, 0])
        heapq.heappush(heap, (sample(sh, k0), j, k0))

    t = 0.0
    while done < n_requests:
        t, j, k = heapq.heappop(heap)
        sh = job_shard[j]

        # MSHR fill: wake everything parked on this shard-local flow.
        if coalesce_flows and disk_rank[k] >= 0 and job_flow[j] is not None:
            f = job_flow[j]
            for w in parked.pop(f, []):
                job_flow[w] = None
                complete(w, t, was_delayed=True)
            del leader[f]
            job_flow[j] = None

        if is_q[k]:
            q = queues.get((sh, k))
            if q:
                w = q.pop(0)
                heapq.heappush(heap, (t + sample(sh, k), w, k))
            else:
                busy[(sh, k)] = busy.get((sh, k), 1) - 1
        b = job_branch[j]
        pos = job_pos[j] + 1
        if pos >= visits.shape[2] or visits[sh, b, pos] < 0:
            complete(j, t)
            continue
        job_pos[j] = pos
        k2 = int(visits[sh, b, pos])
        if coalesce_flows and disk_rank[k2] >= 0:
            f = (sh, int(disk_rank[k2]) * coalesce_flows + sample_flow())
            job_flow[j] = f
            if f in leader:
                parked.setdefault(f, []).append(j)
                continue
            leader[f] = j
        if is_q[k2]:
            if busy.get((sh, k2), 0) >= servers[k2]:
                queues.setdefault((sh, k2), []).append(j)
                continue
            busy[(sh, k2)] = busy.get((sh, k2), 0) + 1
        heapq.heappush(heap, (t + sample(sh, k2), j, k2))

    w_done, w_t, w_del, w_sd, w_sh, w_sdel = warm
    n_meas = done - w_done
    span = t - w_t
    sd = sh_done - w_sd
    shh = sh_hit - w_sh
    sdl = sh_del - w_sdel
    with np.errstate(invalid="ignore", divide="ignore"):
        hit_ratio = np.where(sd > 0, shh / np.maximum(sd, 1), math.nan)
        del_frac = np.where(sd > 0, sdl / np.maximum(sd, 1), 0.0)
    return {
        "x": n_meas / span,
        "shard_x": sd / span,
        "shard_share": sd / n_meas,
        "shard_hit_ratio": hit_ratio,
        "shard_delayed_frac": del_frac,
        "delayed_frac": (delayed - w_del) / n_meas,
        "sketch": sk.estimates() if sk is not None else None,
    }
