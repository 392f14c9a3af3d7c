"""Event-driven simulation of the queueing networks — prong B
(port of ``repro.core.simulator.simulate_network``).

The **closed loop**: exactly ``mpl`` jobs, think stations infinite-server,
queue stations c-server FCFS, a completed request re-entering at once
with a fresh branch.  Every mode below may be traced as well (``trace=K``:
per-request records, :mod:`repro_torch.obs`).  With ``coalesce_flows > 0`` misses coalesce on
an MSHR-style outstanding-miss table (delayed hits): a job arriving at a
disk station whose flow already has a fetch in flight parks, holds no
server, and completes when the fill lands.  With ``tiers`` (an
:class:`~repro_torch.core.simspec.MshrSpec`) the tables are cross-tier:
acquire and release points come from the annotation arrays, and fills
cascade across tiers.

The **open loop** (``arrival_rate`` set): Poisson arrivals (or ON-OFF
bursts, ``burst``) into a pool of ``max_in_system`` job slots; every
completion records its sojourn and class, and the result is an
:class:`OpenSimResult` of response-time statistics.

The whole (p_hit x seed) grid is one launch of the event-sim kernel
(:mod:`repro_torch.kernels.event_sim`) on the card, or its plain version
on the CPU.  Its counter-based RNG is the one of the reference's
``backend="pallas"`` engine, so the closed loop without coalescing agrees
statistically with the reference's threefry engine and exactly with its
pallas engine on deterministic service.  The reference runs coalescing,
the tiered tables and the open loop only on its threefry engine; the
port runs them on its counter engine, so they agree with the reference
statistically.

In every mode ``sketch_cap > 0`` runs the streaming estimators
(:mod:`repro_torch.obs.streaming`) inside the launch, the sketched
instantiation of the kernel, and decodes them onto the result's
``sketches``; the sketch draws no random numbers, so every other output is
the unsketched run's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np

from repro_torch.core.queueing import ClosedNetwork
from repro_torch.core.simspec import (BIG_SEQ, INF_NS, SimResult, SimSpec,
                                      compile_network, stack_specs)
from repro_torch.kernels.event_sim import open_grid, simulate_grid
from repro_torch.obs.streaming import decode_sketch_grid
from repro_torch.obs.trace import (CLS_DELAYED, CLS_HIT, CLS_MISS,
                                   decode_trace_grid)

__all__ = ["BIG_SEQ", "INF_NS", "SimResult", "SimSpec", "OpenSimResult",
           "CLS_MISS", "CLS_HIT", "CLS_DELAYED", "compile_network",
           "stack_specs", "simulate_network"]


@dataclasses.dataclass(frozen=True)
class OpenSimResult:
    """Open-loop (arrival-driven) simulation result — the latency prong.

    All sojourn statistics are computed over post-warmup completions;
    percentiles pool the per-request records of every seed, while
    ``sojourn_ci95`` is the seed-to-seed CI of the mean.  ``class_*``
    columns are indexed [true miss, true hit, delayed hit] (the
    :data:`CLS_MISS`/:data:`CLS_HIT`/:data:`CLS_DELAYED` order, matching
    the prong-C classifier); ``class_sojourn`` is NaN for an empty class.
    The reference's fields, in its order.
    """

    p_hit: np.ndarray
    arrival_rate: np.ndarray  # (P,) offered rate, requests/µs
    throughput: np.ndarray  # measured completion rate (== arrival_rate
    ci95: np.ndarray        # when stable and drop-free)
    sojourn_mean: np.ndarray  # (P,) µs
    sojourn_ci95: np.ndarray
    sojourn_p50: np.ndarray
    sojourn_p99: np.ndarray
    class_frac: np.ndarray  # (P, 3)
    class_sojourn: np.ndarray  # (P, 3) mean µs per class
    delayed_frac: np.ndarray
    drop_frac: np.ndarray  # arrivals refused for want of a job slot
    # lanes that exhausted the event budget before completing n_requests
    # (deep overload): their statistics cover fewer completions than asked.
    truncated: np.ndarray
    n_requests: int
    # decoded per-lane trace records ([seed][p] TraceRecords) when
    # trace=K was asked; decoded per-lane streaming estimators ([seed][p]
    # SketchEstimates) when sketch_cap=K was asked.
    traces: list | None = None
    sketches: list | None = None


def simulate_network(
    net: ClosedNetwork,
    p_hits,
    n_requests: int = 40_000,
    seeds=(0, 1, 2),
    warmup_frac: float = 0.25,
    coalesce_flows: int = 0,
    coalesce_theta: float = 0.0,
    arrival_rate=None,
    max_in_system: int = 128,
    burst=None,
    backend: str = "pallas",
    tiers=None,
    trace: int = 0,
    sketch_cap: int = 0,
    window_us: float = 0.0,
    device: str = "cuda",
):
    """Simulate ``net`` over a grid of hit ratios.

    The full (p_hit x seed) grid runs as ONE launch: the per-p_hit specs
    are tiled across seeds so every (p, seed) cell is an independent lane
    (lane seed ``seed*1000 + p_index``), and statistics are measured after
    the first ``warmup_frac`` of the ``n_requests`` completions.

    Closed loop (``arrival_rate=None``): each lane stops after
    ``n_requests`` completions (or ``n_requests * (Lr + 2) * 3`` events);
    returns a :class:`SimResult` with the mean throughput (requests/µs)
    and its CI95 half-width across seeds.  ``trace=K`` keeps the last K
    per-request trace records of every lane (the traced kernel), in every
    mode below as well, and decodes them onto the result's ``traces``,
    ``[seed][p]``; the statistics are the untraced run's bit for bit.
    With coalescing the jobs a fill wakes are records of class delayed,
    each ``parked_us`` after it parked; in the open loop a record's
    ``req`` is its completion index.

    ``coalesce_flows > 0`` turns on miss coalescing: a job arriving at a
    disk station samples one of ``coalesce_flows`` hot keys of its disk
    group (Zipf(``coalesce_theta``)-weighted when it is > 0); if a fetch
    for that key is in flight it parks and completes, as a delayed hit,
    when the fill lands.  The result then carries ``delayed_frac``,
    ``branch_throughput`` and ``branch_delayed``.  0 runs the closed loop
    without any coalescing code, bit-identical to the port without it.

    ``arrival_rate`` (a scalar, or one rate per ``p_hits`` entry, in
    requests/µs) switches to the **open loop**: arrivals into a pool of
    ``max_in_system`` slots, returning an :class:`OpenSimResult`.
    ``burst=(duty, mean_on_us)`` makes the arrivals an ON-OFF process of
    the same mean rate: exponential ON periods of mean ``mean_on_us`` µs
    at ``arrival_rate / duty``, separated by arrival-free OFF periods.

    ``tiers`` (a :class:`~repro_torch.core.simspec.MshrSpec`, built by
    :func:`repro_torch.hierarchy.compose_tiers`) switches the MSHR tables
    to **cross-tier** leader tables: acquire, park and release points come
    from the per-(branch, position) annotation arrays instead of the
    disk ranks, an L1 miss can park behind its client's in-flight L2
    fetch *or*, leading there, behind a shard-local in-flight origin
    fetch, and fills cascade across tiers (the event-sim kernel's tiered
    instantiation).  It needs ``coalesce_flows > 0`` to do anything; with
    0 the annotations are ignored, as in the reference.  Closed loop
    only: with ``arrival_rate`` it raises :class:`ValueError`.  The
    result then carries ``delayed_tier_frac`` — delayed hits split by the
    tier level parked at (column 0: client-local L1 table; later:
    shard-local origin tables).

    ``sketch_cap > 0`` threads the streaming estimators
    (:mod:`repro_torch.obs.streaming`) through every lane, in every mode:
    tumbling-window hit/arrival counters, EWMA smoothers, and a count-min
    + SpaceSaving key-popularity sketch sized for ``sketch_cap`` tracked
    keys, sampled every ``window_us`` µs of simulated time (required > 0).
    The decoded ``[seed][p]``
    :class:`~repro_torch.obs.streaming.SketchEstimates` land on the
    result's ``sketches`` field; ``sketch_cap=0`` (default) runs no sketch
    code at all, and the estimators draw no random numbers.

    The keywords are the reference's.  ``backend`` names the engine: the
    port has one, the reference's counter-RNG ``"pallas"`` engine, so that
    is its default and ``"jax"`` (the reference's threefry engine) raises
    :class:`ValueError`.
    """
    if backend not in ("jax", "pallas"):
        raise ValueError(f"unknown backend {backend!r} (want 'jax' or "
                         "'pallas')")
    if backend == "jax":
        raise ValueError("backend='jax' is the reference's threefry engine, "
                         "which the port does not have: its one engine is "
                         "the counter-RNG engine of backend='pallas'")
    if tiers is not None and arrival_rate is not None:
        raise ValueError("tiered MSHR coalescing runs the closed loop only "
                         "(no arrival_rate/burst)")
    if tiers is not None and not coalesce_flows:
        tiers = None  # the annotations only size flow groups
    if tiers is not None:
        tiers.validate(compile_network(net, float(np.atleast_1d(p_hits)[0]),
                                       device="cpu").visits.numpy())
    if sketch_cap and window_us <= 0.0:
        raise ValueError("sketch_cap > 0 requires window_us > 0 (the "
                         "tumbling-window width in simulated µs)")
    if arrival_rate is None:
        if burst is not None:
            raise ValueError("burst arrivals require arrival_rate "
                             "(open-loop mode)")
        return simulate_grid(net, p_hits, n_requests=n_requests, seeds=seeds,
                             warmup_frac=warmup_frac, trace=trace,
                             coalesce_flows=coalesce_flows,
                             coalesce_theta=coalesce_theta, tiers=tiers,
                             sketch_cap=sketch_cap, window_us=window_us,
                             device=device)
    return _simulate_open(net, p_hits, arrival_rate, n_requests, seeds,
                          warmup_frac, max_in_system, burst, coalesce_flows,
                          coalesce_theta, sketch_cap, window_us, device,
                          int(trace))


def _simulate_open(net, p_hits, arrival_rate, n_requests, seeds,
                   warmup_frac, max_in_system, burst, coalesce_flows,
                   coalesce_theta, sketch_cap, window_us, device,
                   trace=0) -> OpenSimResult:
    """The open-loop grid and the reference's reduction of its records."""
    p_hits = np.atleast_1d(np.asarray(p_hits, dtype=np.float64))
    n_p, n_s = len(p_hits), len(seeds)
    lam = np.broadcast_to(np.asarray(arrival_rate, dtype=np.float64),
                          (n_p,)).copy()
    if np.any(lam <= 0.0):
        raise ValueError("arrival_rate must be > 0")
    if burst is not None:
        duty, mean_on_us = float(burst[0]), float(burst[1])
        if not 0.0 < duty <= 1.0 or mean_on_us <= 0.0:
            raise ValueError(f"burst=(duty, mean_on_us) needs 0<duty<=1 and "
                             f"mean_on_us>0, got {burst}")
    out = open_grid(net, p_hits, lam, n_requests, seeds, warmup_frac,
                    max_in_system, burst=burst,
                    coalesce_flows=int(coalesce_flows),
                    coalesce_theta=float(coalesce_theta),
                    sketch_cap=int(sketch_cap), window_us=float(window_us),
                    device=device, trace=trace)
    res = open_result(out, p_hits, lam, n_requests, n_s,
                      int(n_requests * warmup_frac))
    if out.rings is not None:
        visits = compile_network(net, float(p_hits[0]), device="cpu").visits
        res = dataclasses.replace(res, traces=decode_trace_grid(
            out.rings, visits, n_s, n_p))
    if out.sketch is not None:
        res = dataclasses.replace(res, sketches=decode_sketch_grid(
            out.sketch, n_s, n_p, float(window_us)))
    return res


def open_result(out, p_hits, lam, n_requests: int, n_s: int,
                warmup: int) -> OpenSimResult:
    """The reference's reduction of the open-loop lanes ``out`` (an
    :class:`~repro_torch.kernels.event_sim.OpenLaneOutputs` of ``n_s *
    P`` lanes, lane ``s * P + p``) into an :class:`OpenSimResult`, on the
    host in numpy: percentiles over the pooled post-warmup records of
    every seed, the per-seed CI of the mean, class fractions and means,
    drops, and a ``RuntimeWarning`` for lanes that spent their event
    budget before ``n_requests`` completions."""
    n_p = len(p_hits)
    xs = out.x.cpu().numpy().reshape(n_s, n_p)
    comp = out.completed.cpu().numpy().reshape(n_s, n_p)
    dl = out.delayed_frac.cpu().numpy().reshape(n_s, n_p)
    drop = out.dropped.cpu().numpy().reshape(n_s, n_p)
    soj = out.sojourn_us.cpu().numpy().reshape(n_s, n_p, -1)
    cls = out.cls.cpu().numpy().reshape(n_s, n_p, -1)

    mean = np.empty(n_p)
    m_ci = np.empty(n_p)
    p50 = np.empty(n_p)
    p99 = np.empty(n_p)
    cfrac = np.zeros((n_p, 3))
    csoj = np.full((n_p, 3), np.nan)
    for i in range(n_p):
        pooled = []
        per_seed_mean = []
        for s in range(n_s):
            rec = soj[s, i, warmup:comp[s, i]]
            pooled.append(rec)
            per_seed_mean.append(rec.mean() if rec.size else np.nan)
        rec = np.concatenate(pooled)
        all_cls = np.concatenate(
            [cls[s, i, warmup:comp[s, i]] for s in range(n_s)])
        mean[i] = rec.mean() if rec.size else np.nan
        p50[i] = np.percentile(rec, 50) if rec.size else np.nan
        p99[i] = np.percentile(rec, 99) if rec.size else np.nan
        m_ci[i] = (1.96 * np.nanstd(per_seed_mean, ddof=1) / math.sqrt(n_s)
                   if n_s > 1 else 0.0)
        for c in range(3):
            sel = all_cls == c
            if rec.size:
                cfrac[i, c] = sel.mean()
            if sel.any():
                csoj[i, c] = rec[sel].mean()

    ci = (1.96 * xs.std(axis=0, ddof=1) / math.sqrt(n_s) if n_s > 1
          else np.zeros(n_p))
    total_arrivals = comp.sum(axis=0) + drop.sum(axis=0)
    truncated = (comp < n_requests).any(axis=0)
    if truncated.any():
        warnings.warn(
            "open-loop simulation exhausted its event budget before "
            f"completing n_requests at p_hit={p_hits[truncated]} "
            "(offered rate far past the stability boundary?); statistics "
            "cover fewer completions than requested", RuntimeWarning,
            stacklevel=4)
    return OpenSimResult(
        p_hit=p_hits, arrival_rate=lam, throughput=xs.mean(axis=0), ci95=ci,
        sojourn_mean=mean, sojourn_ci95=m_ci, sojourn_p50=p50,
        sojourn_p99=p99, class_frac=cfrac, class_sojourn=csoj,
        delayed_frac=dl.mean(axis=0),
        drop_frac=drop.sum(axis=0) / np.maximum(total_arrivals, 1),
        truncated=truncated, n_requests=n_requests)
