"""SLO-aware operating points: where should the hit ratio sit?

A copy of ``src/repro/latency/forecast.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

The closed-loop stack picks the *throughput-optimal* hit ratio p* (largest
p still achieving the peak bound).  An operator running against a latency
SLO cares about two different optima:

* the **latency-optimal** p — argmin of R(p, lambda) at the offered load;
* the **SLO-capacity-optimal** p — argmax of the largest arrival rate
  whose tail response still meets the SLO.

For FIFO-like policies all three coincide at p = 1 (hits are free, so more
hits always help).  For LRU-like policies they diverge: past the knee the
hit path's serialized metadata stations congest, so both the sustainable
rate and the response time get *worse* as the hit ratio rises — the
paper's inversion, restated in the units users feel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.queueing import ClosedNetwork
from repro_torch.latency.analytic import analyze_open, lambda_max

_REL_TOL = 1.0 - 1e-9  # "achieves the max" tolerance, as in ClosedNetwork.p_star


def max_arrival_for_slo(net: ClosedNetwork, p_hit: float, slo_us: float,
                        percentile: float = 0.99, tail_mode: str = "nominal",
                        iters: int = 50) -> float:
    """Largest Poisson arrival rate whose ``percentile`` sojourn meets the
    SLO at hit ratio ``p_hit``.  0 when even an empty system misses it
    (the no-wait response already exceeds ``slo_us``)."""
    if slo_us <= 0.0:
        raise ValueError("slo_us must be > 0")
    if analyze_open(net, p_hit, 0.0, tail_mode=tail_mode) \
            .percentile(percentile) > slo_us:
        return 0.0
    hi = lambda_max(net, p_hit, tail_mode=tail_mode)
    if math.isinf(hi):  # no queue demand: delay-only network meets any load
        return math.inf
    lo = 0.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        r = analyze_open(net, p_hit, mid, tail_mode=tail_mode)
        if r.stable and r.percentile(percentile) <= slo_us:
            lo = mid
        else:
            hi = mid
    return lo


@dataclasses.dataclass(frozen=True)
class LatencyForecast:
    """Grid forecast of the three operating points (see module docstring).

    ``lambda_max`` uses ``tail_mode="zero"`` so ``p_star_throughput``
    matches the closed-loop ``ClosedNetwork.p_star`` convention exactly;
    the response columns use the pessimistic ``"nominal"`` services.
    ``r_mean``/``r_tail`` are +inf where ``arrival_rate`` is unstable, and
    ``feasible`` marks grid points whose tail meets the SLO at that rate.
    """

    network: str
    arrival_rate: float
    slo_us: float
    percentile: float
    p_grid: np.ndarray
    lambda_max: np.ndarray
    r_mean: np.ndarray
    r_tail: np.ndarray
    slo_lambda: np.ndarray
    feasible: np.ndarray
    p_star_throughput: float
    p_star_latency: float
    p_star_slo: float
    # capacity (keys / pages) achieving each grid hit ratio, mapped
    # through the online ObservedProfile that drove the sweep; None for
    # plain (profile-free) forecasts.
    cap_grid: np.ndarray | None = None


def slo_forecast(net: ClosedNetwork, arrival_rate: float, slo_us: float,
                 percentile: float = 0.99, p_grid=None,
                 tail_mode: str = "nominal",
                 profile=None) -> LatencyForecast:
    """Sweep the hit ratio and report throughput-, latency- and
    SLO-capacity-optimal operating points for ``net``.

    ``p_star_latency`` follows the ``p_star`` convention (largest p still
    achieving the optimum — here the minimum mean response at
    ``arrival_rate``); NaN when the offered rate is unstable at every p.

    ``profile`` accepts an online measured profile (anything with the
    :class:`repro.obs.profile.ObservedProfile` surface — ``p_range()``
    and ``cap_of_p``): when ``p_grid`` is None the sweep is restricted
    to the profile's *achievable* hit-ratio range, and every grid point
    is annotated with the cache capacity achieving it on the result's
    ``cap_grid`` — turning the three p* answers into sizing answers.
    """
    if p_grid is None:
        if profile is not None:
            lo, hi = profile.p_range()
            p_grid = np.linspace(lo, min(hi, 1.0), 201)
        else:
            p_grid = np.linspace(0.0, 1.0, 201)
    p_grid = np.asarray(p_grid, dtype=np.float64)
    cap_grid = (np.array([profile.cap_of_p(float(p)) for p in p_grid])
                if profile is not None else None)

    lmax = lambda_max(net, p_grid, tail_mode="zero")
    # one open solve per grid point yields the mean AND the tail (the
    # OpenAnalysis carries the branch mixture), so mean/tail/feasibility
    # stay consistent by construction.
    solved = [analyze_open(net, float(p), arrival_rate, tail_mode=tail_mode)
              for p in p_grid]
    r_mean = np.array([a.mean for a in solved])
    r_tail = np.array([a.percentile(percentile) for a in solved])
    slo_lam = np.array([
        max_arrival_for_slo(net, float(p), slo_us, percentile=percentile,
                            tail_mode=tail_mode)
        for p in p_grid
    ])
    feasible = np.isfinite(r_tail) & (r_tail <= slo_us)

    def largest_at_max(values: np.ndarray, maximize: bool) -> float:
        vals = values if maximize else -values
        # +inf is a legitimate optimum (e.g. lambda_max with zero queue
        # demand — FIFO at p=1); -inf/NaN mark unstable points.
        if np.isposinf(vals).any():
            return float(p_grid[int(np.nonzero(np.isposinf(vals))[0][-1])])
        finite = np.isfinite(vals)
        if not finite.any():
            return math.nan
        best = float(np.max(vals[finite]))
        thresh = best * _REL_TOL if best > 0 else best - 1e-12
        at = np.nonzero(finite & (vals >= thresh))[0]
        return float(p_grid[int(at[-1])])

    return LatencyForecast(
        network=net.name,
        arrival_rate=float(arrival_rate),
        slo_us=float(slo_us),
        percentile=float(percentile),
        p_grid=p_grid,
        lambda_max=np.atleast_1d(lmax),
        r_mean=np.atleast_1d(r_mean),
        r_tail=np.atleast_1d(r_tail),
        slo_lambda=slo_lam,
        feasible=feasible,
        p_star_throughput=largest_at_max(np.atleast_1d(lmax), True),
        p_star_latency=largest_at_max(np.atleast_1d(r_mean), False),
        p_star_slo=largest_at_max(slo_lam, True),
        cap_grid=cap_grid,
    )
