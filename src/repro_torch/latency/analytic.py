"""Open queueing-network response-time analysis — the analytic latency prong.

A copy of ``src/repro/latency/analytic.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

The closed-loop model (:mod:`repro_torch.core.queueing`) fixes the *population*
(MPL) and solves for throughput; response time only appears as the cycle
time N/X.  Real cache front-ends are open-loop: requests arrive at some
rate lambda regardless of how many are already in the system, and the
quantity that matters is the *sojourn* (response) time R(p, lambda).

This module evaluates the same :class:`~repro_torch.core.queueing.ClosedNetwork`
definitions (stations, branches, p_hit-parameterized services and
probabilities — the MPL field is simply ignored) as an open Jackson/BCMP
network under Poisson(lambda) arrivals:

* **think stations** (infinite-server): pure delay, per-visit sojourn equals
  the mean service time regardless of load or distribution.
* **queue stations** (c-server FCFS): per-visit sojourn is the M/M/c value
  ``S + C(c, a) * S / (c - a)`` with offered load ``a = lambda_k * S`` and
  ``C`` the Erlang-C waiting probability.  For the exponential analogue of
  a network this is exact (BCMP: FCFS stations with class-independent
  exponential service); for the paper's det/pareto services it is the same
  kind of insensitivity approximation the closed-loop MVA already leans on.

The **stability boundary** ``lambda_max(p) = min_k c_k / D_k`` is exactly
the saturated term of the closed-loop Thm-7.1 bound, so the open-loop
knee — the hit ratio beyond which the sustainable arrival rate *drops* —
coincides with the closed-loop p*.  That is the paper's phenomenon restated
in latency terms: past the knee, a higher hit ratio buys you a *lower*
ceiling and, at fixed lambda, a *longer* response time.

Tails are a per-branch **moment-matched phase-type mixture**: each
branch's sojourn is a sum of per-visit components (deterministic or
exponential think stages, M/M/c waits + exponential services), so its
first two moments are known in closed form; the branch tail is the
gamma / generalized-Erlang distribution matching them — the continuous
interpolation of the equal-rate hypoexponential (Erlang-k) family, with
``cv² = 1`` collapsing to the exponential exactly.  The overall sojourn
CDF is the probability-weighted mixture over branches.  For a
single-visit M/M/1 route the branch sojourn is exactly exponential and
the fit is exact; for multi-visit routes the old per-branch exponential
tail (still available as ``tail="exp"``) badly inflates p99 when a
branch is a sum of many comparable stages — the miss path's 100µs disk
stage plus sub-µs metadata visits has ``cv² ≪ 1``, nothing like an
exponential.  Units are microseconds and requests/µs throughout,
matching :mod:`repro_torch.core.queueing`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.queueing import QUEUE, ClosedNetwork


def erlang_c(c: int, a: float) -> float:
    """Erlang-C waiting probability P{wait > 0} for M/M/c at offered load
    ``a = lambda * S`` erlangs.  Requires ``a < c`` (an overloaded queue
    has no steady state); the Erlang-B recursion keeps it numerically
    stable for large ``c``."""
    if a <= 0.0:
        return 0.0
    if c < 1:
        raise ValueError("c must be >= 1")
    if a >= c:
        raise ValueError(f"offered load a={a} must be < c={c} servers")
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho * (1.0 - b))


def _gammainc_reg(s: float, x: float) -> float:
    """Regularized lower incomplete gamma P(s, x) — series for x < s+1,
    Lentz continued fraction otherwise (Numerical Recipes 6.2).  Above
    shape 50 the series/CF need O(sqrt(s))..O(s) terms, so the
    Wilson-Hilferty cube-root normal approximation takes over (abs error
    < ~1e-4 there — far below the tail model's own error), keeping each
    CDF evaluation O(1) inside the percentile/SLO bisections."""
    if x <= 0.0:
        return 0.0
    if s > 50.0:
        z = ((x / s) ** (1.0 / 3.0) - (1.0 - 1.0 / (9.0 * s))) \
            * 3.0 * math.sqrt(s)
        return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    lg = math.lgamma(s)
    pref = math.exp(-x + s * math.log(x) - lg)
    if x < s + 1.0:
        term = 1.0 / s
        total = term
        n = 0
        while n < 100_000:
            n += 1
            term *= x / (s + n)
            total += term
            if term < total * 1e-13:
                break
        return min(1.0, total * pref)
    tiny = 1e-300
    b = x + 1.0 - s
    c = 1.0 / tiny
    d = 1.0 / b if b != 0.0 else 1.0 / tiny
    h = d
    for i in range(1, 100_000):
        an = -i * (i - s)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-13:
            break
    return max(0.0, min(1.0, 1.0 - pref * h))


def _branch_cdf(t: float, mean: float, var: float) -> float:
    """Moment-matched branch sojourn CDF at ``t``.

    gamma(shape m²/v, scale v/m): shape 1 == exponential (single M/M/1
    visit — exact), integer shapes == Erlang == equal-rate
    hypoexponential, shape < 1 covers the heavy low-utilization M/M/c
    wait mixtures (cv² > 1).  Degenerate variance (an all-deterministic
    route) is a step at the mean."""
    if mean <= 0.0:
        return 1.0
    shape = mean * mean / var if var > 0.0 else math.inf
    if shape > 1e6:  # numerically deterministic
        return 1.0 if t >= mean else 0.0
    return _gammainc_reg(shape, t * shape / mean)


def _mixture_quantile(comps, q: float) -> float:
    """Bisect the branch-mixture CDF; ``comps`` rows are (prob, mean, cdf)."""
    def cdf(t: float) -> float:
        return sum(pb * f(t) for pb, _, f in comps)

    hi = max(rb for _, rb, _ in comps) + 1e-12
    while cdf(hi) < q:
        hi *= 2.0
    lo = 0.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < q:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-9 * hi:
            break
    return 0.5 * (lo + hi)


def lambda_max(net: ClosedNetwork, p_hit, tail_mode: str = "zero"):
    """Open-loop stability boundary: the largest Poisson arrival rate the
    network can sustain at hit ratio p, ``min_k c_k / D_k`` over queue
    stations.  This is exactly the saturated (second) term of the
    closed-loop Thm-7.1 bound, so its knee recovers the closed-loop p*.
    Vectorized over ``p_hit``; +inf for a network with no queue demand."""
    servers = net.queue_servers()
    p_arr = np.atleast_1d(np.asarray(p_hit, dtype=np.float64))
    out = np.empty_like(p_arr)
    for i, p in enumerate(p_arr):
        d = net.demands(float(p), tail_mode=tail_mode)
        terms = [servers[k] / dk for k, dk in d.items() if dk > 0.0]
        out[i] = min(terms) if terms else math.inf
    return out if np.ndim(p_hit) else float(out[0])


@dataclasses.dataclass(frozen=True)
class OpenAnalysis:
    """One (p_hit, lambda) operating point of the open network.

    ``station_time`` maps each station to its per-visit sojourn (wait +
    service); ``branches`` carries (name, probability, mean response,
    response variance) per route — the moment-matched mixture components
    behind :meth:`percentile`.  An unstable point (some queue station
    with offered load >= c) has ``stable=False`` and infinite means.
    """

    p_hit: float
    arrival_rate: float
    stable: bool
    mean: float
    utilization: Dict[str, float]
    station_time: Dict[str, float]
    branches: Tuple[tuple, ...]  # (name, prob, mean_response, var_response)

    def percentile(self, q: float = 0.99, tail: str = "hypo") -> float:
        """Sojourn-time percentile, solved by bisection on the mixture CDF.

        ``tail="hypo"`` (default): each branch uses the moment-matched
        gamma / generalized-Erlang tail (the equal-rate hypoexponential
        family, continuously interpolated) fitted to the branch's exact
        first two moments — exact for a single M/M/1 visit (cv² = 1 →
        exponential) and far tighter than the exponential at high
        utilization, where a branch is a sum of many stages.
        ``tail="exp"`` keeps the legacy per-branch exponential mixture
        for comparison.
        """
        if not 0.0 < q < 1.0:
            raise ValueError("percentile q must be in (0, 1)")
        if tail not in ("hypo", "exp"):
            raise ValueError(f"unknown tail {tail!r} (want 'hypo' or 'exp')")
        if not self.stable:
            return math.inf
        if tail == "exp":
            comps = [
                (pb, rb,
                 (lambda t, rb=rb: -math.expm1(-t / rb)) if rb > 0.0
                 else (lambda t: 1.0))
                for _, pb, rb, _ in self.branches if pb > 0.0
            ]
        else:
            comps = [
                (pb, rb, (lambda t, rb=rb, vb=vb: _branch_cdf(t, rb, vb)))
                for _, pb, rb, vb in self.branches if pb > 0.0
            ]
        if not comps:
            return 0.0
        return _mixture_quantile(comps, q)


def analyze_open(net: ClosedNetwork, p_hit: float, arrival_rate: float,
                 tail_mode: str = "nominal") -> OpenAnalysis:
    """Solve the open network at one (p_hit, lambda) point.

    ``tail_mode`` follows the closed-loop convention: ``"nominal"``
    (default, matching MVA) charges ``bound="upper"`` stations their stated
    upper-bound service — pessimistic but physical; ``"zero"`` drops them
    (matching the throughput upper bound).
    """
    if arrival_rate < 0.0:
        raise ValueError("arrival_rate must be >= 0")
    p = float(p_hit)
    counts = net.visit_counts(p)
    station_time: Dict[str, float] = {}
    station_var: Dict[str, float] = {}
    util: Dict[str, float] = {}
    stable = True
    for s in net.stations:
        svc = s.mean_service(p)
        if s.bound == "upper" and tail_mode == "zero":
            svc = 0.0
        if s.kind != QUEUE:
            station_time[s.name] = svc
            # det stages contribute no variance; exp (and, approximately,
            # pareto) stages contribute svc^2.
            station_var[s.name] = 0.0 if s.dist == "det" else svc * svc
            continue
        lam_k = arrival_rate * counts[s.name]
        a = lam_k * svc
        c = int(s.servers)
        util[s.name] = a / c
        if a >= c:
            stable = False
            station_time[s.name] = math.inf
            station_var[s.name] = math.inf
            continue
        wait = erlang_c(c, a) * svc / (c - a) if svc > 0.0 else 0.0
        station_time[s.name] = svc + wait
        # M/M/c sojourn moments: W = 0 w.p. 1-C, else Exp((c-a)/S), so
        # Var W = (S/(c-a))^2 C(2-C); service Exp(S) adds S^2.  For c=1
        # this collapses to the exact M/M/1 sojourn variance (S/(1-rho))^2.
        if svc > 0.0:
            cw = erlang_c(c, a)
            wu = svc / (c - a)
            station_var[s.name] = wu * wu * cw * (2.0 - cw) + svc * svc
        else:
            station_var[s.name] = 0.0

    branches = []
    mean = 0.0
    for b in net.branches:
        pb = b.probability(p)
        rb = sum(station_time[v] for v in b.visits)
        vb = sum(station_var[v] for v in b.visits)
        branches.append((b.name, pb, rb, vb))
        mean += pb * rb
    return OpenAnalysis(
        p_hit=p, arrival_rate=float(arrival_rate), stable=stable,
        mean=mean if stable else math.inf, utilization=util,
        station_time=station_time, branches=tuple(branches),
    )


def response_time(net: ClosedNetwork, p_hit, arrival_rate: float,
                  tail_mode: str = "nominal"):
    """Mean end-to-end response time R(p, lambda); +inf where unstable.
    Vectorized over ``p_hit``."""
    p_arr = np.atleast_1d(np.asarray(p_hit, dtype=np.float64))
    out = np.array([
        analyze_open(net, float(p), arrival_rate, tail_mode=tail_mode).mean
        for p in p_arr
    ])
    return out if np.ndim(p_hit) else float(out[0])


def response_percentile(net: ClosedNetwork, p_hit, arrival_rate: float,
                        q: float = 0.99, tail_mode: str = "nominal"):
    """Sojourn percentile (exponential-mixture approximation); +inf where
    unstable.  Vectorized over ``p_hit``."""
    p_arr = np.atleast_1d(np.asarray(p_hit, dtype=np.float64))
    out = np.array([
        analyze_open(net, float(p), arrival_rate,
                     tail_mode=tail_mode).percentile(q)
        for p in p_arr
    ])
    return out if np.ndim(p_hit) else float(out[0])


def observed_response(trace, qs=(0.5, 0.95, 0.99)) -> dict:
    """Empirical response-time summary from per-request trace records.

    ``trace`` is a :class:`repro_torch.obs.trace.TraceRecords` (a traced open- or
    closed-loop run); the returned overall / per-class sojourn means and
    percentiles are directly comparable to :func:`response_time` /
    :func:`response_percentile` at the matching (p, lambda) — the
    measurement-side counterpart of the Erlang-C layer.
    """
    from repro_torch.obs.trace import CLASS_NAMES

    soj = np.asarray(trace.sojourn_us, dtype=np.float64)
    cls = np.asarray(trace.cls)
    out = {
        "n_count": int(len(soj)),
        "mean_us": float(soj.mean()) if len(soj) else math.nan,
        "percentiles_us": {
            q: (float(np.percentile(soj, 100.0 * q)) if len(soj)
                else math.nan)
            for q in qs
        },
    }
    by_class = {}
    for c, name in CLASS_NAMES.items():
        sel = soj[cls == c]
        if len(sel):
            by_class[name] = {
                "n_count": int(len(sel)),
                "mean_us": float(sel.mean()),
                "percentiles_us": {
                    q: float(np.percentile(sel, 100.0 * q)) for q in qs
                },
            }
    out["by_class"] = by_class
    return out
