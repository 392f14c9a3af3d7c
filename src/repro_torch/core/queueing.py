"""Closed queueing-network analysis — prong A of the paper's methodology.

A copy of ``src/repro/core/queueing.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

The paper models a DRAM cache under a Multi-Programming Limit (MPL) as a
*closed* queueing network:

  - **think stations** (infinite-server): cache lookup, disk/backing store,
    ghost lookup.  No queueing; all MPL requests may be in service at once.
  - **queue stations** (c-server FCFS, default c=1): the serialized metadata
    operations on the global eviction structure (delink, head update, tail
    update, ...), and — for the "future systems" extension — finite-
    concurrency resources such as a backing store with bounded I/O depth.

Throughput is upper-bounded (Harchol-Balter, "Performance Modeling and
Design of Computer Systems", Theorem 7.1; multi-server bottleneck law)
by::

    X  <=  min( N / (D + E[Z]),  min_k c_k / D_k )

where ``D_k`` is the *demand* of queue station ``k`` (expected total service
a single request places on that station per pass through the system),
``c_k`` its server count, ``D = sum_k D_k`` and ``E[Z]`` the total think
time.  A ``c_k``-server station completes at most ``c_k / D_k`` requests per
unit time when saturated; with every ``c_k = 1`` this reduces to the
paper's ``1 / D_max`` form.

Everything below is parameterized by the hit ratio ``p_hit`` — demands and
service times are functions of ``p_hit`` — which is what lets the model
expose the paper's central phenomenon: the bottleneck (arg-max demand
station) switching from the miss path to the hit path at ``p*_hit``.

Units: microseconds.  Throughput is requests/µs == millions of requests/s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Union

import numpy as np

ServiceFn = Union[float, Callable[[float], float]]
ProbFn = Union[float, Callable[[float], float]]

QUEUE = "queue"
THINK = "think"


def _as_fn(v: ServiceFn) -> Callable[[float], float]:
    if callable(v):
        return v
    return lambda p, _v=float(v): _v


@dataclasses.dataclass(frozen=True)
class Station:
    """One service station.

    ``bound="upper"`` marks stations whose service time could only be
    bounded from above in the paper's measurements (the tail updates — they
    are never the bottleneck, so they cannot be kept saturated to measure
    the inter-departure time).  The throughput *upper* bound uses 0 for
    these; the pessimistic bound uses ``service``.
    """

    name: str
    kind: str  # QUEUE | THINK
    service: ServiceFn  # mean service time (µs), may depend on p_hit
    bound: str = "exact"  # "exact" | "upper"
    dist: str = "det"  # det | exp | pareto  (used by the simulator)
    dist_params: tuple = ()
    servers: int = 1  # FCFS server count (QUEUE stations only)

    def mean_service(self, p_hit: float) -> float:
        return float(_as_fn(self.service)(p_hit))


@dataclasses.dataclass(frozen=True)
class Branch:
    """A probabilistic route through the network.

    Each completed request samples one branch (probabilities must sum to 1
    at every ``p_hit``) and visits ``visits`` in order.  Station names may
    repeat (a station visited twice contributes twice to demand).
    """

    name: str
    prob: ProbFn
    visits: tuple  # tuple[str, ...]

    def probability(self, p_hit: float) -> float:
        return float(_as_fn(self.prob)(p_hit))


@dataclasses.dataclass(frozen=True)
class ClosedNetwork:
    name: str
    stations: tuple  # tuple[Station, ...]
    branches: tuple  # tuple[Branch, ...]
    mpl: int
    description: str = ""

    # ------------------------------------------------------------------ util
    def station(self, name: str) -> Station:
        for s in self.stations:
            if s.name == name:
                return s
        raise KeyError(name)

    def queue_stations(self) -> list[Station]:
        return [s for s in self.stations if s.kind == QUEUE]

    def think_stations(self) -> list[Station]:
        return [s for s in self.stations if s.kind == THINK]

    def validate(self, p_grid: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 0.999)) -> None:
        names = [s.name for s in self.stations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate station names in {self.name}")
        for s in self.stations:
            if s.servers < 1:
                raise ValueError(f"station {s.name}: servers must be >= 1")
        kinds = {s.name: s.kind for s in self.stations}
        for b in self.branches:
            for v in b.visits:
                if v not in names:
                    raise ValueError(f"branch {b.name} visits unknown station {v}")
            # Simulators place all mpl jobs straight into service at their
            # first station, which is only correct for infinite-server
            # stations — queue-first routes would bypass busy accounting.
            if b.visits and kinds[b.visits[0]] != THINK:
                raise ValueError(
                    f"branch {b.name} must start at a think station, "
                    f"not queue station {b.visits[0]}"
                )
        for p in p_grid:
            tot = sum(b.probability(p) for b in self.branches)
            if not math.isclose(tot, 1.0, abs_tol=1e-6):
                raise ValueError(
                    f"{self.name}: branch probabilities sum to {tot} at p_hit={p}"
                )

    # --------------------------------------------------------------- demands
    def visit_counts(self, p_hit: float) -> dict[str, float]:
        """Expected visits per request to each station."""
        counts = {s.name: 0.0 for s in self.stations}
        for b in self.branches:
            pb = b.probability(p_hit)
            for v in b.visits:
                counts[v] += pb
        return counts

    def demands(self, p_hit: float,
                tail_mode: str = "zero") -> dict[str, float]:
        """Per-queue-station demand D_k.

        tail_mode:
          "zero"    — bound="upper" stations contribute 0   (paper's X upper bound)
          "nominal" — use the stated upper-bound service     (pessimistic)
        """
        counts = self.visit_counts(p_hit)
        out = {}
        for s in self.queue_stations():
            svc = s.mean_service(p_hit)
            if s.bound == "upper" and tail_mode == "zero":
                svc = 0.0
            out[s.name] = counts[s.name] * svc
        return out

    def think_time(self, p_hit: float) -> float:
        counts = self.visit_counts(p_hit)
        return sum(counts[s.name] * s.mean_service(p_hit) for s in self.think_stations())

    def queue_servers(self) -> dict[str, int]:
        """Server count c_k per queue station."""
        return {s.name: int(s.servers) for s in self.queue_stations()}

    # ------------------------------------------------------------ thm 7.1
    def throughput_upper(self, p_hit: float | np.ndarray,
                         tail_mode: str = "zero") -> float | np.ndarray:
        """Analytic upper bound, X <= min(N/(D+Z), min_k c_k/D_k).  Vectorized.

        With all-single-server stations this is exactly the paper's
        X <= min(N/(D+Z), 1/Dmax) (Thm 7.1); a c-server station saturates
        at c/D_k instead of 1/D_k.
        """
        servers = self.queue_servers()
        p_arr = np.atleast_1d(np.asarray(p_hit, dtype=np.float64))
        out = np.empty_like(p_arr)
        for i, p in enumerate(p_arr):
            d = self.demands(float(p), tail_mode=tail_mode)
            D = sum(d.values())
            Z = self.think_time(float(p))
            terms = [self.mpl / (D + Z)]
            terms += [servers[k] / dk for k, dk in d.items() if dk > 0]
            out[i] = min(terms)
        return out if np.ndim(p_hit) else float(out[0])

    def bottleneck(self, p_hit: float, tail_mode: str = "zero") -> str:
        """Station that saturates first: arg-max of per-server demand D_k/c_k."""
        servers = self.queue_servers()
        d = self.demands(p_hit, tail_mode=tail_mode)
        return max(d, key=lambda k: d[k] / servers[k])

    def p_star(self, tail_mode: str = "zero", grid: int = 20001) -> float:
        """Critical hit ratio after which throughput starts to deteriorate.

        The bound can plateau (X = 1/D_max constant while the miss-path
        station stays the bottleneck), so p* is the *largest* hit ratio
        still achieving the maximum.  Returns 1.0 for FIFO-like policies
        (monotone increasing bound).
        """
        ps = np.linspace(0.0, 1.0, grid)
        xs = self.throughput_upper(ps, tail_mode=tail_mode)
        x_max = float(np.max(xs))
        at_max = np.nonzero(xs >= x_max * (1.0 - 1e-9))[0]
        return float(ps[int(at_max[-1])])

    # ---------------------------------------------------------------- MVA
    AMVA_AUTO_MPL = 1000  # mode="auto" switches to Schweitzer above this N

    def mva(self, p_hit: float, n: int | None = None,
            tail_mode: str = "nominal", multiserver: str = "exact",
            mode: str = "exact") -> tuple[float, dict[str, float], float]:
        """Mean Value Analysis of the (product-form) exponential analogue.

        The paper only derives *bounds*; MVA gives the exact closed-network
        solution when services are exponential.  It is a very good
        approximation for the measured distributions (the paper notes
        insensitivity to service distributions, citing [80]).

        ``mode`` selects the recursion:

        ``"exact"`` (default)
            The full population recursion, O(N) per station (O(N^2) with
            load-dependent multi-server marginals).
        ``"amva"``
            Schweitzer's approximate MVA: the fixed point of the
            arrival-theorem estimate  Q_k(N-1) ~= Q_k(N) (N-1)/N.  O(1) in
            the population per iteration — the fallback that keeps
            "future systems" sweeps with MPL >> 10^3 tractable.
            Multi-server stations use Seidmann's tandem transform.
        ``"auto"``
            ``"amva"`` when N > AMVA_AUTO_MPL (1000), else ``"exact"``.

        Multi-server (c > 1) stations are handled per ``multiserver``
        (exact mode only):

        ``"exact"`` (default)
            Load-dependent MVA: per-station marginal queue-length
            probabilities with service rate min(j, c)/S — exact for the
            exponential analogue (Reiser & Lavenberg).
        ``"seidmann"``
            Seidmann's tandem decomposition: the c-server station becomes a
            single server with demand D/c plus a pure delay of D(c-1)/c.
            Cheaper, but underestimates X by up to ~15% when the population
            is close to c.

        With every ``servers=1`` both modes reduce to the same plain
        single-server recursion as the seed code, bit for bit.

        Returns (X, {station: mean queue length}, R_total).
        """
        n = int(n or self.mpl)
        d = self.demands(p_hit, tail_mode=tail_mode)
        names = list(d)
        servers = self.queue_servers()
        C = np.array([servers[k] for k in names], dtype=np.float64)
        D = np.array([d[k] for k in names], dtype=np.float64)
        Z = self.think_time(p_hit)

        if mode not in ("exact", "amva", "auto"):
            raise ValueError(f"unknown mva mode {mode!r}")
        if mode == "auto":
            mode = "amva" if n > self.AMVA_AUTO_MPL else "exact"
        if mode == "amva":
            return self._schweitzer(names, D, C, Z, n)
        if multiserver not in ("exact", "seidmann"):
            raise ValueError(f"unknown multiserver mode {multiserver!r}")
        if multiserver == "seidmann" or np.all(C == 1.0):
            Dq = D / C  # queueing portion (per-server demand)
            Zd = float((D * (C - 1.0) / C).sum())  # Seidmann delay portion
            Z = Z + Zd
            Q = np.zeros_like(D)
            X = 0.0
            R = Dq
            for k in range(1, n + 1):
                R = Dq * (1.0 + Q)
                X = k / (Z + float(R.sum()))
                Q = X * R
            # R_total = Z + R(n) = n/X — same Little's-law-consistent
            # convention as the exact branch below.
            return X, dict(zip(names, Q.tolist())), Z + float(R.sum())

        # Exact load-dependent recursion.  Single-server stations only need
        # their mean queue length; c>1 stations carry marginal probabilities
        # p_k(j | pop):  R_k = D_k sum_j (j / min(j, c)) p_k(j-1 | pop-1).
        # The marginal update is renormalized when float error pushes
        # sum_j>0 p_j past 1 — the classic MVA-LD instability at saturation
        # otherwise compounds (the clamped p_0 form can overshoot c_k/D_k).
        K = len(names)
        Q = np.zeros(K)
        j_idx = np.arange(1, n + 1, dtype=np.float64)
        weights = {}  # per multi-server station: j / min(j, c) for j = 1..n
        marg = {}
        for k in range(K):
            if C[k] > 1:
                weights[k] = j_idx / np.minimum(j_idx, C[k])
                pk = np.zeros(n + 1)
                pk[0] = 1.0
                marg[k] = pk
        X = 0.0
        R = np.zeros(K)
        for pop in range(1, n + 1):
            for k in range(K):
                if k in marg:
                    R[k] = D[k] * float((weights[k][:pop] * marg[k][:pop]).sum())
                else:
                    R[k] = D[k] * (1.0 + Q[k])
            X = pop / (Z + float(R.sum()))
            Q = X * R
            for k in marg:
                pk = marg[k]
                new = np.zeros(n + 1)
                new[1:pop + 1] = X * D[k] / np.minimum(j_idx[:pop], C[k]) * pk[:pop]
                s = float(new[1:].sum())
                if s > 1.0:
                    new[1:] /= s
                else:
                    new[0] = 1.0 - s
                marg[k] = new
        return X, dict(zip(names, Q.tolist())), Z + float(R.sum())

    def _schweitzer(self, names: Sequence[str], D: np.ndarray,
                    C: np.ndarray, Z: float,
                    n: int) -> tuple[float, dict[str, float], float]:
        """Schweitzer/approximate MVA fixed point (Bard-Schweitzer).

        Iterates R_k = D_k (1 + Q_k (n-1)/n), X = n/(Z + sum R), Q_k = X R_k
        until the queue lengths settle.  Cost is independent of n, vs the
        exact recursion's O(n) (O(n^2) load-dependent) — the difference
        between milliseconds and minutes at MPL ~ 10^5.  Accuracy is the
        classic AMVA trade: a few percent, pinned <2% vs exact at MPL=500
        in tests/test_multiserver.py.
        """
        # multi-server stations via Seidmann: queueing demand D/c plus a
        # fixed delay D(c-1)/c folded into the think time.
        Dq = D / C
        Z = Z + float((D * (C - 1.0) / C).sum())
        K = len(Dq)
        Q = np.full(K, n / max(K, 1), dtype=np.float64)
        X = 0.0
        R = Dq.copy()
        scale = (n - 1.0) / n if n > 0 else 0.0
        for _ in range(10_000):
            R = Dq * (1.0 + Q * scale)
            X = n / (Z + float(R.sum()))
            Q_new = X * R
            if float(np.abs(Q_new - Q).max()) < 1e-10:
                Q = Q_new
                break
            Q = Q_new
        return X, dict(zip(names, Q.tolist())), Z + float(R.sum())

    def mva_throughput(self, p_hit: float | np.ndarray,
                       n: int | None = None, tail_mode: str = "nominal",
                       multiserver: str = "exact",
                       mode: str = "exact") -> float | np.ndarray:
        p_arr = np.atleast_1d(np.asarray(p_hit, dtype=np.float64))
        out = np.array([
            self.mva(float(p), n=n, tail_mode=tail_mode,
                     multiserver=multiserver, mode=mode)[0]
            for p in p_arr
        ])
        return out if np.ndim(p_hit) else float(out[0])

    def response_time_upper(self, p_hit: float | np.ndarray,
                            tail_mode: str = "zero") -> float | np.ndarray:
        """Mean cycle (response) time lower bound, R = N / X_upper."""
        return self.mpl / self.throughput_upper(p_hit, tail_mode=tail_mode)


def disk_station(disk_us: float, disk_servers: int = 0) -> Station:
    """The backing store: infinite-server think station (the paper's model,
    ``disk_servers=0``) or a c-server FCFS queue station with bounded I/O
    concurrency (the "future systems" extension).  Single definition shared
    by the analytic policy networks and the prong-C harness so the two
    stacks can never model different disks behind the same knob."""
    if disk_servers:
        return Station("disk", QUEUE, float(disk_us), dist="exp",
                       servers=int(disk_servers))
    return Station("disk", THINK, float(disk_us), dist="exp")


def exponential_analogue(net: ClosedNetwork) -> ClosedNetwork:
    """Replace every service distribution by exponential (same means).

    This is the network MVA actually solves; simulate it when validating
    MVA at CI-level precision — the det/pareto originals differ from the
    exponential analogue by a genuine (in)sensitivity gap of several percent
    at saturated single-server stations.
    """
    return dataclasses.replace(
        net,
        stations=tuple(
            dataclasses.replace(s, dist="exp", dist_params=()) for s in net.stations
        ),
    )


# --------------------------------------------------------------------------
# Delayed hits / miss coalescing (Manohar et al. 2020; MSHR-style fill table).
# --------------------------------------------------------------------------

INFLIGHT = "inflight"


def _disk_stations(net: ClosedNetwork, disk_name: str) -> list[str]:
    """All backing-store stations matching ``disk_name`` by suffix: the
    bare single-node ``"disk"`` and the cluster composition's per-shard
    replicas (``"s0:disk"``, ...), in station order."""
    return [s.name for s in net.stations
            if s.name == disk_name or s.name.split(":")[-1] == disk_name]


def _disk_branches(net: ClosedNetwork, disk_name: str) -> list[Branch]:
    names = set(_disk_stations(net, disk_name))
    return [b for b in net.branches if names & set(b.visits)]


def sigma_of(net: ClosedNetwork, p_hit: float) -> float:
    """Recover the coalescing factor sigma(p) of a coalesced network.

    Reads the probability mass of the ``*_delayed`` branches that
    :func:`coalesced_network` creates, relative to all fill-requiring
    traffic (delayed + leader/disk branches).  On a multi-disk (sharded)
    network this is the miss-share-weighted mean of the per-shard
    sigma_k.  Returns 0 for a network without coalescing.  Lives here so
    the ``_delayed`` naming convention stays private to this module.
    """
    delayed = sum(
        b.probability(p_hit) for b in net.branches
        if b.name.endswith("_delayed")
    )
    fills = delayed + sum(
        b.probability(p_hit) for b in _disk_branches(net, "disk")
    )
    return delayed / fills if fills > 0 else 0.0


def zipf_flow_weights(flows: int, theta: float = 0.0) -> np.ndarray:
    """Per-flow popularity weights of the coalescing hot-key ensemble.

    ``w_f ∝ (f+1)^-theta`` normalized to sum 1 (descending); theta=0 is the
    uniform ensemble the original fixed point assumed.  Matching theta to a
    trace's Zipf skew makes the analytic sigma predictable from the per-key
    miss spectrum instead of an effective flow count — the weights are the
    miss-probability shares of the hot keys.
    """
    if flows < 1:
        raise ValueError("flows must be >= 1")
    w = np.arange(1, flows + 1, dtype=np.float64) ** (-float(theta))
    return w / w.sum()


def coalesced_network(
    net: ClosedNetwork,
    flows: int = 64,
    window_us: ServiceFn | None = None,
    sigma: ProbFn | None = None,
    disk_name: str = "disk",
    window_mode: str = "service",
    flow_theta: float = 0.0,
) -> ClosedNetwork:
    """Miss-coalescing transform: concurrent misses on one key share a fetch.

    The base model treats every miss as independent — each pays a full
    backing-store trip and a full pass through the miss-path metadata
    stations.  Real caches keep an outstanding-miss table (MSHRs): a
    request that misses on a key whose fetch is already *in flight* parks
    until the fill lands (a "delayed hit" — Manohar et al. 2020) and issues
    no second I/O and no second insertion.  The disk therefore sees the
    *coalesced* miss rate ``X (1-p) (1-sigma)`` instead of ``X (1-p)``.

    Every branch of ``net`` that visits ``disk_name`` splits in two:

    * the **leader** (probability scaled by ``1 - sigma(p)``) — the request
      that initiates the fetch; it follows the original route, including
      the post-disk fill/eviction metadata stations;
    * the **delayed hit** (probability scaled by ``sigma(p)``) — it keeps
      the pre-disk visits, then parks on a new infinite-server ``inflight``
      station for the *residual* window (window/2 for a deterministic
      fetch latency under a uniformly-positioned arrival) and completes
      without touching the disk or the fill metadata.

    ``window_us`` is the in-flight window — how long a fetch stays
    outstanding; it defaults to the disk station's own mean service time
    (a fetch is in flight exactly while the disk serves it).  May be a
    callable of ``p_hit`` like every other service time.

    ``window_mode="mva"`` makes the default window *queueing-aware*: with a
    bounded-I/O-depth disk (``disk_servers`` > 0) a fetch stays outstanding
    through its queueing delay too, so the window becomes the disk's
    per-visit MVA residence time (service + estimated wait, re-solved
    inside the sigma fixed point) instead of the bare service.  With the
    paper's infinite-server disk the residence equals the service and the
    mode changes nothing.  An explicit ``window_us`` always wins.

    ``flow_theta`` skews the hot-key flow ensemble Zipf(theta)-style (see
    :func:`zipf_flow_weights`): the fixed point becomes the weight-mixture
    ``sigma = sum_f w_f * mu_f L / (1 + mu_f L)`` with per-flow miss rate
    ``mu_f = X * P{miss} * w_f``.  theta=0 reproduces the original uniform
    formula exactly.

    ``sigma`` is the coalescing factor — the fraction of would-be misses
    that find a fetch for their key already in flight.  Pass a constant or
    a callable (e.g. the measured fraction from prong C's
    :func:`repro.cache.replay.classify_inflight`); when omitted it is
    solved self-consistently from the in-flight window: per-flow misses
    initiate fetches as a renewal process (window ``L`` then an idle gap),
    giving

        sigma(p) = mu L / (1 + mu L)

    with the per-flow miss rate ``mu = X(p) * P{miss}(p) / flows`` and
    ``L`` the window; ``X`` is the coalesced
    network's own throughput bound — a contraction solved by fixed-point
    iteration and memoized per ``p``.  ``flows`` is the effective number
    of concurrently-missed hot keys the miss stream spreads over (fewer
    flows => more collisions => more coalescing).

    With ``window_us = 0`` (or ``sigma = 0``) the transform is exact
    identity on every demand and think time: sigma solves to 0, the
    delayed branches carry probability 0, and bounds/MVA/simulation all
    reduce to the base network's values.

    **Sharded networks.**  ``disk_name`` matches by suffix, so a cluster
    composition with per-shard disks (``"s0:disk"``, ...) gets one
    coalescing factor **per shard**: each disk gets its
    own ``inflight`` station (``"s0:inflight"``) and its own fixed point
    ``sigma_k = sum_f w_f mu_{k,f} L_k / (1 + mu_{k,f} L_k)`` against
    that shard's *own* miss rate ``mu_{k,f} = X m_k w_f / 1`` (with
    ``m_k`` the probability mass of branches visiting shard ``k``'s
    disk), solved jointly with the shared throughput bound ``X`` — the
    simulator's shard-local MSHR tables, analytically.  Hot shards
    coalesce more; a single flat sigma would average that away.  With
    one disk this reduces exactly to the single fixed point above.
    """
    disks = _disk_stations(net, disk_name)
    if not disks or not _disk_branches(net, disk_name):
        raise ValueError(f"{net.name} has no branch visiting {disk_name!r}")
    if window_mode not in ("service", "mva"):
        raise ValueError(f"unknown window_mode {window_mode!r}")
    weights = zipf_flow_weights(flows, flow_theta)
    if window_us is not None:
        base_window = {d: _as_fn(window_us) for d in disks}
    else:
        base_window = {d: net.station(d).mean_service for d in disks}
    use_mva = window_mode == "mva" and window_us is None

    def inflight_name(d: str) -> str:
        return (f"{d[:-len(disk_name)]}{INFLIGHT}"
                if d.endswith(":" + disk_name) else INFLIGHT)

    def branch_disk(b: Branch) -> str | None:
        for v in b.visits:
            if v in disks:
                return v
        return None

    # sigma_fns / window_fns: disk station name -> callable of p.
    def build(sigma_fns: dict, window_fns: dict) -> ClosedNetwork:
        stations = net.stations + tuple(
            Station(inflight_name(d), THINK,
                    lambda p, d=d: 0.5 * window_fns[d](p), dist="exp")
            for d in disks
        )
        branches = []
        for b in net.branches:
            d = branch_disk(b)
            if d is None:
                branches.append(b)
                continue
            pf = _as_fn(b.prob)
            sfn = sigma_fns[d]
            pre = b.visits[: b.visits.index(d)]
            branches.append(
                dataclasses.replace(
                    b, prob=lambda p, pf=pf, sfn=sfn: pf(p) * (1.0 - sfn(p))
                )
            )
            branches.append(
                Branch(
                    b.name + "_delayed",
                    lambda p, pf=pf, sfn=sfn: pf(p) * sfn(p),
                    pre + (inflight_name(d),),
                )
            )
        return dataclasses.replace(
            net,
            name=net.name + "+coalesce",
            stations=stations,
            branches=tuple(branches),
        )

    def mva_window(p: float, net_s: ClosedNetwork, d: str,
                   base_L: float) -> float:
        """Per-visit disk residence (service + estimated wait) of the
        coalesced network at its current sigma — the queueing-aware
        in-flight window.  A think-station disk has no queueing term, so
        this degenerates to the base window."""
        v = net_s.visit_counts(p).get(d, 0.0)
        if v <= 0.0:
            return base_L
        X, Q, _ = net_s.mva(p, mode="auto")
        if d not in Q or X <= 0.0:
            return base_L
        # Little's law per visit: residence = Q_disk / (X * V_disk).
        return max(base_L, Q[d] / (X * v))

    if sigma is not None:
        sfn = _as_fn(sigma)
        sigma_fns = {d: sfn for d in disks}
        if not use_mva:
            return build(sigma_fns, base_window)
        memo_w: dict = {}

        def window_eff(p: float, d: str) -> float:
            key = (round(float(p), 12), d)
            if key not in memo_w:
                memo_w[key] = mva_window(
                    float(p), build(sigma_fns, base_window), d,
                    float(base_window[d](p))
                )
            return memo_w[key]

        return build(sigma_fns,
                     {d: (lambda p, d=d: window_eff(p, d)) for d in disks})

    def miss_share(p: float, d: str) -> float:
        return sum(b.probability(p) for b in net.branches
                   if branch_disk(b) == d)

    memo: dict = {}  # p -> ({disk: sigma}, {disk: effective window})

    def solve(p: float) -> tuple[dict, dict]:
        key = round(float(p), 12)
        if key in memo:
            return memo[key]
        base_L = {d: float(base_window[d](p)) for d in disks}
        L = dict(base_L)
        m = {d: miss_share(p, d) for d in disks}
        s = {d: 0.0 for d in disks}
        live = [d for d in disks if base_L[d] > 0.0 and m[d] > 0.0]
        if live:
            for _ in range(100):
                net_s = build(
                    {d: (lambda _p, v=s[d]: v) for d in disks},
                    {d: (lambda _p, v=L[d]: v) for d in disks},
                )
                X = float(net_s.throughput_upper(p, tail_mode="zero"))
                if use_mva:
                    for d in live:
                        L[d] = mva_window(p, net_s, d, base_L[d])
                s_new = dict(s)
                for d in live:
                    if flow_theta == 0.0:
                        mu = X * m[d] / flows
                        s_new[d] = mu * L[d] / (1.0 + mu * L[d])
                    else:
                        mu_f = X * m[d] * weights
                        s_new[d] = float(
                            (weights * mu_f * L[d] / (1.0 + mu_f * L[d])).sum()
                        )
                if all(abs(s_new[d] - s[d]) < 1e-12 for d in live):
                    s = s_new
                    break
                # the MVA window couples L to sigma; damp that richer fixed
                # point (plain iteration stays exact for the service window)
                s = ({d: 0.5 * (s[d] + s_new[d]) for d in disks}
                     if use_mva else s_new)
        memo[key] = (s, L)
        return memo[key]

    return build(
        {d: (lambda p, d=d: solve(p)[0][d]) for d in disks},
        {d: (lambda p, d=d: solve(p)[1][d]) for d in disks},
    )


# --------------------------------------------------------------------------
# Mitigation (paper §5.2): bypass the cache under load.
# --------------------------------------------------------------------------


def bypass_network(net: ClosedNetwork, beta: ProbFn) -> ClosedNetwork:
    """Send a fraction ``beta`` of requests straight to the backing store.

    Bypassed requests skip all policy metadata stations (and the cache
    cannot hit for them) — they visit only the lookup + disk think stations.
    The remaining ``1-beta`` behave exactly as in ``net``.
    """
    beta_fn = _as_fn(beta)
    scaled = []
    for b in net.branches:
        pf = _as_fn(b.prob)
        scaled.append(
            dataclasses.replace(
                b, prob=(lambda p, pf=pf, bf=beta_fn: (1.0 - bf(p)) * pf(p))
            )
        )
    # the disk may be a think station (paper) or a c-server queue station
    # (disk_servers > 0) — bypassed traffic hits it either way.
    disk = [s.name for s in net.stations if "disk" in s.name]
    lookup = [s.name for s in net.think_stations() if "lookup" in s.name]
    visits = tuple(lookup[:1] + disk[:1])
    scaled.append(Branch("bypass", lambda p, bf=beta_fn: bf(p), visits))
    return dataclasses.replace(
        net, name=net.name + "+bypass", branches=tuple(scaled)
    )


def optimal_bypass_beta(net: ClosedNetwork, p_hit: float, grid: int = 1001) -> float:
    """Smallest beta that caps the hit-path bottleneck demand at its p* level.

    For p_hit <= p*, no bypass is needed (beta = 0).  Beyond p*, keeping the
    bottleneck demand pinned at D_max(p*) keeps throughput flat instead of
    falling — the behaviour the paper reports for this mitigation.  The cap
    only covers stations the bypass actually relieves: bypassed requests
    still visit the lookup + backing store, so those are excluded (for the
    paper's infinite-server disk this changes nothing — think stations carry
    no queueing demand).

    With a bounded-I/O-depth disk (``disk_servers`` > 0) bypassing *adds*
    disk demand, so the capping beta can saturate the disk and make the
    "mitigation" a net loss; in that case fall back to the beta maximizing
    the analytic bound over a grid (ties resolve to the smallest beta).
    """
    p_star = net.p_star()
    if p_hit <= p_star:
        return 0.0
    servers = net.queue_servers()
    relieved = set(servers) - set(
        next(b for b in bypass_network(net, 0.5).branches
             if b.name == "bypass").visits
    )

    def max_relieved(n: ClosedNetwork, p: float) -> float:
        return max(
            (dk / servers[k] for k, dk in n.demands(p).items() if k in relieved),
            default=0.0,
        )

    target = max_relieved(net, p_star)

    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if max_relieved(bypass_network(net, mid), p_hit) > target:
            lo = mid
        else:
            hi = mid
    beta = 0.5 * (lo + hi)

    if (bypass_network(net, beta).throughput_upper(p_hit)
            < net.throughput_upper(p_hit)):
        betas = np.linspace(0.0, 1.0, grid)
        xs = np.array([
            float(bypass_network(net, float(b)).throughput_upper(p_hit))
            for b in betas
        ])
        beta = float(betas[int(np.argmax(xs))])
    return beta
