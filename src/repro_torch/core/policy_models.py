"""Per-policy queueing networks with the paper's measured service times.

A copy of ``src/repro/core/policy_models.py`` (numpy only), rewired to the
port's own :mod:`repro_torch.core.queueing`.  Change both together.

Each builder returns a :class:`~repro_torch.core.queueing.ClosedNetwork` whose
analytic upper bound reproduces the paper's equations exactly:

  LRU       — Eq. (1)/(2)/(3)        (Sec. 3.2)
  FIFO      — Eq. (4)/(5)/(6)        (Sec. 4.1)
  Prob-LRU  — q = 0.5 and q = 1-1/72 (Sec. 4.2)
  CLOCK     — Sec. 4.3
  SLRU      — Sec. 4.4 (with the 98.71 coefficient; the paper's printed
              88.71 is inconsistent with its own demand derivation)
  S3-FIFO   — Sec. 4.5 (chi^2 fits encoded as printed, clamped to [0,1])

All service times are the paper's measurements on a 72-core Xeon 8360Y
(Sec. 3.1/3.4).  ``disk_us`` selects the emulated backing-store latency
(500 / 100 / 5 µs in the paper), ``mpl`` the multi-programming limit.

"Future systems" knobs (paper Sec. 6 — more cores per CPU, faster disks):

* ``cores`` — number of client cores; the paper runs one closed-loop client
  thread per core, so this simply sets ``mpl = cores`` (overriding ``mpl``).
* ``disk_servers`` — when > 0, the backing store is modeled as a
  ``disk_servers``-server FCFS queue station (bounded I/O concurrency, e.g.
  an NVMe queue depth) instead of the infinite-server think station the
  paper assumes.  0 keeps the paper's infinite-server disk.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.queueing import (
    QUEUE,
    THINK,
    Branch,
    ClosedNetwork,
    Station,
    coalesced_network,
    disk_station,
)

Z_CACHE_LOOKUP = 0.51  # µs, Sec. 3.1

# Measured service times (µs).  See Figures 2, 4, 6, 9, 11, 13.
LRU_S_DELINK = 0.70
LRU_S_HEAD = 0.59
FIFO_S_HEAD = 0.73
CLOCK_S_BASE = 0.65

# Prob-LRU calibration: S_head/S_delink depend on q because q changes the
# queue lengths and hence the cross-core communication component of the
# service time (Sec. 3.1, Sec. 4.2).  Calibrated at the paper's two settings
# plus the LRU (q=0) and FIFO (q=1) endpoints.
_PROB_Q = np.array([0.0, 0.5, 1.0 - 1.0 / 72.0, 1.0])
_PROB_S_DELINK = np.array([0.70, 0.78, 0.79, 0.79])
_PROB_S_HEAD = np.array([0.59, 0.65, 0.67, 0.73])


def clock_g(x):
    """CLOCK tail-scan overhead fit, Sec. 4.3:  g(x) = 2.43e-5 e^{11.24 x} + 0.187."""
    return 2.43e-5 * np.exp(11.24 * np.asarray(x, dtype=np.float64)) + 0.187


def slru_ell(p):
    """P{hit lands in the protected T list} fit, Sec. 4.4."""
    p = np.asarray(p, dtype=np.float64)
    return -0.1144 * p**2 + 1.009 * p


def chi2_h(x, a, b, c):
    """The paper's chi^2-shaped fit h(x; a, b, c), Sec. 4.5, as printed.

    Zero outside the support x > b.
    """
    x = np.asarray(x, dtype=np.float64)
    z = (x - b) / c
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        val = (
            np.power(np.maximum(z, 0.0), a / 2.0 - 1.0)
            * np.exp(-np.maximum(x - b, 0.0) / (2.0 * c))
            / (2.0 ** (a / 2.0) * math.gamma(a / 2.0) * c**a)
        )
    return np.where(z > 0.0, val, 0.0)


def s3fifo_p_ghost(p_hit):
    """Fraction of misses the ghost routes to the M list (clamped fit)."""
    p = np.asarray(p_hit, dtype=np.float64)
    miss = np.maximum(1.0 - p, 1e-9)
    return np.clip(chi2_h(65.0 * miss, 4.4912, 1.1394, 3.595) / miss, 0.0, 1.0)


def s3fifo_p_m(p_hit):
    """Fraction of S-tail items with bit=1 (promoted to M on eviction)."""
    p = np.asarray(p_hit, dtype=np.float64)
    miss = np.maximum(1.0 - p, 1e-9)
    return np.clip(chi2_h(400.0 * miss, 2.2870, 4.5309, 26.5874) / miss, 0.0, 1.0)


def _common_think(disk_us: float, disk_servers: int = 0):
    return [
        Station("lookup", THINK, Z_CACHE_LOOKUP, dist="det"),
        disk_station(disk_us, disk_servers),
    ]


def _resolve_mpl(mpl: int, cores) -> int:
    """One closed-loop client thread per core (paper Sec. 3.1 testbed)."""
    return int(cores) if cores is not None else int(mpl)


# --------------------------------------------------------------------------
# LRU — Sec. 3
# --------------------------------------------------------------------------


def lru_network(disk_us: float = 100.0, mpl: int = 72, cores: int | None = None,
                disk_servers: int = 0) -> ClosedNetwork:
    """Fig. 2.  Hit: delink + head update.  Miss: disk + tail + head update."""
    mpl = _resolve_mpl(mpl, cores)
    stations = _common_think(disk_us, disk_servers) + [
        # S_head ~ BoundedPareto(alpha=0.45, 0.1..1.2) per Sec 3.1.
        Station("head", QUEUE, LRU_S_HEAD, dist="pareto", dist_params=(0.45, 0.1, 1.2)),
        Station("delink", QUEUE, LRU_S_DELINK, dist="det"),
        Station("tail", QUEUE, LRU_S_HEAD, bound="upper", dist="det"),
    ]
    branches = [
        Branch("hit", lambda p: p, ("lookup", "delink", "head")),
        Branch("miss", lambda p: 1.0 - p, ("lookup", "disk", "tail", "head")),
    ]
    return ClosedNetwork(
        "lru", tuple(stations), tuple(branches), mpl,
        description="LRU: global list touched on every hit (delink+head).",
    )


# --------------------------------------------------------------------------
# FIFO — Sec. 4.1
# --------------------------------------------------------------------------


def fifo_network(disk_us: float = 100.0, mpl: int = 72, cores: int | None = None,
                 disk_servers: int = 0) -> ClosedNetwork:
    """Fig. 4.  Hit: nothing.  Miss: disk + tail + head update."""
    mpl = _resolve_mpl(mpl, cores)
    stations = _common_think(disk_us, disk_servers) + [
        Station("head", QUEUE, FIFO_S_HEAD, dist="pareto", dist_params=(0.45, 0.1, 1.4)),
        Station("tail", QUEUE, FIFO_S_HEAD, bound="upper", dist="det"),
    ]
    branches = [
        Branch("hit", lambda p: p, ("lookup",)),
        Branch("miss", lambda p: 1.0 - p, ("lookup", "disk", "tail", "head")),
    ]
    return ClosedNetwork(
        "fifo", tuple(stations), tuple(branches), mpl,
        description="FIFO: hits never touch the global list.",
    )


# --------------------------------------------------------------------------
# Probabilistic LRU — Sec. 4.2
# --------------------------------------------------------------------------


def prob_lru_service(q: float):
    s_delink = float(np.interp(q, _PROB_Q, _PROB_S_DELINK))
    s_head = float(np.interp(q, _PROB_Q, _PROB_S_HEAD))
    return s_delink, s_head


def prob_lru_network(q: float = 0.5, disk_us: float = 100.0, mpl: int = 72,
                     cores: int | None = None, disk_servers: int = 0) -> ClosedNetwork:
    """Fig. 6.  Hit: with prob (1-q) promote (delink+head), with prob q nothing."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1]")
    mpl = _resolve_mpl(mpl, cores)
    s_delink, s_head = prob_lru_service(q)
    stations = _common_think(disk_us, disk_servers) + [
        Station("head", QUEUE, s_head, dist="pareto", dist_params=(0.45, 0.1, 2 * s_head - 0.1)),
        Station("delink", QUEUE, s_delink, dist="det"),
        Station("tail", QUEUE, s_head, bound="upper", dist="det"),
    ]
    branches = [
        Branch("hit_promote", lambda p: p * (1.0 - q), ("lookup", "delink", "head")),
        Branch("hit_skip", lambda p: p * q, ("lookup",)),
        Branch("miss", lambda p: 1.0 - p, ("lookup", "disk", "tail", "head")),
    ]
    return ClosedNetwork(
        f"prob_lru(q={q:g})", tuple(stations), tuple(branches), mpl,
        description="Probabilistic LRU: promotion only with prob 1-q.",
    )


# --------------------------------------------------------------------------
# CLOCK (FIFO-Reinsertion) — Sec. 4.3
# --------------------------------------------------------------------------


def clock_network(disk_us: float = 100.0, mpl: int = 72, cores: int | None = None,
                  disk_servers: int = 0) -> ClosedNetwork:
    """Fig. 9.  Hit: set bit (~0 cost).  Miss: disk + (scanning) tail + head."""
    mpl = _resolve_mpl(mpl, cores)
    stations = _common_think(disk_us, disk_servers) + [
        Station(
            "tail", QUEUE,
            lambda p: CLOCK_S_BASE + 0.3 * float(clock_g(p)),
            dist="det",
        ),
        Station("head", QUEUE, CLOCK_S_BASE, bound="upper", dist="det"),
    ]
    branches = [
        Branch("hit", lambda p: p, ("lookup",)),
        Branch("miss", lambda p: 1.0 - p, ("lookup", "disk", "tail", "head")),
    ]
    return ClosedNetwork(
        "clock", tuple(stations), tuple(branches), mpl,
        description="CLOCK: second-chance bit; hits only set a bit.",
    )


# --------------------------------------------------------------------------
# Segmented LRU — Sec. 4.4
# --------------------------------------------------------------------------


def slru_network(disk_us: float = 100.0, mpl: int = 72, cores: int | None = None,
                 disk_servers: int = 0) -> ClosedNetwork:
    """Fig. 11.  Probationary B list + protected T list.

    hit-in-T (prob l(p)):  delinkT + headT
    hit-in-B (prob p - l(p)):  delinkB + headT, T overflows -> tailT + headB
    miss (1-p):  disk + tailB + headB
    """
    mpl = _resolve_mpl(mpl, cores)
    stations = _common_think(disk_us, disk_servers) + [
        Station("delinkT", QUEUE, LRU_S_DELINK, dist="det"),
        Station("delinkB", QUEUE, LRU_S_DELINK, dist="det"),
        Station("headT", QUEUE, LRU_S_HEAD, dist="pareto", dist_params=(0.45, 0.1, 1.2)),
        Station("headB", QUEUE, LRU_S_HEAD, dist="pareto", dist_params=(0.45, 0.1, 1.2)),
        Station("tailT", QUEUE, LRU_S_HEAD, bound="upper", dist="det"),
        Station("tailB", QUEUE, LRU_S_HEAD, bound="upper", dist="det"),
    ]
    ell = lambda p: float(slru_ell(p))
    branches = [
        Branch("hit_T", ell, ("lookup", "delinkT", "headT")),
        Branch(
            "hit_B",
            lambda p: p - ell(p),
            ("lookup", "delinkB", "headT", "tailT", "headB"),
        ),
        Branch("miss", lambda p: 1.0 - p, ("lookup", "disk", "tailB", "headB")),
    ]
    return ClosedNetwork(
        "slru", tuple(stations), tuple(branches), mpl,
        description="Segmented LRU: two LRU lists (probationary + protected).",
    )


# --------------------------------------------------------------------------
# S3-FIFO — Sec. 4.5
# --------------------------------------------------------------------------


def s3fifo_network(
    disk_us: float = 100.0,
    mpl: int = 72,
    cores: int | None = None,
    disk_servers: int = 0,
    p_ghost_fn=None,
    p_m_fn=None,
) -> ClosedNetwork:
    """Fig. 13.  Small FIFO S + main FIFO M + ghost registry.

    hit (p): set bit only.
    miss routed to M (ghost hit, prob p_ghost):         headM + tailM
    miss routed to S, S-tail promoted (prob p_M):       headS + tailS + headM + tailM
    miss routed to S, S-tail evicted:                   headS + tailS

    The M-tail scans for a 0 bit like CLOCK; the paper writes its service
    time as the bare g(p_hit) (Sec. 4.5) — encoded as printed.
    """
    mpl = _resolve_mpl(mpl, cores)
    pg = p_ghost_fn or (lambda p: float(s3fifo_p_ghost(p)))
    pm = p_m_fn or (lambda p: float(s3fifo_p_m(p)))
    stations = _common_think(disk_us, disk_servers) + [
        Station("ghost", THINK, Z_CACHE_LOOKUP, dist="det"),
        Station("headS", QUEUE, CLOCK_S_BASE, dist="det"),
        Station("tailS", QUEUE, CLOCK_S_BASE, bound="upper", dist="det"),
        Station("headM", QUEUE, CLOCK_S_BASE, bound="upper", dist="det"),
        Station("tailM", QUEUE, lambda p: float(clock_g(p)), dist="det"),
    ]
    branches = [
        Branch("hit", lambda p: p, ("lookup",)),
        Branch(
            "miss_to_M",
            lambda p: (1.0 - p) * pg(p),
            ("lookup", "ghost", "disk", "headM", "tailM"),
        ),
        Branch(
            "miss_to_S_promote",
            lambda p: (1.0 - p) * (1.0 - pg(p)) * pm(p),
            ("lookup", "ghost", "disk", "headS", "tailS", "headM", "tailM"),
        ),
        Branch(
            "miss_to_S_evict",
            lambda p: (1.0 - p) * (1.0 - pg(p)) * (1.0 - pm(p)),
            ("lookup", "ghost", "disk", "headS", "tailS"),
        ),
    ]
    return ClosedNetwork(
        "s3fifo", tuple(stations), tuple(branches), mpl,
        description="S3-FIFO: small/main FIFO queues + ghost; hits set a bit.",
    )


# --------------------------------------------------------------------------
# Registry + paper closed forms (used by tests to pin the reproduction)
# --------------------------------------------------------------------------

POLICY_BUILDERS = {
    "lru": lru_network,
    "fifo": fifo_network,
    "prob_lru": prob_lru_network,
    "clock": clock_network,
    "slru": slru_network,
    "s3fifo": s3fifo_network,
}


def build(policy: str, disk_us: float = 100.0, mpl: int = 72,
          coalesce_flows: int = 0, coalesce_window_us=None,
          coalesce_sigma=None, coalesce_window_mode: str = "service",
          coalesce_flow_theta: float = 0.0, **kw) -> ClosedNetwork:
    """Build a policy network, optionally with miss coalescing applied.

    ``coalesce_flows > 0`` wraps the network in
    :func:`repro.core.queueing.coalesced_network`: concurrent misses on the
    same (hot) key share one backing-store fetch, so the disk sees the
    coalesced miss rate X·(1-p)·(1-σ).  ``coalesce_window_us`` overrides
    the in-flight window (default: the disk service time itself) and
    ``coalesce_sigma`` pins the coalescing factor (e.g. to a prong-C
    measured value) instead of solving it from the window.
    ``coalesce_window_mode="mva"`` extends the default window to the
    disk's MVA residence (service + estimated wait — what a bounded
    ``disk_servers`` fetch actually stays outstanding for), and
    ``coalesce_flow_theta`` skews the hot-key flow ensemble Zipf-style to
    match a trace's popularity skew.
    """
    net = POLICY_BUILDERS[policy](disk_us=disk_us, mpl=mpl, **kw)
    if coalesce_flows:
        net = coalesced_network(net, flows=coalesce_flows,
                                window_us=coalesce_window_us,
                                sigma=coalesce_sigma,
                                window_mode=coalesce_window_mode,
                                flow_theta=coalesce_flow_theta)
    return net


def paper_lru_bound(p, disk_us: float = 100.0, mpl: int = 72):
    """Paper Eq. (1)-(3), generalized over disk_us — closed form, for tests."""
    p = np.asarray(p, dtype=np.float64)
    denom1 = (Z_CACHE_LOOKUP + LRU_S_HEAD + disk_us) + (LRU_S_DELINK - disk_us) * p
    return np.minimum(mpl / denom1, 1.0 / np.maximum(LRU_S_HEAD, LRU_S_DELINK * p))


def paper_fifo_bound(p, disk_us: float = 100.0, mpl: int = 72):
    """Paper Eq. (4)-(6), generalized over disk_us."""
    p = np.asarray(p, dtype=np.float64)
    denom1 = (Z_CACHE_LOOKUP + FIFO_S_HEAD + disk_us) - (FIFO_S_HEAD + disk_us) * p
    return np.minimum(mpl / denom1, 1.0 / (FIFO_S_HEAD * (1.0 - p)))


def paper_prob_lru_bound(p, q: float, disk_us: float = 100.0, mpl: int = 72):
    """Paper Sec. 4.2 closed forms for q=0.5 / q=1-1/72 (any q via calibration)."""
    p = np.asarray(p, dtype=np.float64)
    s_delink, s_head = prob_lru_service(q)
    d_delink = (1.0 - q) * s_delink * p
    d_head = (1.0 - q * p) * s_head
    Z = Z_CACHE_LOOKUP + (1.0 - p) * disk_us
    return np.minimum(mpl / (Z + d_delink + d_head), 1.0 / np.maximum(d_delink, d_head))
