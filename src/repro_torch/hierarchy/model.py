"""Tiered cache hierarchies: L1 clients → sharded L2 → origin, as ONE network.

The port's copy of ``repro.hierarchy.model`` (``src/repro/hierarchy/model.py``):
numpy on the host, over the port's :mod:`repro_torch.core.policy_models`,
:mod:`repro_torch.core.queueing`, :mod:`repro_torch.core.simspec`,
:mod:`repro_torch.latency` and the Mattson sweep of
:mod:`repro_torch.cache.replay`; every function returns the reference's
numbers.

This module generalizes :mod:`repro_torch.cluster.model`'s compose machinery
from "N parallel shards" to a tiered DAG.  A hierarchy is described by
:class:`TierSpec`s (per-tier policy network + instance count) and a
:class:`TieredProfile` (the single-knob global-p → per-tier hit-ratio
map); :func:`compose_tiers` splices the tiers' routes into one
:class:`~repro_torch.core.queueing.ClosedNetwork`:

* the L1 tier is replicated per *client* (an in-process cache per app
  server: ``l1_0:head``, ``l1_3:delink``, ...) — every client serves
  ``1/n_clients`` of the traffic at the same local hit ratio ``p1``;
* the L2 tier is replicated per *shard* (``l2_0:head``, ...) with the
  cluster weights/local hit ratios ``(w_k, p2_k)``, but its
  backing-store placeholder is replaced by the next tier down;
* one shared ``disk`` station is the origin.

An L1 miss route is the L1 miss prefix, then a full L2 route at the
sampled shard (which may itself miss to the origin), then the L1 fill
suffix.  Branch probabilities multiply along the DAG —
``(1/n1) · b1(p1) · w_k · b2(p2_k)`` — so they still sum to 1 at every
``p`` and Thm 7.1 / MVA / Erlang-C work **unchanged** on the composed
network.

Cross-tier delayed hits ride on a :class:`~repro_torch.core.simspec.MshrSpec`:
each composed miss branch acquires an outstanding-fetch entry in its
*client's* table when it enters the L2 segment (held-slot 0) and, if the
L2 misses too, a second entry in the *shard-local* origin table at the
``disk`` visit (held-slot 1).  A same-flow request parks behind either —
an in-flight L2 fetch or an in-flight origin fetch — and fills cascade:
when an origin fetch lands, the requests parked on it complete as
delayed hits and release their own L1 entries, waking *their* followers.
:func:`coalesced_hierarchy` is the analytic counterpart: per-level,
per-shard coalescing factors ``sigma1`` / ``sigma2_k`` solved as a joint
fixed point (the tiered generalization of
:func:`repro_torch.core.queueing.coalesced_network`).

Why can raising the *L1* hit ratio hurt *cluster* throughput?  With
strong coalescing most L1 misses are nearly free — they park behind an
in-flight fetch and complete with it — so the marginal benefit of more
L1 hits is small, while every extra hit still pays the L1 eviction-list
metadata (LRU delink/head).  Growing L1 also *starves* the deeper
coalescing: it absorbs exactly the hot keys whose concurrent misses used
to share fetches, so ``sigma`` falls as ``p1`` rises and misses get
more expensive per miss.  Past the tiered ``p*`` the metadata cost wins
and throughput falls — ``benchmarks/fig_hierarchy.py`` asserts both this
regime and the monotone regime (no coalescing) on the same hierarchy,
and ``chip_smoke.py``'s ``fig_hierarchy`` asserts them through this port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policy_models import POLICY_BUILDERS
from repro_torch.core.queueing import (QUEUE, THINK, Branch, ClosedNetwork,
                                       Station, _as_fn, disk_station,
                                       zipf_flow_weights)
from repro_torch.core.simspec import MshrSpec

__all__ = [
    "TierSpec", "TieredProfile", "che_hit",
    "tiered_profile", "measured_tiered_profile",
    "compose_tiers", "HierarchyModel", "hierarchy_network",
    "coalesced_hierarchy", "tier_sigma_of",
]


# --------------------------------------------------------------------------
# Per-tier hit profiles
# --------------------------------------------------------------------------


def che_hit(key_probs, cap: float) -> np.ndarray:
    """Per-key hit probabilities of an LRU-like cache of ``cap`` objects
    under IRM traffic — Che's characteristic-time (TTL) approximation.

    Every key behaves as if cached with a common TTL ``Tc``:
    ``h_i = 1 - exp(-q_i Tc)`` with ``Tc`` solving
    ``sum_i h_i = cap`` (the expected occupancy fills the cache).  Scale
    invariant in ``key_probs``, exact in the large-cache limit, and the
    standard workhorse for cache *networks* (Gallo et al.): the L2 tier
    sees the L1-filtered masses ``q_i (1 - h_i)``.
    """
    q = np.asarray(key_probs, np.float64)
    pos = q > 0
    n_pos = int(pos.sum())
    out = np.zeros_like(q)
    if cap <= 0 or n_pos == 0:
        return out
    if cap >= n_pos:
        out[pos] = 1.0
        return out
    qp = q[pos]

    def occupancy(tc: float) -> float:
        return float((1.0 - np.exp(-qp * tc)).sum())

    hi = 1.0 / float(qp.max())
    for _ in range(200):
        if occupancy(hi) >= cap:
            break
        hi *= 2.0
    lo = 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if occupancy(mid) < cap:
            lo = mid
        else:
            hi = mid
    tc = 0.5 * (lo + hi)
    out[pos] = 1.0 - np.exp(-qp * tc)
    return out


@dataclasses.dataclass(frozen=True)
class TieredProfile:
    """The single-knob map global-L1-hit-ratio → per-tier operating points.

    Sweeping a hierarchy means sweeping the *L1 capacity*; everything
    else follows.  Row ``c`` of the arrays describes the hierarchy with
    per-client L1 capacity ``caps[c]``: the L1 hit ratio ``l1_hit[c]``,
    and — because L1 filters the head of the popularity curve — the
    *reshaped* L2 stream: shard shares ``shard_weights[c]`` and local L2
    hit ratios ``l2_hit[c]`` of the filtered masses at the (fixed) L2
    capacity.  :meth:`tier_p` inverts ``l1_hit`` continuously, exactly
    like :class:`repro_torch.cluster.model.ShardProfile` inverts its global
    curve — one scalar knob ``p``, all tiers coupled through it.
    """

    caps: np.ndarray  # (C,) increasing per-client L1 capacity grid
    l1_hit: np.ndarray  # (C,) non-decreasing global L1 hit ratio
    shard_weights: np.ndarray  # (C, N) L1-miss-stream share per L2 shard
    l2_hit: np.ndarray  # (C, N) per-shard local L2 hit ratio

    def __post_init__(self):
        caps = np.asarray(self.caps, np.float64)
        h1 = np.asarray(self.l1_hit, np.float64)
        w = np.atleast_2d(np.asarray(self.shard_weights, np.float64))
        h2 = np.atleast_2d(np.asarray(self.l2_hit, np.float64))
        if h1.shape != caps.shape:
            raise ValueError(f"l1_hit {h1.shape} vs caps {caps.shape}")
        if w.shape != h2.shape or w.shape[0] != len(caps):
            raise ValueError(f"shard_weights {w.shape} vs l2_hit "
                             f"{h2.shape} vs {len(caps)} capacities")
        if np.any(np.diff(caps) <= 0):
            raise ValueError("caps must be strictly increasing")
        if np.any(np.diff(h1) < -1e-9):
            raise ValueError("l1_hit must be non-decreasing")
        if not np.allclose(w.sum(axis=1), 1.0):
            raise ValueError("shard_weights rows must sum to 1")
        object.__setattr__(self, "caps", caps)
        object.__setattr__(self, "l1_hit", h1)
        object.__setattr__(self, "shard_weights", w)
        object.__setattr__(self, "l2_hit", h2)

    @property
    def n_shards(self) -> int:
        return self.shard_weights.shape[1]

    def p_range(self) -> tuple:
        return float(self.l1_hit[0]), float(self.l1_hit[-1])

    def l1_cap(self, p: float) -> float:
        """Per-client L1 capacity achieving global L1 hit ratio ``p``."""
        return float(np.interp(float(p), self.l1_hit, self.caps))

    def tier_p(self, p: float) -> tuple:
        """``(p1, w, p2)`` at the L1 capacity where the L1 hit ratio is
        ``p`` (clamped to the achievable range): the local L1 hit ratio,
        the (N,) shard shares of the miss stream, and the (N,) local L2
        hit ratios."""
        lo, hi = self.p_range()
        p1 = min(max(float(p), lo), hi)
        c = np.interp(p1, self.l1_hit, self.caps)
        w = np.array([np.interp(c, self.caps, self.shard_weights[:, k])
                      for k in range(self.n_shards)])
        w = w / w.sum()
        p2 = np.array([np.interp(c, self.caps, self.l2_hit[:, k])
                       for k in range(self.n_shards)])
        return p1, w, p2

    @classmethod
    def constant(cls, p2, n_shards: int | None = None,
                 weights=None) -> "TieredProfile":
        """Degenerate profile: the knob *is* the L1 hit ratio
        (``p1 == p`` over [0, 1]) while the L2 operating point stays
        fixed — balanced shards at hit ratio ``p2`` (scalar, or one per
        shard).  The serving engine's natural hierarchy view: the pod's
        measured hit ratio is known, sweep the client-side L1 in front
        of it."""
        p2 = np.atleast_1d(np.asarray(p2, np.float64))
        n = int(n_shards or len(p2))
        p2 = np.broadcast_to(p2, (n,))
        w = (np.full(n, 1.0 / n) if weights is None
             else np.asarray(weights, np.float64))
        return cls(caps=np.array([0.0, 1.0]),
                   l1_hit=np.array([0.0, 1.0]),
                   shard_weights=np.tile(w, (2, 1)),
                   l2_hit=np.tile(p2, (2, 1)))


def tiered_profile(key_probs, l1_caps, l2_cap: float, assign,
                   n_shards: int | None = None) -> TieredProfile:
    """Analytic profile via Che's characteristic-time approximation.

    Each client's L1 sees the full key-popularity distribution (clients
    draw iid from the same workload), so one Che solve per L1 capacity
    gives ``h1``; the L2 tier sees the *filtered* masses
    ``q_i (1 - h1_i)``, partitioned by ``assign`` (the hash ring's
    key → shard map) and solved per shard at the fixed per-shard
    capacity ``l2_cap``.  This is the mechanism the headline inversion
    rides on: growing L1 absorbs exactly the head of the Zipf curve,
    flattening (and thinning) the stream the L2 coalescer feeds on.
    """
    q = np.asarray(key_probs, np.float64)
    q = q / q.sum()
    assign = np.asarray(assign)
    n = int(n_shards or assign.max() + 1)
    l1_caps = np.asarray(l1_caps, np.float64)
    C = len(l1_caps)
    l1_hit = np.zeros(C)
    w = np.full((C, n), 1.0 / n)
    l2_hit = np.zeros((C, n))
    for ci, c1 in enumerate(l1_caps):
        h1 = che_hit(q, float(c1))
        l1_hit[ci] = float((q * h1).sum())
        m = q * (1.0 - h1)  # filtered (L2-visible) masses
        tot = m.sum()
        if tot <= 0:
            w[ci] = w[ci - 1] if ci else 1.0 / n
            l2_hit[ci] = l2_hit[ci - 1] if ci else 0.0
            continue
        for k in range(n):
            mk = m[assign == k]
            sk = mk.sum()
            if sk <= 0:
                continue
            w[ci, k] = sk / tot
            cond = mk / sk
            l2_hit[ci, k] = float((cond * che_hit(cond, float(l2_cap))).sum())
        w[ci] = w[ci] / w[ci].sum()
    return TieredProfile(caps=l1_caps, l1_hit=l1_hit, shard_weights=w,
                         l2_hit=l2_hit)


def measured_tiered_profile(trace, l1_caps, l2_cap: float, assign,
                            n_clients: int, seed: int = 0,
                            warmup_frac: float = 0.25,
                            n_shards: int | None = None) -> TieredProfile:
    """Measured profile: per-client L1 Mattson sweeps, then per-shard L2
    sweeps of the interleaved miss stream, per L1 capacity.

    Requests are assigned to clients iid-uniformly (seeded); each
    client's substream gets one exact LRU stack-distance sweep over the
    whole ``l1_caps`` grid at once, and for every capacity the surviving
    misses — re-interleaved in trace order, routed by ``assign`` — feed
    one LRU sweep per shard at ``l2_cap``.  Prong C feeding the tiered
    model the way ``measured_shard_profile`` feeds the flat cluster.
    """
    from repro_torch.cache.replay import lru_sweep

    trace = np.asarray(trace)
    if trace.size == 0:
        raise ValueError("measured_tiered_profile needs a non-empty trace")
    assign = np.asarray(assign)
    n = int(n_shards or assign.max() + 1)
    l1_caps = np.asarray(l1_caps, np.float64)
    icaps = np.maximum(l1_caps.astype(int), 0)
    C = len(l1_caps)
    rng = np.random.default_rng(seed)
    client = rng.integers(0, n_clients, size=trace.size)
    warm = int(trace.size * warmup_frac)

    # per-client hits over the whole capacity grid at once: (C, T) bool
    hit_at = np.zeros((C, trace.size), bool)
    for c in range(n_clients):
        sel = client == c
        sub = trace[sel]
        if len(sub) < 8:
            continue
        hits, _ = lru_sweep(sub, np.maximum(icaps, 1))
        hit_at[:, sel] = np.asarray(hits, bool) & (icaps >= 1)[:, None]

    l1_hit = np.zeros(C)
    w = np.full((C, n), 1.0 / n)
    l2_hit = np.zeros((C, n))
    for ci in range(C):
        l1_hit[ci] = float(hit_at[ci, warm:].mean())
        miss_keys = trace[~hit_at[ci]]  # trace order preserved
        if miss_keys.size == 0:
            continue
        shard = assign[miss_keys]
        shares = np.bincount(shard, minlength=n).astype(np.float64)
        if shares.sum() > 0:
            w[ci] = shares / shares.sum()
        for k in range(n):
            sub2 = miss_keys[shard == k]
            if len(sub2) < 8 or l2_cap < 1:
                continue
            hits2, _ = lru_sweep(sub2, np.array([max(int(l2_cap), 1)]))
            w2 = int(len(sub2) * warmup_frac)
            l2_hit[ci, k] = float(np.asarray(hits2)[0, w2:].mean())
    l1_hit = np.maximum.accumulate(l1_hit)  # guard tiny non-monotonicity
    return TieredProfile(caps=l1_caps, l1_hit=l1_hit, shard_weights=w,
                         l2_hit=l2_hit)


# --------------------------------------------------------------------------
# Tier composition
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tier of the hierarchy: a policy network replicated
    ``n_instances`` times (per client for the L1 tier, per shard for the
    L2 tier).  ``policy`` names a :data:`POLICY_BUILDERS` entry built
    with ``kwargs``; pass ``net`` instead to use an explicit base
    network (the serving engine wraps its measured pod network this
    way).  The tier net's ``disk`` station is a *placeholder* for the
    next tier down and is stripped during composition."""

    policy: str | None = None
    n_instances: int = 1
    name: str = "l1"
    net: ClosedNetwork | None = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def build(self) -> ClosedNetwork:
        if self.net is not None:
            return self.net
        if self.policy is None:
            raise ValueError(f"tier {self.name!r} needs a policy or a net")
        return POLICY_BUILDERS[self.policy](**self.kwargs)


def _split_at_disk(visits: tuple) -> tuple:
    """(pre, post) around the tier's backing-store placeholder."""
    names = [v.split(":")[-1] for v in visits]
    i = names.index("disk")
    return visits[:i], visits[i + 1:]


def _tier_rename(net: ClosedNetwork, tier: TierSpec):
    """Station name map for instance ``i`` of a tier: queue stations are
    replicated per instance (``l1_0:head``), infinite-server think
    stations are shared across instances (``l1:lookup`` — an infinite
    server partitions trivially, as in the flat cluster composition).
    The tier's own ``disk`` placeholder is excluded (spliced away)."""
    repl = {s.name for s in net.stations
            if s.kind == QUEUE and s.name.split(":")[-1] != "disk"}

    def rename(v: str, i: int) -> str:
        return (f"{tier.name}_{i}:{v}" if v in repl else f"{tier.name}:{v}")

    return repl, rename


def compose_tiers(l1: TierSpec, l2: TierSpec,
                  profile: TieredProfile | None = None,
                  disk_us: float = 100.0, disk_servers: int = 0,
                  mpl: int | None = None,
                  name: str | None = None) -> "HierarchyModel":
    """Compose an L1 tier, a sharded L2 tier and an origin disk into one
    closed network with cross-tier MSHR annotations.

    Composed branch families, per L1 client ``i``:

    * L1 hit routes — client ``i``'s copy of each L1 hit branch,
      probability ``(1/n1) · b1(p1)``;
    * L1 miss routes — for every shard ``k`` and L2 branch ``b2``, the
      L1 miss prefix, then shard ``k``'s copy of ``b2`` (its ``disk``
      placeholder replaced by the shared origin), then the L1 fill
      suffix; probability ``(1/n1) · b1(p1) · w_k · b2(p2_k)``.

    MSHR annotations: every miss route acquires client ``i``'s table at
    its first L2 visit (held-slot 0, released when the last L2-segment
    visit completes — the data is back at the client; the L1 insertion
    suffix happens after the fill lands) and, on an L2-miss route, shard
    ``k``'s origin table at the ``disk`` visit (held-slot 1, released
    when the origin service completes).
    """
    if profile is None:
        profile = TieredProfile.constant(0.5, n_shards=l2.n_instances)
    if profile.n_shards != l2.n_instances:
        raise ValueError(f"profile has {profile.n_shards} shards, tier "
                         f"{l2.name!r} has {l2.n_instances} instances")
    n1, n2 = int(l1.n_instances), int(l2.n_instances)
    if n1 < 1 or n2 < 1:
        raise ValueError("tiers need n_instances >= 1")
    net1, net2 = l1.build(), l2.build()
    memo: dict = {}

    def tp(p: float) -> tuple:
        key = round(float(p), 12)
        if key not in memo:
            memo[key] = profile.tier_p(key)
        return memo[key]

    repl1, ren1 = _tier_rename(net1, l1)
    repl2, ren2 = _tier_rename(net2, l2)

    # ---- stations --------------------------------------------------------
    stations = [disk_station(disk_us, disk_servers)]
    # L1: shared think stations at p1, queue stations per client at p1.
    for s in net1.stations:
        if s.name.split(":")[-1] == "disk":
            continue
        svc = (lambda p, s=s: s.mean_service(tp(p)[0]))
        if s.name in repl1:
            stations += [dataclasses.replace(s, name=ren1(s.name, i),
                                             service=svc)
                         for i in range(n1)]
        else:
            stations.append(dataclasses.replace(s, name=ren1(s.name, 0),
                                                service=svc))
    # L2: shared think stations at the weight-averaged p2 (all current
    # policies' think services are constant, so this is cosmetic), queue
    # stations per shard at that shard's local p2_k.
    for s in net2.stations:
        if s.name.split(":")[-1] == "disk":
            continue
        if s.name in repl2:
            stations += [dataclasses.replace(
                s, name=ren2(s.name, k),
                service=(lambda p, s=s, k=k: s.mean_service(
                    float(tp(p)[2][k]))))
                for k in range(n2)]
        else:
            stations.append(dataclasses.replace(
                s, name=ren2(s.name, 0),
                service=(lambda p, s=s: s.mean_service(
                    float(np.dot(tp(p)[1], tp(p)[2]))))))

    # ---- branches + MSHR annotations ------------------------------------
    hits1 = [b for b in net1.branches
             if "disk" not in [v.split(":")[-1] for v in b.visits]]
    miss1 = [b for b in net1.branches if b not in hits1]
    hits2 = [b for b in net2.branches
             if "disk" not in [v.split(":")[-1] for v in b.visits]]
    miss2 = [b for b in net2.branches if b not in hits2]
    if not miss1 or not miss2:
        raise ValueError("both tier networks need a miss ('disk') branch")

    branches = []
    branch_client: list = []
    branch_shard: list = []
    branch_level: list = []
    acquires: list = []  # per branch: ((pos, group, slot), ...)
    releases: list = []  # per branch: ((pos, slot), ...)

    def add(b, client, shard, level, acq=(), rel=()):
        branches.append(b)
        branch_client.append(client)
        branch_shard.append(shard)
        branch_level.append(level)
        acquires.append(tuple(acq))
        releases.append(tuple(rel))

    for i in range(n1):
        for b1 in hits1:
            visits = tuple(ren1(v, i) for v in b1.visits)
            add(Branch(
                f"c{i}:{b1.name}",
                (lambda p, b1=b1: b1.probability(tp(p)[0]) / n1),
                visits,
            ), i, -1, 0)
        for b1 in miss1:
            pre1, post1 = _split_at_disk(b1.visits)
            pre1 = tuple(ren1(v, i) for v in pre1)
            post1 = tuple(ren1(v, i) for v in post1)
            for k in range(n2):
                def prob2(p, b1=b1, b2=None, k=k):
                    p1, w, p2 = tp(p)
                    return (b1.probability(p1) / n1 * float(w[k])
                            * b2.probability(float(p2[k])))

                for b2 in hits2:
                    seg = tuple(ren2(v, k) for v in b2.visits)
                    a0 = len(pre1)  # acquire client table entering L2
                    r0 = len(pre1) + len(seg) - 1  # fill: data back at L1
                    add(Branch(
                        f"c{i}:s{k}:{b1.name}.{b2.name}",
                        (lambda p, b2=b2, _f=prob2: _f(p, b2=b2)),
                        pre1 + seg + post1,
                    ), i, k, 1, acq=[(a0, i, 0)], rel=[(r0, 0)])
                for b2 in miss2:
                    pre2, post2 = _split_at_disk(b2.visits)
                    seg = (tuple(ren2(v, k) for v in pre2) + ("disk",)
                           + tuple(ren2(v, k) for v in post2))
                    a0 = len(pre1)
                    a1 = len(pre1) + len(pre2)  # the origin visit
                    r0 = len(pre1) + len(seg) - 1
                    if r0 == a1 and post2:
                        raise AssertionError("release collision")
                    rel = [(a1, 1), (r0, 0)] if r0 != a1 else [(r0, 0)]
                    if r0 == a1:
                        # origin is the last L2 visit: both fills land at
                        # its completion — but distinct slots must release
                        # at distinct positions for the flat (B, L) table.
                        raise ValueError(
                            f"branch {b2.name}: route ends at the disk "
                            "visit; tier networks need at least one "
                            "post-disk fill station")
                    add(Branch(
                        f"c{i}:s{k}:{b1.name}.{b2.name}",
                        (lambda p, b2=b2, _f=prob2: _f(p, b2=b2)),
                        pre1 + seg + post1,
                    ), i, k, 2, acq=[(a0, i, 0), (a1, n1 + k, 1)], rel=rel)

    # rel_slot is one entry per position; merge the (pos, slot) pairs.
    B = len(branches)
    L = max(len(b.visits) for b in branches)
    acq_group = np.full((B, L), -1, np.int32)
    acq_slot = np.full((B, L), -1, np.int32)
    rel_slot = np.full((B, L), -1, np.int32)
    for bi in range(B):
        for pos, g, s in acquires[bi]:
            acq_group[bi, pos] = g
            acq_slot[bi, pos] = s
        for pos, s in releases[bi]:
            if rel_slot[bi, pos] >= 0:
                raise ValueError(f"branch {bi}: two releases at position "
                                 f"{pos}")
            rel_slot[bi, pos] = s
    mshr = MshrSpec(acq_group=acq_group, acq_slot=acq_slot,
                    rel_slot=rel_slot, n_groups=n1 + n2, max_held=2)

    network = ClosedNetwork(
        name or f"{net1.name}-x{n1}->{net2.name}-x{n2}->origin",
        tuple(stations), tuple(branches),
        int(mpl or net1.mpl * n1),
        description=(f"tiered hierarchy: {n1} {net1.name} L1 clients -> "
                     f"{n2} {net2.name} L2 shards -> origin "
                     f"({disk_us:g}us)"),
    )
    network.validate()
    visits_pad = np.full((B, L), -1, np.int32)
    for bi, b in enumerate(branches):
        visits_pad[bi, :len(b.visits)] = 0  # shape/structure check only
    mshr.validate(visits_pad)
    return HierarchyModel(
        l1=net1, l2=net2, network=network, profile=profile,
        n_clients=n1, n_shards=n2,
        branch_client=tuple(branch_client),
        branch_shard=tuple(branch_shard),
        branch_level=tuple(branch_level),
        mshr=mshr,
    )


@dataclasses.dataclass(frozen=True)
class HierarchyModel:
    """A composed hierarchy: the network plus its tier bookkeeping.

    ``branch_level`` classifies every composed branch by where its
    request is ultimately served: 0 = L1 hit, 1 = L2 hit, 2 = origin.
    """

    l1: ClosedNetwork
    l2: ClosedNetwork
    network: ClosedNetwork
    profile: TieredProfile
    n_clients: int
    n_shards: int
    branch_client: tuple  # composed-branch index -> client (-1 n/a)
    branch_shard: tuple  # composed-branch index -> shard (-1 for L1 hits)
    branch_level: tuple  # 0 = L1 hit, 1 = L2 hit, 2 = origin
    mshr: MshrSpec

    # ---- analytic delegation --------------------------------------------
    def throughput_upper(self, p_hit, tail_mode: str = "zero"):
        return self.network.throughput_upper(p_hit, tail_mode=tail_mode)

    def mva_throughput(self, p_hit, **kw):
        return self.network.mva_throughput(p_hit, **kw)

    def p_star(self, tail_mode: str = "zero", grid: int = 2001) -> float:
        return self.network.p_star(tail_mode=tail_mode, grid=grid)

    def lambda_max(self, p_hit, tail_mode: str = "zero"):
        from repro_torch.latency import lambda_max

        return lambda_max(self.network, p_hit, tail_mode=tail_mode)

    def response_time(self, p_hit, arrival_rate: float,
                      tail_mode: str = "nominal"):
        from repro_torch.latency import response_time

        return response_time(self.network, p_hit, arrival_rate,
                             tail_mode=tail_mode)

    def level_fractions(self, p_hit: float) -> np.ndarray:
        """Analytic [L1-hit, L2-hit, origin] shares of completions."""
        out = np.zeros(3)
        for b, lvl in zip(self.network.branches, self.branch_level):
            out[lvl] += b.probability(p_hit)
        return out

    def coalesced(self, flows: int = 64, window_us=None,
                  flow_theta: float = 0.0) -> ClosedNetwork:
        """Analytic cross-tier coalescing transform of this hierarchy
        (see :func:`coalesced_hierarchy`)."""
        return coalesced_hierarchy(self, flows=flows, window_us=window_us,
                                   flow_theta=flow_theta)


def hierarchy_network(l1_policy: str, l2_policy: str, n_clients: int,
                      n_shards: int,
                      profile: TieredProfile | None = None,
                      disk_us: float = 100.0, disk_servers: int = 0,
                      mpl: int | None = None, l1_kwargs: dict | None = None,
                      l2_kwargs: dict | None = None) -> HierarchyModel:
    """Convenience builder mirroring ``cluster_network``: two policy
    names and instance counts in, a composed :class:`HierarchyModel`
    out."""
    return compose_tiers(
        TierSpec(l1_policy, n_clients, name="l1",
                 kwargs=dict(l1_kwargs or {})),
        TierSpec(l2_policy, n_shards, name="l2",
                 kwargs=dict(l2_kwargs or {})),
        profile=profile, disk_us=disk_us, disk_servers=disk_servers,
        mpl=mpl,
    )


# --------------------------------------------------------------------------
# Analytic cross-tier coalescing
# --------------------------------------------------------------------------


def coalesced_hierarchy(model: HierarchyModel, flows: int = 64,
                        window_us=None,
                        flow_theta: float = 0.0) -> ClosedNetwork:
    """Tiered generalization of
    :func:`repro_torch.core.queueing.coalesced_network`: one coalescing factor
    per MSHR *table* — ``sigma1`` for the (symmetric) per-client L1
    tables and ``sigma2_k`` for each shard-local origin table — solved
    as a joint fixed point with the throughput bound.

    Every miss branch splits three ways:

    * **park@L1** (probability × ``sigma1``): a same-flow fetch from this
      client is already in flight — the request keeps its pre-L2 visits,
      parks on ``l1:inflight`` for the expected wait (:func:`_wait_frac`
      of the L1 window — mean residual for fresh arrivals, the *full*
      next window for fill-synchronized re-parkers) and completes with
      the fill;
    * **park@origin** (× ``(1-sigma1)·sigma2_k``, L2-miss routes only):
      it leads its client's table but finds shard ``k``'s origin fetch
      in flight — pre-origin visits, then the expected origin wait on
      ``l2:inflight``;
    * **survivor** (× the complement): the full original route.

    Windows: the origin window is the origin service time (or
    ``window_us``); the L1 window is the expected L2 round-trip of a
    *leader* — hit-segment services, or miss pre-visits plus either the
    full origin trip + fill metadata (surviving) or the expected origin
    wait (parked), mixed over shards.  The fixed point evaluates X with
    exact MVA on the transformed network (the asymptotic bound is far
    too optimistic at moderate MPL and circularly inflates sigma).  Per-flow fill rates scale the
    miss masses the way the simulators route them: ``X(1-p1)/n1`` per
    client table, ``X(1-p1)w_k(1-p2_k)(1-sigma1)`` per origin table —
    the ``(1-sigma1)`` is the *starvation coupling*: the more the L1
    tables coalesce (or the higher p1 itself), the thinner the stream
    feeding the origin tables, so deep coalescing dies first.
    """
    net = model.network
    n1, n2 = model.n_clients, model.n_shards
    weights = zipf_flow_weights(flows, flow_theta)
    origin = net.station("disk")
    w2_fn = _as_fn(window_us) if window_us is not None else origin.mean_service

    hits2 = [b for b in model.l2.branches
             if "disk" not in [v.split(":")[-1] for v in b.visits]]
    miss2 = [b for b in model.l2.branches if b not in hits2]
    svc2 = {s.name: s for s in model.l2.stations}

    def seg_service(visits, p2k: float) -> float:
        return sum(svc2[v].mean_service(p2k) for v in visits
                   if v.split(":")[-1] != "disk")

    # per-branch annotation views (positions of the acquires)
    ann = []
    ag, asl = np.asarray(model.mshr.acq_group), np.asarray(model.mshr.acq_slot)
    for bi in range(len(net.branches)):
        a0 = np.nonzero(asl[bi] == 0)[0]
        a1 = np.nonzero(asl[bi] == 1)[0]
        ann.append((int(a0[0]) if a0.size else -1,
                    int(a1[0]) if a1.size else -1))

    memo: dict = {}

    def solve(p: float) -> tuple:
        key = round(float(p), 12)
        if key in memo:
            return memo[key]
        p1, w, p2 = model.profile.tier_p(p)
        W2 = float(w2_fn(p))
        s1, s2 = 0.0, np.zeros(n2)

        def l1_window(s1v, s2v) -> float:
            tot = 0.0
            for k in range(n2):
                p2k = float(p2[k])
                hit = sum(b.probability(p2k)
                          * seg_service(b.visits, p2k) for b in hits2)
                ms = 0.0
                for b in miss2:
                    pre, post = _split_at_disk(b.visits)
                    ms += b.probability(p2k) * (
                        seg_service(pre, p2k)
                        + (1.0 - s2v[k]) * (W2 + seg_service(post, p2k))
                        + s2v[k] * _wait_frac(s2v[k]) * W2)
                tot += float(w[k]) * (hit + ms)
            return tot

        for _ in range(100):
            W1 = l1_window(s1, s2)
            wait1 = _wait_frac(s1) * W1
            wait2 = _wait_frac(float(s2.mean())) * W2
            net_s = _build(model, ann, lambda _p: s1,
                           lambda _p: s2, lambda _p: wait1,
                           lambda _p: wait2)
            X = float(net_s.mva_throughput(p))
            mu1 = X * (1.0 - p1) / n1 * weights
            s1_new = float((weights * mu1 * W1 / (1.0 + mu1 * W1)).sum())
            s2_new = np.zeros(n2)
            for k in range(n2):
                mu2 = (X * (1.0 - p1) * float(w[k])
                       * (1.0 - float(p2[k])) * (1.0 - s1_new) * weights)
                s2_new[k] = float(
                    (weights * mu2 * W2 / (1.0 + mu2 * W2)).sum())
            if (abs(s1_new - s1) < 1e-12
                    and float(np.abs(s2_new - s2).max()) < 1e-12):
                s1, s2 = s1_new, s2_new
                break
            # W1 couples to sigma2; damp the joint iteration
            s1 = 0.5 * (s1 + s1_new)
            s2 = 0.5 * (s2 + s2_new)
        memo[key] = (s1, s2.copy(),
                     _wait_frac(s1) * l1_window(s1, s2),
                     _wait_frac(float(s2.mean())) * W2)
        return memo[key]

    return _build(model, ann,
                  lambda p: solve(p)[0], lambda p: solve(p)[1],
                  lambda p: solve(p)[2], lambda p: solve(p)[3])


def tier_sigma_of(net: ClosedNetwork, p_hit: float) -> tuple:
    """Recover ``(sigma1, sigma2)`` of a :func:`coalesced_hierarchy`
    network from its branch masses: the fraction of L1 misses that
    parked at a client table, and the fraction of *L1-table leaders*
    whose origin fetch was already in flight.  (0.0, 0.0) for a network
    without the tiered transform — the tiered counterpart of
    :func:`repro_torch.core.queueing.sigma_of`, reading the ``_park1`` /
    ``_park2`` naming this module's transform creates."""
    park1 = sum(b.probability(p_hit) for b in net.branches
                if b.name.endswith("_park1"))
    park2 = sum(b.probability(p_hit) for b in net.branches
                if b.name.endswith("_park2"))
    lead = sum(
        b.probability(p_hit) for b in net.branches
        if "disk" in [v.split(":")[-1] for v in b.visits]
        or b.name.endswith("_park2")
        or (not b.name.endswith(("_park1", "_park2"))
            and any(v.startswith("l2") for v in b.visits))
    )
    misses = park1 + lead
    s1 = park1 / misses if misses > 0 else 0.0
    s2 = park2 / lead if lead > 0 else 0.0
    return s1, s2


def _wait_frac(sigma: float) -> float:
    """Expected parked wait as a fraction of the in-flight window.

    A job arriving at a busy MSHR entry mid-window waits the mean
    residual (0.5 of the window), but a job *woken by a fill* that
    immediately re-misses on the same flow parks at the very start of
    the next window and waits all of it.  The fill-synchronized share
    of parked arrivals is approximately ``sigma`` itself (the fraction
    of miss completions that were themselves parked), giving the convex
    mix ``0.5·(1-sigma) + 1.0·sigma``."""
    return 0.5 * (1.0 + float(sigma))


def _build(model: HierarchyModel, ann, s1_fn, s2_fn, w1_fn, w2_fn
           ) -> ClosedNetwork:
    """Materialize the park/survive branch variants at given sigma/window
    functions (all callables of the global p).  ``w1_fn``/``w2_fn``
    give the *expected parked wait* directly (residual weighting
    included by the caller)."""
    net = model.network
    stations = net.stations + (
        Station("l1:inflight", THINK, w1_fn, dist="exp"),
        Station("l2:inflight", THINK, w2_fn, dist="exp"),
    )
    branches = []
    for bi, b in enumerate(net.branches):
        a0, a1 = ann[bi]
        if a0 < 0:
            branches.append(b)
            continue
        pf = _as_fn(b.prob)
        k = model.branch_shard[bi]
        branches.append(Branch(
            b.name + "_park1",
            (lambda p, pf=pf: pf(p) * s1_fn(p)),
            b.visits[:a0] + ("l1:inflight",),
        ))
        if a1 < 0:
            branches.append(dataclasses.replace(
                b, prob=(lambda p, pf=pf: pf(p) * (1.0 - s1_fn(p)))))
        else:
            branches.append(Branch(
                b.name + "_park2",
                (lambda p, pf=pf, k=k: pf(p) * (1.0 - s1_fn(p))
                 * float(s2_fn(p)[k])),
                b.visits[:a1] + ("l2:inflight",),
            ))
            branches.append(dataclasses.replace(
                b, prob=(lambda p, pf=pf, k=k: pf(p) * (1.0 - s1_fn(p))
                         * (1.0 - float(s2_fn(p)[k])))))
    return dataclasses.replace(
        net, name=net.name + "+coalesce", stations=stations,
        branches=tuple(branches),
    )
