"""Analytic cluster layer: per-shard queueing networks composed into one.

The port's copy of ``repro.cluster.model`` (``src/repro/cluster/model.py``):
numpy on the host, over the port's :mod:`repro_torch.core.queueing`,
:mod:`repro_torch.latency` and the Mattson sweep of
:mod:`repro_torch.cache.replay`.

A cluster of ``N`` cache shards behind a hash router is modeled as a
single :class:`~repro_torch.core.queueing.ClosedNetwork` whose queue/disk
stations are replicated per shard (``s3:head``, ``s3:disk``, ...) and
whose branches carry the routing: a request follows shard ``k``'s copy of
a single-node route with probability ``w_k * b.prob(p_k)``, where ``w_k``
is shard ``k``'s request share and ``p_k`` its *local* hit ratio.  The
composition preserves everything the single-node stack already knows how
to do — Thm-7.1 bounds, exact/approximate MVA, the event-driven
simulators, the open-loop Erlang-C layer — so the cluster inherits all
three prongs at once:

* closed bound: ``X <= min(M/(D+Z), min_{k,st} c_st / (w_k D_st(p_k)))``
  — the saturated term is the *hot shard's* bottleneck station, so skew
  (``w_max > 1/N``) caps the cluster below ``N×`` single-node peak;
* open boundary: ``lambda_max(p) = min_k lambda_max^{(k)}(p_k) / w_k``
  (the hash router cannot rebalance, so the hot shard binds); the
  rebalanced ideal ``sum_k lambda_max^{(k)}`` — what the
  per-shard min-law sum would deliver — is exposed separately, and the
  gap between the two is the price of hashing under skew;
* cluster response time: the branch mixture *is* the routing-weighted
  mixture ``R(p, lambda) = sum_k w_k R_k(p_k, w_k lambda)``.

The second ingredient is the ``p -> p_k`` map: at one global operating
point the shards do NOT sit at the same local hit ratio.  A shard owning
hotter keys serves a more concentrated substream, so at equal per-shard
capacity its local hit ratio runs *above* the cluster average — which is
exactly why the cluster-level throughput-optimal hit ratio ``p*`` falls
below the single-node forecast for LRU-like policies: the hot shard's
hit-path metadata saturates while the cluster average still looks safe.
:class:`ShardProfile` captures the map as per-shard hit-ratio curves over
a shared per-shard capacity grid, built either analytically from the key
popularity (:func:`ideal_shard_profile`) or measured from a partitioned
trace via per-shard Mattson sweeps (:func:`measured_shard_profile`).

Miss coalescing: the simulators keep shard-local MSHR tables (each
``sK:disk`` owns its own flow group; see :mod:`repro_torch.cluster.sim`), and the
analytic composition matches them through
:meth:`ClusterModel.coalesced` — ``coalesced_network`` solves one
``sigma_k`` fixed point per shard disk against that shard's own miss
rate, so hot shards coalesce more (the former single-flat-sigma caveat
is closed).
"""

from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.policy_models import POLICY_BUILDERS
from repro_torch.core.queueing import QUEUE, Branch, ClosedNetwork

__all__ = [
    "ShardProfile", "uniform_profile", "zipf_key_probs",
    "ideal_shard_profile", "measured_shard_profile",
    "compose_cluster", "ClusterModel", "cluster_network",
]


def zipf_key_probs(key_space: int, theta: float = 0.99,
                   seed: int = 0) -> np.ndarray:
    """Per-key-id request probabilities of :func:`repro_torch.core.harness.zipf_trace`.

    Reproduces the trace generator's construction exactly — Zipf(theta)
    rank masses scattered through the same seeded identity permutation —
    so analytic shard weights/profiles line up with traces drawn at the
    same ``seed``.
    """
    from repro_torch.core.harness import _seed_streams

    rng = np.random.default_rng(_seed_streams(seed)[0])
    ranks = np.arange(1, key_space + 1, dtype=np.float64)
    probs = ranks ** (-float(theta))
    probs /= probs.sum()
    perm = rng.permutation(key_space)
    out = np.empty(key_space, np.float64)
    out[perm] = probs
    return out


@dataclasses.dataclass(frozen=True)
class ShardProfile:
    """Routing weights + the global-p → per-shard local hit-ratio map.

    ``shard_hit[k, c]`` is shard ``k``'s hit ratio at per-shard capacity
    ``caps[c]`` (each row non-decreasing).  The cluster's *global* hit
    ratio at that capacity is the routing-weighted mixture
    ``g(c) = sum_k w_k shard_hit[k, c]``; :meth:`shard_p` inverts ``g``
    (continuously, by interpolation) and reads each shard's curve at the
    common capacity — one global knob, N coupled local operating points,
    exactly how a real deployment sweeps cache size.
    """

    weights: np.ndarray  # (N,) request shares, sum 1
    caps: np.ndarray  # (C,) increasing per-shard capacity grid
    shard_hit: np.ndarray  # (N, C) per-shard hit-ratio curves

    def __post_init__(self):
        w = np.asarray(self.weights, np.float64)
        caps = np.asarray(self.caps, np.float64)
        sh = np.atleast_2d(np.asarray(self.shard_hit, np.float64))
        if sh.shape != (len(w), len(caps)):
            raise ValueError(f"shard_hit {sh.shape} vs "
                             f"({len(w)}, {len(caps)})")
        if not np.isclose(w.sum(), 1.0):
            raise ValueError(f"weights sum to {w.sum()}")
        if np.any(np.diff(caps) <= 0):
            raise ValueError("caps must be strictly increasing")
        if np.any(np.diff(sh, axis=1) < -1e-9):
            raise ValueError("per-shard hit curves must be non-decreasing")
        object.__setattr__(self, "weights", w)
        object.__setattr__(self, "caps", caps)
        object.__setattr__(self, "shard_hit", sh)

    @property
    def n_shards(self) -> int:
        return len(self.weights)

    @property
    def global_hit(self) -> np.ndarray:
        return self.weights @ self.shard_hit

    def p_range(self) -> tuple:
        g = self.global_hit
        return float(g[0]), float(g[-1])

    def shard_p(self, p: float) -> np.ndarray:
        """Local hit ratios at the capacity where the global ratio is ``p``
        (clamped to the profile's achievable range)."""
        g = self.global_hit
        c = np.interp(float(p), g, self.caps)
        return np.array([np.interp(c, self.caps, self.shard_hit[k])
                         for k in range(self.n_shards)])

    def imbalance(self) -> float:
        from repro_torch.cluster.hashing import imbalance

        return imbalance(self.weights)


def uniform_profile(n_shards: int) -> ShardProfile:
    """Perfectly balanced, homogeneous shards: every shard at the global
    hit ratio (``shard_p(p) == [p]*N`` exactly).  The composition collapses
    to N scaled copies of the single node — the identity baseline the
    tests pin."""
    return ShardProfile(
        weights=np.full(n_shards, 1.0 / n_shards),
        caps=np.array([0.0, 1.0]),
        shard_hit=np.tile(np.array([0.0, 1.0]), (n_shards, 1)),
    )


def _default_caps(max_cap: int) -> np.ndarray:
    caps = np.unique(np.round(np.geomspace(1, max(max_cap, 2), 25)))
    return np.concatenate([[0.0], caps])


def ideal_shard_profile(assign, key_probs, caps=None,
                        n_shards: int | None = None) -> ShardProfile:
    """Analytic profile from the key popularity: a shard holding its
    ``c`` most popular keys serves their conditional mass.

    This is the ideal working-set (LFU-like) approximation — optimistic
    in level vs an LRU replay, but with the right *shape*: shards owning
    hotter keys have steeper curves, which is the mechanism the cluster
    knee shift rides on.  Use :func:`measured_shard_profile` for exact
    LRU curves from a real trace.  ``n_shards`` defaults to the largest
    shard id + 1; pass it explicitly when shard ids are sparse (a ring
    after :meth:`~repro_torch.cluster.hashing.HashRing.without` keeps its
    surviving ids), or the gaps become zero-weight phantom shards.
    """
    assign = np.asarray(assign)
    q = np.asarray(key_probs, np.float64)
    n = int(n_shards or assign.max() + 1)
    weights = np.bincount(assign, weights=q, minlength=n)
    weights = weights / weights.sum()
    sizes = np.bincount(assign, minlength=n)
    if caps is None:
        caps = _default_caps(int(sizes.max()))
    caps = np.asarray(caps, np.float64)
    hit = np.zeros((n, len(caps)))
    for k in range(n):
        qk = np.sort(q[assign == k])[::-1]
        if qk.size == 0 or qk.sum() <= 0:
            continue
        cum = np.concatenate([[0.0], np.cumsum(qk)]) / qk.sum()
        hit[k] = cum[np.minimum(caps.astype(int), len(qk))]
    return ShardProfile(weights=weights, caps=caps, shard_hit=hit)


def measured_shard_profile(trace, assign, caps=None,
                           warmup_frac: float = 0.25,
                           n_shards: int | None = None) -> ShardProfile:
    """Measured profile: partition ``trace`` by the router and run one
    exact Mattson stack-distance LRU sweep per substream.

    Weights are the observed per-shard request shares; ``shard_hit[k]``
    is substream ``k``'s post-warmup LRU hit ratio at every per-shard
    capacity — prong C feeding the cluster model the same way
    ``sweep_cache_sizes`` feeds the single-node one.  ``n_shards``
    follows the :func:`ideal_shard_profile` convention (dense ids;
    default largest id + 1).
    """
    from repro_torch.cache.replay import lru_sweep
    from repro_torch.cluster.hashing import partition_trace

    trace = np.asarray(trace)
    if trace.size == 0:
        raise ValueError("measured_shard_profile needs a non-empty trace")
    subs = partition_trace(trace, assign, n_shards=n_shards)
    n = len(subs)
    weights = np.array([len(s) / trace.size for s in subs])
    if caps is None:
        caps = _default_caps(int(max(len(np.unique(s)) for s in subs
                                     if len(s)) or 2))
    caps = np.asarray(caps, np.float64)
    icaps = np.maximum(caps.astype(int), 0)
    hit = np.zeros((n, len(caps)))
    for k, sub in enumerate(subs):
        if len(sub) < 8:
            continue
        hits, _ = lru_sweep(sub, np.maximum(icaps, 1))
        w = int(len(sub) * warmup_frac)
        frac = hits[:, w:].mean(axis=1)
        hit[k] = np.where(icaps >= 1, frac, 0.0)
        hit[k] = np.maximum.accumulate(hit[k])  # guard tiny non-monotonicity
    return ShardProfile(weights=weights, caps=caps, shard_hit=hit)


def compose_cluster(net: ClosedNetwork, profile: ShardProfile,
                    mpl: int | None = None,
                    name: str | None = None) -> "ClusterModel":
    """Replicate ``net``'s queue + disk stations per shard and route
    branches through them with the profile's weights and local hit ratios.

    Shared infinite-server stations (the client-side lookup/think work)
    stay single copies — an infinite server partitions trivially.  Every
    replicated station's service time is evaluated at the *shard's* local
    hit ratio (CLOCK's p-dependent tail scan, say, scans the hot shard's
    longer-resident list).  ``mpl`` defaults to ``net.mpl * n_shards``
    (one node's worth of closed-loop clients per shard).
    """
    n = profile.n_shards
    w = profile.weights
    memo: dict = {}

    def sp(p: float) -> np.ndarray:
        key = round(float(p), 12)
        if key not in memo:
            memo[key] = profile.shard_p(key)
        return memo[key]

    replicated = {s.name for s in net.stations
                  if s.kind == QUEUE or s.name.split(":")[-1] == "disk"}
    stations = [s for s in net.stations if s.name not in replicated]
    for k in range(n):
        for s in net.stations:
            if s.name not in replicated:
                continue
            stations.append(dataclasses.replace(
                s, name=f"s{k}:{s.name}",
                service=(lambda p, s=s, k=k: s.mean_service(float(sp(p)[k]))),
            ))

    branches = []
    branch_shard = []
    branch_has_disk = []
    for k in range(n):
        for b in net.branches:
            visits = tuple(f"s{k}:{v}" if v in replicated else v
                           for v in b.visits)
            branches.append(Branch(
                f"s{k}:{b.name}",
                (lambda p, b=b, k=k: float(w[k]) * b.probability(
                    float(sp(p)[k]))),
                visits,
            ))
            branch_shard.append(k)
            branch_has_disk.append(
                any(v.split(":")[-1] == "disk" for v in b.visits))

    network = ClosedNetwork(
        name or f"{net.name}-cluster{n}",
        tuple(stations), tuple(branches),
        int(mpl or net.mpl * n),
        description=f"{n}-shard hash-routed cluster of {net.name} "
                    f"(imbalance {profile.imbalance():.3f})",
    )
    return ClusterModel(base=net, network=network, profile=profile,
                        branch_shard=tuple(branch_shard),
                        branch_has_disk=tuple(branch_has_disk))


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """A composed cluster: the network plus its shard bookkeeping."""

    base: ClosedNetwork
    network: ClosedNetwork
    profile: ShardProfile
    branch_shard: tuple  # composed-branch index -> shard
    branch_has_disk: tuple  # composed-branch index -> visits a disk?

    @property
    def n_shards(self) -> int:
        return self.profile.n_shards

    # ---- closed loop -----------------------------------------------------
    def throughput_upper(self, p_hit, tail_mode: str = "zero"):
        """Cluster Thm-7.1 bound (== summed per-shard throughput: each
        shard carries ``w_k X``)."""
        return self.network.throughput_upper(p_hit, tail_mode=tail_mode)

    def shard_throughput_upper(self, p_hit, tail_mode: str = "zero"):
        """(N,) per-shard completion rates ``w_k X(p)`` at one global p."""
        x = float(self.network.throughput_upper(p_hit, tail_mode=tail_mode))
        return self.profile.weights * x

    def p_star(self, tail_mode: str = "zero", grid: int = 20001) -> float:
        return self.network.p_star(tail_mode=tail_mode, grid=grid)

    def mva_throughput(self, p_hit, **kw):
        return self.network.mva_throughput(p_hit, **kw)

    def coalesced(self, flows: int = 64, window_us=None,
                  flow_theta: float = 0.0, window_mode: str = "service",
                  ) -> ClosedNetwork:
        """Analytic shard-local miss coalescing: the composed network
        with one ``sigma_k`` fixed point per shard disk (matching the
        simulator's per-shard MSHR flow groups — ``flows`` hot flows per
        shard).  See :func:`repro_torch.core.queueing.coalesced_network`."""
        from repro_torch.core.queueing import coalesced_network

        return coalesced_network(self.network, flows=flows,
                                 window_us=window_us,
                                 window_mode=window_mode,
                                 flow_theta=flow_theta)

    # ---- open loop -------------------------------------------------------
    def lambda_max(self, p_hit, tail_mode: str = "zero"):
        """Hash-routed stability boundary min_k lambda_max^{(k)}(p_k)/w_k:
        the hot shard saturates first and the router cannot rebalance."""
        from repro_torch.latency import lambda_max

        return lambda_max(self.network, p_hit, tail_mode=tail_mode)

    def ideal_lambda_max(self, p_hit, tail_mode: str = "zero"):
        """Rebalanced ideal: the per-shard min-law sum
        ``sum_k lambda_max^{(k)}(p_k)`` — what N shards could sustain if
        load were spread to saturate every shard simultaneously.  The
        ratio to :meth:`lambda_max` is the skew penalty of hashing."""
        from repro_torch.latency import lambda_max

        p_arr = np.atleast_1d(np.asarray(p_hit, np.float64))
        out = np.empty_like(p_arr)
        for i, p in enumerate(p_arr):
            pk = self.profile.shard_p(float(p))
            out[i] = sum(
                float(lambda_max(self.base, float(pk[k]),
                                 tail_mode=tail_mode))
                for k in range(self.n_shards)
            )
        return out if np.ndim(p_hit) else float(out[0])

    def response_time(self, p_hit, arrival_rate: float,
                      tail_mode: str = "nominal"):
        """Cluster mean sojourn R(p, lambda) — the routing-weighted
        mixture over shards, via the open Erlang-C layer."""
        from repro_torch.latency import response_time

        return response_time(self.network, p_hit, arrival_rate,
                             tail_mode=tail_mode)


def cluster_network(policy: str, n_shards: int,
                    profile: ShardProfile | None = None,
                    disk_us: float = 100.0, mpl: int | None = None,
                    cores: int | None = None, disk_servers: int = 0,
                    **kw) -> ClusterModel:
    """Build a policy's single-node network and lift it to an N-shard
    cluster.  ``profile`` defaults to perfectly balanced homogeneous
    shards; pass an :func:`ideal_shard_profile` / :func:`measured_shard_profile`
    to model Zipf skew.  ``mpl`` is the *cluster-wide* closed-loop
    population (default: one single-node complement per shard)."""
    if profile is None:
        profile = uniform_profile(n_shards)
    if profile.n_shards != n_shards:
        raise ValueError(f"profile has {profile.n_shards} shards, "
                         f"asked for {n_shards}")
    base = POLICY_BUILDERS[policy](disk_us=disk_us, cores=cores,
                                   disk_servers=disk_servers, **kw)
    return compose_cluster(base, profile, mpl=mpl)
