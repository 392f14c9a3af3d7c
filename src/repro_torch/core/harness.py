"""Prong C: virtual-time measurement of the *implemented* caches
(port of ``repro.core.harness``).

1. Drive the flat-state cache engine with a Zipf(θ) workload at a grid of
   cache sizes: the *real* hit/miss sequence and per-request metadata-op
   counts, with delayed hits classified in the same pass.
2. Fold the observed (hit, op-vector) profiles into an *empirical* closed
   queueing network whose branch probabilities are the measured
   frequencies and whose station service times are the paper's.
3. Evaluate that network with the Thm-7.1 bound and, on request, with
   the event simulator.

Step 1 runs the replay kernel on the card (every policy, LRU included;
the whole size grid is one launch, with classification fused whenever
the sizes share a window stream) and its plain version on the CPU — the
reference's ``backend="pallas"`` route.  The key trace, the admission
coins and the miss windows come from the same ``SeedSequence`` substreams
as the reference, so the same seeds give the same streams.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.cache.replay import classify_inflight
from repro_torch.core.queueing import (
    QUEUE,
    THINK,
    Branch,
    ClosedNetwork,
    Station,
    coalesced_network,
    disk_station,
)
from repro_torch.kernels.event_sim import simulate_cells
from repro_torch.kernels.replay import replay_grid_fused, unpack_grid_ops


@dataclasses.dataclass(frozen=True)
class ServiceTimes:
    """Calibrated per-op service times (µs).  Defaults = paper's LRU numbers."""

    lookup: float = 0.51
    disk: float = 100.0
    delink: float = 0.70
    head: float = 0.59
    tail: float = 0.59
    scan: float = 0.30  # per extra tail-scan step (CLOCK 0.3·g decomposition)


# The paper's measured service times differ per policy family because queue
# lengths change the cross-core communication overhead (Sec. 3.1, 4.1).
PAPER_SERVICES = {
    "lru": ServiceTimes(),
    "fifo": ServiceTimes(head=0.73, tail=0.73),
    "prob_lru": ServiceTimes(delink=0.78, head=0.65, tail=0.65),
    "clock": ServiceTimes(head=0.65, tail=0.65),
    "slru": ServiceTimes(),
    "s3fifo": ServiceTimes(head=0.65, tail=0.65),
    "sieve": ServiceTimes(head=0.65, tail=0.65),
}


def _seed_streams(seed: int):
    """Independent substreams for (key trace, admission coins)."""
    return np.random.SeedSequence(seed).spawn(2)


def zipf_trace(n: int, key_space: int, theta: float = 0.99, seed: int = 0) -> np.ndarray:
    """Zipfian key trace (θ=0.99 — paper Sec. 3.4 workload)."""
    rng = np.random.default_rng(_seed_streams(seed)[0])
    ranks = np.arange(1, key_space + 1, dtype=np.float64)
    probs = ranks ** (-theta)
    probs /= probs.sum()
    # shuffle key identities so key id != popularity rank
    perm = rng.permutation(key_space)
    return perm[rng.choice(key_space, size=n, p=probs)].astype(np.int64)


def coin_stream(n: int, seed: int = 0) -> np.ndarray:
    """Admission-coin samples u ~ U[0,1), float32, independent of
    zipf_trace(seed)."""
    rng = np.random.default_rng(_seed_streams(seed)[1])
    return rng.random(n, dtype=np.float32)


def miss_window_stream(n: int, mean_requests: float, seed: int = 0,
                       dist: str = "exp") -> np.ndarray:
    """Per-request in-flight windows (miss latencies in requests):
    ``"exp"`` samples Exp(mean_requests) rounded to whole requests,
    ``"det"`` pins every window at the mean.  Third ``SeedSequence(seed)``
    substream."""
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(3)[2])
    if dist == "det":
        return np.full(n, int(round(mean_requests)), dtype=np.int64)
    if dist != "exp":
        raise ValueError(f"unknown window dist {dist!r} (want 'exp' or 'det')")
    return np.round(rng.exponential(mean_requests, n)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CacheMeasurement:
    policy: str
    capacity: int
    hit_ratio: float
    mean_ops_hit: np.ndarray  # mean (delink, head, tail, scan) on hits
    mean_ops_miss: np.ndarray  # ... on misses
    profiles: dict  # (hit, ops) -> frequency
    network: ClosedNetwork  # empirical-profile network
    # delayed-hit classification under an in-flight window of
    # ``miss_latency_requests`` requests (0 = classification disabled; the
    # mean window when per-request windows were used): post-warmup
    # fractions of (true miss, true hit, delayed hit).
    miss_latency_requests: int = 0
    class_fracs: np.ndarray | None = None

    def throughput_bound(self, p=None):
        return self.network.throughput_upper(self.hit_ratio if p is None else p)

    @property
    def coalesce_sigma(self) -> float:
        """Measured coalescing factor: of the requests that needed a fill
        (delayed + true miss), the fraction that found one in flight."""
        if self.class_fracs is None:
            return 0.0
        miss, _, delayed = (float(x) for x in self.class_fracs)
        return delayed / (delayed + miss) if (delayed + miss) > 0 else 0.0

    @property
    def true_hit_ratio(self) -> float:
        """Hit ratio with delayed hits reclassified out of the hit count."""
        if self.class_fracs is None:
            return self.hit_ratio
        return float(self.class_fracs[1])

    def coalesced_throughput_bound(self, p=None):
        """Thm-7.1 bound of the measured-profile network with the measured
        coalescing factor applied; the plain bound when there is none."""
        sig = self.coalesce_sigma
        if sig <= 0.0:
            return self.throughput_bound(p)
        net = coalesced_network(self.network, sigma=sig)
        return net.throughput_upper(self.hit_ratio if p is None else p)


def run_cache_trace(policy: str, capacity: int, trace: np.ndarray,
                    seed: int = 0, key_space: int | None = None,
                    pad_to: int | None = None, device: str = "cuda",
                    **policy_kwargs):
    """Replay a trace through the flat cache engine; returns (hits, ops)
    as host arrays, with the admission coins of ``coin_stream(seed)``."""
    us = coin_stream(len(trace), seed)
    res = replay_grid_fused(policy, trace, us, [int(capacity)],
                            key_space=key_space, pad_to=pad_to, device=device,
                            **policy_kwargs)
    return res.hits[0, 0].cpu().numpy(), unpack_grid_ops(res)[0, 0]


def empirical_network(
    policy: str,
    hits: np.ndarray,
    ops: np.ndarray,
    service: ServiceTimes | None = None,
    mpl: int = 72,
    warmup_frac: float = 0.25,
    disk_servers: int = 0,
) -> CacheMeasurement:
    """Build the measured-profile closed network from an execution trace.

    Scan steps are charged at a dedicated queue station.
    """
    service = service or PAPER_SERVICES.get(policy, ServiceTimes())
    w = int(len(hits) * warmup_frac)
    hits_m, ops_m = hits[w:], ops[w:]
    # profile histogram: each (hit, op-vector) row packs into one int64
    # (12 bits per op count), so the unique+count is a scalar sort
    ops64 = np.asarray(ops_m, np.int64)
    if ops64.size and ops64.max() > 0xFFF:
        raise ValueError("op count exceeds 12-bit profile packing")
    code = (
        (np.asarray(hits_m, np.int64) << 48)
        | (ops64[:, 0] << 36) | (ops64[:, 1] << 24)
        | (ops64[:, 2] << 12) | ops64[:, 3]
    )
    uniq, counts = np.unique(code, return_counts=True)
    profiles = {
        (bool(c >> 48), (int((c >> 36) & 0xFFF), int((c >> 24) & 0xFFF),
                         int((c >> 12) & 0xFFF), int(c & 0xFFF))): int(n)
        for c, n in zip(uniq, counts)
    }
    total = int(counts.sum())

    stations = [
        Station("lookup", THINK, service.lookup, dist="det"),
        disk_station(service.disk, disk_servers),
        Station("delink", QUEUE, service.delink, dist="det"),
        Station("head", QUEUE, service.head, dist="pareto",
                dist_params=(0.45, 0.1, max(2 * service.head - 0.1, 0.2))),
        Station("tail", QUEUE, service.tail, dist="det"),
        Station("scan", QUEUE, service.scan, dist="det"),
    ]
    branches = []
    for (hit, op_vec), count in sorted(profiles.items()):
        n_delink, n_head, n_tail, n_scan = op_vec
        visits = ["lookup"]
        if not hit:
            visits.append("disk")
        visits += (["delink"] * n_delink + ["head"] * n_head
                   + ["tail"] * n_tail + ["scan"] * n_scan)
        branches.append(
            Branch(
                f"{'hit' if hit else 'miss'}_{op_vec}",
                count / total,
                tuple(visits),
            )
        )
    net = ClosedNetwork(
        f"{policy}-empirical", tuple(stations), tuple(branches), mpl,
        description=f"measured-profile network for {policy}",
    )

    def mean_ops(want_hit: bool) -> np.ndarray:
        count = sum(c for (h, _), c in profiles.items() if h == want_hit)
        if not count:
            return np.zeros(4)
        acc = np.zeros(4)
        for (h, vec), c in profiles.items():
            if h == want_hit:
                acc += np.asarray(vec, np.float64) * c
        return acc / count

    n_hits = sum(c for (h, _), c in profiles.items() if h)
    hit_ratio = n_hits / total if total else 0.0
    return CacheMeasurement(
        policy=policy, capacity=-1, hit_ratio=hit_ratio,
        mean_ops_hit=mean_ops(True), mean_ops_miss=mean_ops(False),
        profiles=dict(profiles), network=net,
    )


def parameterized_network(
    policy: str,
    hit_ops,
    miss_ops,
    service: ServiceTimes | None = None,
    mpl: int = 72,
    disk_servers: int = 0,
) -> ClosedNetwork:
    """Hit-ratio-parameterized network from measured op vectors (sweeps
    p_hit with the *measured* hit/miss op profiles)."""
    service = service or PAPER_SERVICES.get(policy, ServiceTimes())
    stations = [
        Station("lookup", THINK, service.lookup, dist="det"),
        disk_station(service.disk, disk_servers),
        Station("delink", QUEUE, service.delink, dist="det"),
        Station("head", QUEUE, service.head, dist="det"),
        Station("tail", QUEUE, service.tail, dist="det"),
        Station("scan", QUEUE, service.scan, dist="det"),
    ]

    def visits(ops, miss):
        v = ["lookup"] + (["disk"] if miss else [])
        d, h, t, s = (int(round(x)) for x in ops)
        return tuple(v + ["delink"] * d + ["head"] * h + ["tail"] * t
                     + ["scan"] * s)

    branches = [
        Branch("hit", lambda p: p, visits(hit_ops, False)),
        Branch("miss", lambda p: 1.0 - p, visits(miss_ops, True)),
    ]
    return ClosedNetwork(f"{policy}-measured", tuple(stations),
                         tuple(branches), mpl)


def _class_fracs(cls, warmup_frac: float = 0.25) -> np.ndarray:
    """(true miss, true hit, delayed hit) fractions after warmup, from an
    int8 class stream (host array or tensor)."""
    cls_m = np.asarray(cls.cpu() if hasattr(cls, "cpu") else cls)
    cls_m = cls_m[..., int(cls_m.shape[-1] * warmup_frac):]
    return np.stack(
        [(cls_m == c).mean(axis=-1) for c in range(3)], axis=-1
    )


def measure_cache(
    policy: str,
    capacity: int,
    key_space: int = 4096,
    n_requests: int = 60_000,
    theta: float = 0.99,
    disk_us: float = 100.0,
    mpl: int = 72,
    seed: int = 0,
    disk_servers: int = 0,
    miss_latency_requests: int = 0,
    fetch_fail_prob: float = 0.0,
    device: str = "cuda",
    **policy_kwargs,
) -> CacheMeasurement:
    """End-to-end prong C measurement at one cache size.

    Replay and (when ``miss_latency_requests`` is nonzero: a scalar window
    or one per request) delayed-hit classification run in ONE pass of the
    flat engine.  ``fetch_fail_prob`` stretches each fetch's window by its
    geometric re-issue attempts.
    """
    trace = zipf_trace(n_requests, key_space, theta, seed)
    classify = bool(np.any(miss_latency_requests))
    res = replay_grid_fused(
        policy, trace, coin_stream(n_requests, seed), [capacity],
        key_space=key_space,
        window=miss_latency_requests if classify else None,
        fail_prob=fetch_fail_prob, fail_seed=seed, device=device,
        **policy_kwargs)
    hits = res.hits[0, 0].cpu().numpy()
    ops = unpack_grid_ops(res)[0, 0]
    service = dataclasses.replace(
        PAPER_SERVICES.get(policy, ServiceTimes()), disk=disk_us
    )
    meas = empirical_network(policy, hits, ops, service=service, mpl=mpl,
                             disk_servers=disk_servers)
    meas = dataclasses.replace(meas, capacity=capacity)
    if classify:
        meas = dataclasses.replace(
            meas,
            miss_latency_requests=int(round(float(
                np.mean(miss_latency_requests)))),
            class_fracs=_class_fracs(res.cls[0, 0]),
        )
    return meas


def sweep_cache_sizes(
    policy: str,
    sizes,
    key_space: int = 4096,
    n_requests: int = 60_000,
    theta: float = 0.99,
    disk_us: float = 100.0,
    mpl: int = 72,
    simulate: bool = False,
    sim_requests: int = 20_000,
    seed: int = 0,
    disk_servers: int = 0,
    miss_latency_requests: int = 0,
    fetch_fail_prob: float = 0.0,
    device: str = "cuda",
    **policy_kwargs,
):
    """Hit-ratio/throughput curve vs cache size — the paper's x-axis sweep.

    Every size is a lane of ONE replay launch, with the delayed-hit
    classification fused into the same pass when the sizes share a window
    stream (per-size scalar windows that differ are classified afterwards,
    every size a lane of one pass over the requests).

    ``miss_latency_requests`` — a scalar, one window per size, or one
    window per *request* (an ``(n_requests,)`` array applied to every
    size) — turns on classification and adds the per-size columns
    ``p_true_hit``, ``p_delayed``, ``sigma`` and ``x_bound_coalesced``.
    ``simulate=True`` adds ``x_sim``: each measured-profile network
    simulated at its measured hit ratio (``sim_requests``, seed 0), every
    size a lane of one event-sim launch.

    Returns dict of np arrays: size, p_hit, x_bound (+ the columns above).
    """
    dev = resolve_device(device)
    sizes = [int(c) for c in sizes]
    mlr = np.asarray(miss_latency_requests)
    if mlr.ndim == 1 and mlr.size == n_requests:
        if mlr.size == len(sizes):
            raise ValueError(
                f"ambiguous miss_latency_requests: length {mlr.size} matches "
                "both len(sizes) (per-size windows) and n_requests "
                "(per-request windows) — change one of them")
        windows = [mlr] * len(sizes)  # per-request windows, every size
    else:
        windows = list(np.broadcast_to(mlr, len(sizes)).astype(int))
    classify = any(np.any(w) for w in windows)
    out: dict = {"size": [], "p_hit": [], "x_bound": [], "x_sim": [],
                 "p_true_hit": [], "p_delayed": [], "sigma": [],
                 "x_bound_coalesced": []}

    trace = zipf_trace(n_requests, key_space, theta, seed)
    same_w = all(np.array_equal(w, windows[0]) for w in windows[1:])
    res = replay_grid_fused(
        policy, trace, coin_stream(n_requests, seed), sizes,
        key_space=key_space,
        window=windows[0] if (classify and same_w) else None,
        fail_prob=fetch_fail_prob, fail_seed=seed, device=dev,
        **policy_kwargs)
    hits_g = res.hits[:, 0].cpu().numpy()
    ops_g = unpack_grid_ops(res)[:, 0]
    cls_sizes = None
    if classify and res.cls is None:
        per_size = np.stack([np.broadcast_to(w, (n_requests,))
                             for w in windows])
        cls_sizes = classify_inflight(trace, res.hits[:, 0], per_size,
                                      key_space=key_space,
                                      fail_prob=fetch_fail_prob,
                                      fail_seed=seed, device=dev)
    service = dataclasses.replace(
        PAPER_SERVICES.get(policy, ServiceTimes()), disk=disk_us
    )
    networks = []
    for i, (c, w) in enumerate(zip(sizes, windows)):
        meas = empirical_network(policy, hits_g[i], ops_g[i],
                                 service=service, mpl=mpl,
                                 disk_servers=disk_servers)
        meas = dataclasses.replace(meas, capacity=c)
        if np.any(w):
            cls = res.cls[i, 0] if res.cls is not None else cls_sizes[i]
            meas = dataclasses.replace(
                meas,
                miss_latency_requests=int(round(float(np.mean(w)))),
                class_fracs=_class_fracs(cls),
            )
        out["size"].append(meas.capacity)
        out["p_hit"].append(meas.hit_ratio)
        out["x_bound"].append(float(meas.throughput_bound()))
        if classify:
            out["p_true_hit"].append(meas.true_hit_ratio)
            out["p_delayed"].append(
                float(meas.class_fracs[2])
                if meas.class_fracs is not None else 0.0
            )
            out["sigma"].append(meas.coalesce_sigma)
            out["x_bound_coalesced"].append(
                float(meas.coalesced_throughput_bound())
            )
        networks.append((meas.network, meas.hit_ratio, 0))
    if simulate:
        # every size's network a lane of one launch, each on the lane seed
        # simulate_network(..., seeds=(0,)) gives it: 0 * 1000 + p index 0
        out["x_sim"] = [float(x) for x in simulate_cells(
            networks, n_requests=sim_requests, device=dev)]
    return {k: np.asarray(v) for k, v in out.items() if v}
