"""Online measured-profile recovery from streaming-sketch estimates.

A copy of ``src/repro/obs/profile.py``, over the port's
:mod:`repro_torch.cluster.model` and :mod:`repro_torch.hierarchy.model`.
Change both together.

The observation half of the control loop: decoded
:class:`repro_torch.obs.streaming.SketchEstimates` (top-k key counts + the
windowed / EWMA rate estimators) are turned into the same profile
objects the offline Mattson-sweep path produces — a cap → hit-ratio
curve (:class:`ObservedProfile`), a cluster
:class:`repro_torch.cluster.model.ShardProfile`, or a hierarchy
:class:`repro_torch.hierarchy.model.TieredProfile` — with **no sweep**: the
recovered popularity masses feed the Che approximation directly.

This module sits *above* the cluster / hierarchy model layers, unlike
:mod:`repro_torch.obs.streaming` itself, which stays kernel-side (imported by
``repro_torch.core.simulator``) and must not close an import cycle back
through those packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster.model import ShardProfile, _default_caps
from repro_torch.hierarchy.model import che_hit, tiered_profile
from repro_torch.obs.streaming import SketchEstimates

__all__ = [
    "ObservedProfile", "estimate_key_masses", "observed_profile",
    "observed_shard_profile", "observed_tiered_profile",
]


def estimate_key_masses(est: SketchEstimates, key_space: int | None = None,
                        ) -> np.ndarray:
    """Recover a normalized key-popularity mass vector from decoded
    sketch estimates.

    Top-k keys get their SpaceSaving lower-bound share
    ``(count - err) / key_count`` (exact share on the exact twin); the
    residual mass is spread over the unseen keys as a Zipf tail whose
    exponent is fitted to the observed head (log count vs log rank).
    Which unseen id gets which tail rank is arbitrary (ascending id
    order) — irrelevant for cap → hit curves, and hash-random with
    respect to any shard assignment.

    ``key_space=None`` sizes the universe to the observed keys only (no
    tail) — the serving engine's unbounded chunk-hash space.
    """
    keys, counts, errs = est.topk()
    total = max(est.key_count, 1)
    lb = np.maximum(counts.astype(np.float64) - errs, 1.0)
    if key_space is None:
        masses = np.zeros(len(keys))
        masses[np.arange(len(keys))] = lb
        return masses / masses.sum() if len(masses) else masses
    masses = np.zeros(int(key_space))
    seen = keys[keys < key_space]
    masses[seen] = lb[: len(seen)] / total
    residual = max(1.0 - masses.sum(), 0.0)
    cold = np.flatnonzero(masses == 0)
    if residual > 0 and len(cold):
        k = len(seen)
        if k >= 4:
            ranks = np.arange(1, k + 1, dtype=np.float64)
            theta = -np.polyfit(np.log(ranks), np.log(lb[:k]), 1)[0]
            theta = float(np.clip(theta, 0.0, 3.0))
        else:
            theta = 1.0
        tail = np.arange(k + 1, k + 1 + len(cold),
                         dtype=np.float64) ** (-theta)
        masses[cold] = residual * tail / tail.sum()
    s = masses.sum()
    return masses / s if s > 0 else masses


@dataclasses.dataclass(frozen=True)
class ObservedProfile:
    """Online measured profile — produced with no Mattson sweep.

    ``hit_curve[i]`` is the Che-approximation hit ratio of an LRU cache
    of ``caps[i]`` keys under the estimated ``masses``; ``hit_frac`` /
    ``delayed_frac`` are the debiased EWMA *measured* fractions;
    ``arrival_rate`` is the latest windowed arrival rate (NaN for
    closed-loop streams); ``saturation_frac`` carries the sketch
    pressure the residual monitor alarms on."""

    caps: np.ndarray  # (C,) cache capacities (keys)
    hit_curve: np.ndarray  # (C,) Che hit ratio per capacity
    masses: np.ndarray  # (N,) estimated key-popularity masses
    hit_frac: float  # measured (EWMA, debiased), NaN before data
    delayed_frac: float
    arrival_rate: float  # per µs, NaN for closed-loop streams
    key_count: int
    saturation_frac: float

    def p_of_cap(self, cap: float) -> float:
        """Estimated hit ratio at capacity ``cap`` (interpolated)."""
        return float(np.interp(cap, self.caps, self.hit_curve))

    def cap_of_p(self, p: float) -> float:
        """Smallest capacity achieving hit ratio ``p`` (interpolated;
        clipped to the achievable range)."""
        return float(np.interp(p, self.hit_curve, self.caps))

    def p_range(self) -> tuple:
        """(min, max) achievable hit ratio over the cap grid."""
        return float(self.hit_curve[0]), float(self.hit_curve[-1])

    def shard_profile(self, assign, caps=None,
                      n_shards: int | None = None) -> ShardProfile:
        """Lift to a cluster :class:`repro_torch.cluster.model.ShardProfile`
        through ``assign``."""
        return observed_shard_profile(self.masses, assign, caps=caps,
                                      n_shards=n_shards)

    def tiered(self, l1_caps, l2_cap: float, assign,
               n_shards: int | None = None):
        """Lift to a hierarchy :class:`repro_torch.hierarchy.model.TieredProfile`
        (Che at L1 and at the L1-filtered L2 shards — same path as the
        offline builder)."""
        return observed_tiered_profile(self.masses, l1_caps, l2_cap,
                                       assign, n_shards=n_shards)


def _che_curve(masses: np.ndarray, caps: np.ndarray) -> np.ndarray:
    return np.array([float(masses @ che_hit(masses, float(c)))
                     for c in caps])


def observed_profile(est: SketchEstimates, key_space: int | None = None,
                     caps=None) -> ObservedProfile:
    """Build the online :class:`ObservedProfile` from decoded sketch
    estimates: recovered masses -> Che cap → hit curve + the measured
    EWMA fractions and latest windowed arrival rate."""
    masses = estimate_key_masses(est, key_space)
    if caps is None:
        caps = _default_caps(max(len(masses), 1))
    caps = np.asarray(caps, np.float64)
    rate = (float(est.win_arrival_rate[-1])
            if len(est.win_arrival_rate) else float("nan"))
    return ObservedProfile(
        caps=caps,
        hit_curve=_che_curve(masses, caps),
        masses=masses,
        hit_frac=est.ewma_hit_frac,
        delayed_frac=est.ewma_delayed_frac,
        arrival_rate=rate,
        key_count=est.key_count,
        saturation_frac=est.saturation_frac(),
    )


def observed_shard_profile(masses, assign, caps=None,
                           n_shards: int | None = None) -> ShardProfile:
    """Che-approximation :class:`repro_torch.cluster.model.ShardProfile` from
    estimated masses — the online analogue of
    :func:`repro_torch.cluster.model.ideal_shard_profile` (which stacks exact
    cumulative mass instead of Che occupancy)."""
    masses = np.asarray(masses, np.float64)
    assign = np.asarray(assign)
    N = int(n_shards if n_shards is not None else assign.max() + 1)
    weights = np.array([masses[assign == k].sum() for k in range(N)])
    weights = weights / weights.sum()
    if caps is None:
        caps = _default_caps(int(max((assign == k).sum()
                                     for k in range(N))))
    caps = np.asarray(caps, np.float64)
    shard_hit = np.zeros((N, len(caps)))
    for k in range(N):
        cond = masses[assign == k]
        tot = cond.sum()
        if tot <= 0:
            continue
        cond = cond / tot
        shard_hit[k] = _che_curve(cond, caps)
    shard_hit = np.maximum.accumulate(shard_hit, axis=1)
    return ShardProfile(weights=weights, caps=caps, shard_hit=shard_hit)


def observed_tiered_profile(masses, l1_caps, l2_cap: float, assign,
                            n_shards: int | None = None):
    """Online :class:`repro_torch.hierarchy.model.TieredProfile` from estimated
    masses (delegates to the offline Che builder — same math, streamed
    inputs)."""
    return tiered_profile(masses, l1_caps, l2_cap, assign,
                          n_shards=n_shards)
