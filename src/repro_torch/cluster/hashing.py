"""Consistent-hash routing: how a key stream becomes per-shard substreams.

The port's copy of ``repro.cluster.hashing`` (``src/repro/cluster/hashing.py``):
numpy on the host, integer-exact, so every function returns what the
reference returns.

A cache *cluster* sits behind a hash router: every key is owned by exactly
one shard, so the cluster-level workload is the single-node workload
partitioned by the router.  Two routers are provided:

* :class:`HashRing` — classic consistent hashing (Karger et al. 1997):
  each shard owns ``vnodes`` pseudo-random points on a 64-bit ring and a
  key belongs to the first shard point clockwise of its hash.  Removing a
  shard only re-homes the keys that shard owned (the property the scheme
  exists for); load balance improves with ``vnodes`` but stays imperfect.
* :func:`two_choice_assignment` — a static power-of-two-choices map: keys
  are placed, heaviest first, on the lighter-loaded of two hash
  candidates (Mitzenmacher 1996).  Much tighter balance than the ring at
  the cost of storing the full key→shard map.

Everything downstream consumes a plain ``assign`` array (key id → shard),
so the two routers — or any external placement — are interchangeable.
The *measured* skew of a placement is summarized by
:func:`shard_weights` (exact per-shard request shares under a known key
popularity) and :func:`imbalance` (hottest shard's load relative to a
perfectly balanced split); under Zipf popularity the ring's imbalance is
what moves the cluster's saturation knee (see :mod:`repro_torch.cluster.model`).

Hashing is splitmix64 — deterministic, dependency-free, vectorized over
numpy uint64 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from numpy.typing import ArrayLike

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: ArrayLike) -> np.ndarray:
    """splitmix64, vectorized: the generator's golden-ratio state
    increment (so x and x+1 land far apart) followed by its finalizer."""
    x = np.asarray(x).astype(np.uint64) + _GOLDEN
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash2(a: ArrayLike, b: ArrayLike, seed: int) -> np.ndarray:
    return _mix64(_mix64(np.uint64(seed) ^ np.asarray(a, np.uint64))
                  ^ np.asarray(b, np.uint64))


@dataclasses.dataclass(frozen=True)
class HashRing:
    """Consistent-hash ring over integer keys.

    ``shards`` are arbitrary integer ids (default ``0..n_shards-1``);
    each contributes ``vnodes`` ring points.  Construction is pure, so
    :meth:`without` / :meth:`with_shard` return *new* rings sharing every
    surviving shard's points — the membership-change stability tests pin
    exactly that.
    """

    n_shards: int
    vnodes: int = 64
    seed: int = 0
    shards: tuple[int, ...] = ()
    _pos: np.ndarray = dataclasses.field(init=False, repr=False, compare=False)
    _owner: np.ndarray = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        shards = self.shards or tuple(range(self.n_shards))
        if len(set(shards)) != len(shards) or not shards:
            raise ValueError(f"bad shard id list {shards}")
        object.__setattr__(self, "shards", tuple(int(s) for s in shards))
        object.__setattr__(self, "n_shards", len(shards))
        sid = np.repeat(np.asarray(self.shards, np.uint64), self.vnodes)
        rep = np.tile(np.arange(self.vnodes, dtype=np.uint64),
                      len(self.shards))
        pos = _hash2(sid, rep, self.seed)
        order = np.argsort(pos, kind="stable")
        object.__setattr__(self, "_pos", pos[order])
        object.__setattr__(self, "_owner",
                           sid[order].astype(np.int64))

    def shard_of(self, keys: ArrayLike) -> np.ndarray | int:
        """Vectorized key → shard lookup (first ring point clockwise)."""
        h = _mix64(np.asarray(keys, np.uint64) ^ np.uint64(self.seed))
        idx = np.searchsorted(self._pos, h, side="left") % len(self._pos)
        out = self._owner[idx]
        return out if np.ndim(keys) else int(out)

    def assignment(self, key_space: int) -> np.ndarray:
        """Dense key → shard map for keys ``0..key_space-1``."""
        return self.shard_of(np.arange(key_space))

    def without(self, shard: int) -> "HashRing":
        """Ring with ``shard`` removed; all other shards keep their keys."""
        rest = tuple(s for s in self.shards if s != shard)
        if len(rest) == len(self.shards):
            raise KeyError(shard)
        return HashRing(len(rest), self.vnodes, self.seed, shards=rest)

    def with_shard(self, shard: int) -> "HashRing":
        return HashRing(self.n_shards + 1, self.vnodes, self.seed,
                        shards=self.shards + (int(shard),))


def two_choice_assignment(key_weights: ArrayLike, n_shards: int,
                          seed: int = 0) -> np.ndarray:
    """Static power-of-two-choices key placement.

    Keys are placed in descending weight order; each goes to whichever of
    its two hash candidates currently carries less total weight.  With
    uniform weights this is the classic balls-into-bins two-choice
    process (max load within O(log log n) of the mean); with Zipf weights
    it mainly stops the few hottest keys from landing on one shard.
    """
    w = np.asarray(key_weights, np.float64)
    if w.ndim != 1 or len(w) == 0 or np.any(w < 0):
        raise ValueError("key_weights must be a non-negative 1-D array")
    keys = np.arange(len(w), dtype=np.uint64)
    c1 = (_hash2(keys, 1, seed) % np.uint64(n_shards)).astype(np.int64)
    c2 = (_hash2(keys, 2, seed) % np.uint64(n_shards)).astype(np.int64)
    assign = np.empty(len(w), np.int64)
    loads = np.zeros(n_shards, np.float64)
    for k in np.argsort(-w, kind="stable"):
        a, b = c1[k], c2[k]
        pick = a if loads[a] <= loads[b] else b
        assign[k] = pick
        loads[pick] += w[k]
    return assign


def shard_weights(assign: ArrayLike, key_weights: ArrayLike,
                  n_shards: int | None = None) -> np.ndarray:
    """Exact per-shard request shares: the popularity mass each shard owns.

    This is the routing weight vector the analytic cluster model and the
    cluster simulator consume; the heapq oracle never sees it — its
    per-shard traffic emerges from hashing sampled keys — which is what
    makes the weight calculation differentially testable.
    """
    assign = np.asarray(assign)
    w = np.bincount(assign, weights=np.asarray(key_weights, np.float64),
                    minlength=n_shards or int(assign.max()) + 1)
    tot = w.sum()
    if tot <= 0:
        raise ValueError("key_weights carry no mass")
    return w / tot


def imbalance(weights: ArrayLike) -> float:
    """Hot-shard load factor: max shard share / balanced share (>= 1)."""
    w = np.asarray(weights, np.float64)
    return float(w.max() * len(w) / w.sum())


def partition_trace(trace: ArrayLike, assign: ArrayLike,
                    n_shards: int | None = None) -> list[np.ndarray]:
    """Split a key trace into per-shard substreams (order preserved).

    Returns ``[sub_0, ..., sub_{N-1}]`` with ``sub_k`` the requests routed
    to shard ``k`` — the inputs to per-shard Mattson sweeps / prong-C
    replay.  Empty shards yield empty arrays.  ``n_shards`` defaults to
    the largest shard id + 1 — pass it explicitly for sparse id sets
    (e.g. a ring after :meth:`HashRing.without`, whose surviving ids are
    not contiguous).
    """
    trace = np.asarray(trace)
    assign = np.asarray(assign)
    shard_of_req = assign[trace]
    n = int(n_shards or assign.max() + 1)
    return [trace[shard_of_req == k] for k in range(n)]
