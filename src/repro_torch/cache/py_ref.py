"""Pure-Python reference implementations of the cache eviction policies.

A copy of the policies of ``src/repro/cache/py_ref.py`` (numpy only; its
``classify_inflight_py`` is left out), kept in the port so that
``repro_torch`` imports nothing of ``repro``.  The prefix-cache controller
(:mod:`repro_torch.serving.prefix_cache`) runs them.  Change both together.

Semantics mirror ``repro.cache.policies`` exactly — same warmup slot
allocation, same bounded scans, same op accounting — so hypothesis-based
property tests can compare hit/eviction/op sequences element-wise.

These are also what the *host-side* serving controller uses (the cache
controller runs in Python on the host; the JAX versions are for on-device /
in-step use and for the batched TPU adaptation in kernels/cache_update.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Access:
    hit: bool
    evicted_key: int  # -1 if none
    ops: tuple  # (delink, head, tail, scan)


class _KeyList(list):
    """Key list with an O(1) membership set kept in sync.

    Cache lists hold each key at most once, and are only mutated through
    ``insert`` / ``pop`` / ``remove`` — exactly the operations shadowed here.
    Rebuilding ``set(self)`` per membership probe (the old ``_ListCache``
    behaviour) made every access O(n) with a hidden allocation, which times
    out the hypothesis differential tests and the host-side serving
    controller at realistic capacities.
    """

    def __init__(self, iterable=()):
        super().__init__(iterable)
        self._set = set(self)

    def insert(self, index, key):
        super().insert(index, key)
        self._set.add(key)

    def append(self, key):
        super().append(key)
        self._set.add(key)

    def pop(self, index=-1):
        key = super().pop(index)
        self._set.discard(key)
        return key

    def remove(self, key):
        super().remove(key)
        self._set.discard(key)

    def __contains__(self, key):
        return key in self._set


class _ListCache:
    """Shared machinery: key list ordered head(0) .. tail(-1)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.order: _KeyList = _KeyList()  # keys

    def __contains__(self, key):
        return key in self.order


class LRU(_ListCache):
    name = "lru"
    lru_like = True

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.order:
            self.order.remove(key)  # delink
            self.order.insert(0, key)  # head update
            return Access(True, -1, (1, 1, 0, 0))
        evicted = -1
        tail = 0
        if len(self.order) >= self.capacity:
            evicted = self.order.pop()  # tail update
            tail = 1
        self.order.insert(0, key)  # head update
        return Access(False, evicted, (0, 1, tail, 0))


class FIFO(_ListCache):
    name = "fifo"
    lru_like = False

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.order:
            return Access(True, -1, (0, 0, 0, 0))
        evicted = -1
        tail = 0
        if len(self.order) >= self.capacity:
            evicted = self.order.pop()
            tail = 1
        self.order.insert(0, key)
        return Access(False, evicted, (0, 1, tail, 0))


class ProbLRU(_ListCache):
    name = "prob_lru"
    lru_like = True

    def __init__(self, capacity: int, q: float = 0.5):
        super().__init__(capacity)
        # float32 threshold: the jax implementation compares the coin
        # against float32(q), and the harness coin stream is float32 — a
        # float64 q here would diverge from the jax backend whenever a
        # coin lands exactly on float32(q) (non-representable q like
        # 1 - 1/72 rounds DOWN in float32).
        self.q = float(np.float32(q))

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.order:
            if u >= self.q:  # promote with prob 1-q
                self.order.remove(key)
                self.order.insert(0, key)
                return Access(True, -1, (1, 1, 0, 0))
            return Access(True, -1, (0, 0, 0, 0))
        evicted = -1
        tail = 0
        if len(self.order) >= self.capacity:
            evicted = self.order.pop()
            tail = 1
        self.order.insert(0, key)
        return Access(False, evicted, (0, 1, tail, 0))


class Clock(_ListCache):
    name = "clock"
    lru_like = False

    def __init__(self, capacity: int, max_scan: int = 3):
        super().__init__(capacity)
        self.max_scan = max_scan
        self.bit: dict = {}

    def _evict(self):
        scans = 0
        heads = 0
        while True:
            s = self.order[-1]
            if self.bit.get(s, False) and scans < self.max_scan:
                self.order.pop()
                self.order.insert(0, s)  # reinsert (head update)
                self.bit[s] = False
                scans += 1
                heads += 1
            else:
                self.order.pop()
                self.bit.pop(s, None)
                return s, (0, heads, 1, scans)

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.order:
            self.bit[key] = True
            return Access(True, -1, (0, 0, 0, 0))
        evicted = -1
        ops = (0, 0, 0, 0)
        if len(self.order) >= self.capacity:
            evicted, ops = self._evict()
        self.order.insert(0, key)
        self.bit[key] = False
        ops = (ops[0], ops[1] + 1, ops[2], ops[3])
        return Access(False, evicted, ops)


class SLRU:
    name = "slru"
    lru_like = True

    def __init__(self, capacity: int, protected_frac: float = 0.5):
        self.capacity = capacity
        self.protected_cap = max(1, int(capacity * protected_frac))
        self.B: _KeyList = _KeyList()  # probationary, head..tail
        self.T: _KeyList = _KeyList()  # protected

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.T:
            self.T.remove(key)
            self.T.insert(0, key)
            return Access(True, -1, (1, 1, 0, 0))
        if key in self.B:
            self.B.remove(key)
            self.T.insert(0, key)
            d, h, t = 1, 1, 0
            if len(self.T) > self.protected_cap:
                demoted = self.T.pop()
                self.B.insert(0, demoted)
                t += 1
                h += 1
            return Access(True, -1, (d, h, t, 0))
        evicted = -1
        tail = 0
        if len(self.B) + len(self.T) >= self.capacity:
            if self.B:
                evicted = self.B.pop()
            else:
                evicted = self.T.pop()
            tail = 1
        self.B.insert(0, key)
        return Access(False, evicted, (0, 1, tail, 0))


class S3FIFO:
    name = "s3fifo"
    lru_like = False

    def __init__(self, capacity: int, small_frac: float = 0.1, max_scan: int = 3):
        if capacity < 2:
            # mirror the jax init: m_cap == 0 has no main list to evict from
            raise ValueError(
                "s3fifo needs capacity >= 2 (one small + one main slot)")
        self.capacity = capacity
        self.s_cap = max(1, int(capacity * small_frac))
        self.m_cap = capacity - self.s_cap
        self.S: _KeyList = _KeyList()
        self.M: _KeyList = _KeyList()
        self.bit: dict = {}
        # ghost is a circular buffer mutated by slot assignment, which
        # _KeyList can't shadow — keep its membership set in sync by hand.
        # A key never re-enters S (the only ghost writer) while its ghost
        # entry is live, so the ring holds no duplicates.
        self.ghost = [-1] * max(1, self.m_cap)
        self.ghost_set: set = set()
        self.ghost_pos = 0

    def _evict_m(self, max_scan=None):
        max_scan = self.__dict__.get("max_scan", 3) if max_scan is None else max_scan
        scans = 0
        heads = 0
        while True:
            s = self.M[-1]
            if self.bit.get(s, False) and scans < 3:
                self.M.pop()
                self.M.insert(0, s)
                self.bit[s] = False
                scans += 1
                heads += 1
            else:
                self.M.pop()
                self.bit.pop(s, None)
                return s, (0, heads, 1, scans)

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.S or key in self.M:
            self.bit[key] = True
            return Access(True, -1, (0, 0, 0, 0))

        ops = [0, 0, 0, 0]
        evicted = -1
        in_ghost = key in self.ghost_set

        if in_ghost and len(self.M) >= self.m_cap:
            evicted, eops = self._evict_m()
            ops = [a + b for a, b in zip(ops, eops)]

        if (not in_ghost) and len(self.S) >= self.s_cap:
            s_tail = self.S[-1]
            if self.bit.get(s_tail, False):
                if len(self.M) >= self.m_cap:
                    evicted, eops = self._evict_m()
                    ops = [a + b for a, b in zip(ops, eops)]
                self.S.pop()
                self.M.insert(0, s_tail)
                self.bit[s_tail] = False
                ops[1] += 1  # head (M)
                ops[2] += 1  # tail (S)
            else:
                self.S.pop()
                self.bit.pop(s_tail, None)
                old = self.ghost[self.ghost_pos]
                if old >= 0:
                    self.ghost_set.discard(old)
                self.ghost[self.ghost_pos] = s_tail
                self.ghost_set.add(s_tail)
                self.ghost_pos = (self.ghost_pos + 1) % len(self.ghost)
                evicted = s_tail
                ops[2] += 1

        if in_ghost:
            self.M.insert(0, key)
        else:
            self.S.insert(0, key)
        self.bit[key] = False
        ops[1] += 1
        return Access(False, evicted, tuple(ops))


class Sieve(_ListCache):
    name = "sieve"
    lru_like = False

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.bit: dict = {}
        self.hand: Optional[int] = None  # a key, or None

    def access(self, key: int, u: float = 0.0) -> Access:
        if key in self.order:
            self.bit[key] = True
            return Access(True, -1, (0, 0, 0, 0))
        evicted = -1
        ops = [0, 0, 0, 0]
        if len(self.order) >= self.capacity:
            h = self.hand if (self.hand is not None and self.hand in self.order) else self.order[-1]
            scans = 0
            while self.bit.get(h, False):
                self.bit[h] = False
                i = self.order.index(h)
                h = self.order[i - 1] if i > 0 else self.order[-1]
                scans += 1
            i = self.order.index(h)
            self.hand = self.order[i - 1] if i > 0 else None
            self.order.remove(h)
            self.bit.pop(h, None)
            evicted = h
            ops[2] += 1
            ops[3] += scans
        self.order.insert(0, key)
        self.bit[key] = False
        ops[1] += 1
        return Access(False, evicted, tuple(ops))


PY_POLICIES = {
    "lru": LRU,
    "fifo": FIFO,
    "prob_lru": ProbLRU,
    "clock": Clock,
    "slru": SLRU,
    "s3fifo": S3FIFO,
    "sieve": Sieve,
}

