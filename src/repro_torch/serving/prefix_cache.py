"""Host-side prefix cache controller — where the paper lives in serving.

A copy of ``src/repro/serving/prefix_cache.py`` (numpy and Python only),
kept in the port so that ``repro_torch`` imports nothing of ``repro``;
``chunk_hashes`` uses Python's ``hash`` of int tuples, which is the same in
every process, so the port's hashes equal the reference's.  Change both
together.

Token prefixes are chunked at page granularity and hashed with a rolling
(parent, chunk) hash; chunk-hash -> page-id entries are managed by ANY of
the Table-1 eviction policies (repro_torch.cache.py_ref).  Every controller
operation's metadata ops are accounted against the paper's queue stations
(delink / head / tail / scan), so a serving run yields exactly the
measurements the queueing model consumes (benchmarks/serving_integration).

LRU here = vLLM/SGLang-style prefix caching; the paper predicts (and the
benchmark shows) its controller saturates at high hit ratio, while
S3-FIFO/SIEVE/CLOCK controllers do not — the actionable finding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cache.py_ref import PY_POLICIES
from repro_torch.serving.kv_pages import PageAllocator

HASH_SEED = 0x9E3779B97F4A7C15


def chunk_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Rolling hash per full chunk: h_i = H(h_{i-1}, tokens of chunk i)."""
    out = []
    h = HASH_SEED
    n_full = len(tokens) // page_size
    for i in range(n_full):
        chunk = tuple(int(t) for t in tokens[i * page_size : (i + 1) * page_size])
        h = hash((h, chunk)) & 0x7FFFFFFFFFFFFFFF
        out.append(h)
    return out


@dataclasses.dataclass
class ControllerStats:
    lookups: int = 0
    chunk_hits: int = 0
    chunk_misses: int = 0
    inserts: int = 0
    evictions: int = 0
    ops: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, dtype=np.int64)
    )
    bypassed: int = 0

    @property
    def hit_ratio(self) -> float:
        tot = self.chunk_hits + self.chunk_misses
        return self.chunk_hits / tot if tot else 0.0


class PrefixCache:
    """chunk-hash -> page-id map under a pluggable eviction policy."""

    def __init__(self, allocator: PageAllocator, capacity: int,
                 policy: str = "lru", **policy_kwargs):
        if capacity > allocator.n_pages:
            raise ValueError("prefix cache capacity exceeds page pool")
        self.allocator = allocator
        self.policy_name = policy
        self.policy = PY_POLICIES[policy](capacity, **policy_kwargs)
        self.pages: dict = {}  # chunk_hash -> page_id
        self.stats = ControllerStats()

    # -- lookup walks chunks until the first miss (prefix property) --------
    def lookup(self, hashes: List[int]) -> Tuple[List[int], int]:
        """Returns (hit page ids, number of hit chunks).

        Only hit chunks touch the policy (promotion ops on the hit path —
        the paper's delink+head for LRU).  Misses are charged at insert.
        """
        self.stats.lookups += 1
        hit_pages: List[int] = []
        for h in hashes:
            if h not in self.pages:
                break
            a = self.policy.access(h)
            assert a.hit, "policy/table divergence"
            self.stats.ops += np.asarray(a.ops, dtype=np.int64)
            self.stats.chunk_hits += 1
            hit_pages.append(self.pages[h])
        self.stats.chunk_misses += len(hashes) - len(hit_pages)
        return hit_pages, len(hit_pages)

    # -- insert a freshly computed chunk ----------------------------------
    def insert(self, chunk_hash: int, u: float = 0.0) -> Optional[int]:
        """Allocate a page for the chunk; returns page_id (None if present).

        The policy access is a miss -> insertion (+ possible eviction whose
        page returns to the allocator): the paper's miss-path tail+head ops.
        """
        if chunk_hash in self.pages:
            return None
        a = self.policy.access(chunk_hash, u)
        assert not a.hit
        self.stats.ops += np.asarray(a.ops, dtype=np.int64)
        self.stats.inserts += 1
        if a.evicted_key != -1 and a.evicted_key in self.pages:
            self.allocator.free(self.pages.pop(a.evicted_key))
            self.stats.evictions += 1
        page_id = self.allocator.alloc()
        self.pages[chunk_hash] = page_id
        return page_id

    def mean_ops_per_chunk(self) -> Tuple[np.ndarray, np.ndarray]:
        """(hit-path, miss-path) mean op vectors — queueing-model inputs."""
        hits = max(self.stats.chunk_hits, 1)
        misses = max(self.stats.inserts, 1)
        # promotion ops happen on lookup hits; insert ops on misses.  The
        # split is exact for the list policies because hit ops and miss ops
        # are disjoint events in this controller.
        hit_ops = np.zeros(4, np.float64)
        miss_ops = np.zeros(4, np.float64)
        if self.policy_name in ("lru", "slru", "prob_lru"):
            # delink ops only occur on hits for these policies
            hit_ops[0] = self.stats.ops[0] / hits
            hit_ops[1] = self.stats.ops[0] / hits  # paired head update
            miss_ops[1] = max(self.stats.ops[1] - self.stats.ops[0], 0) / misses
            miss_ops[2] = self.stats.ops[2] / misses
        else:  # FIFO-like: all ops are on the miss path
            miss_ops = self.stats.ops.astype(np.float64) / misses
        return hit_ops, miss_ops
