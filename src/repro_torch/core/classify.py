"""LRU-like vs FIFO-like classification (paper Sec. 5.1, Tables 1-2).

A copy of ``src/repro/core/classify.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

The structural rule the paper derives: a policy is **LRU-like** iff some
serialized (queue) station receives work on the *hit path*, so its demand
grows with ``p_hit`` and eventually becomes the bottleneck — at which point
throughput *decreases* in ``p_hit``.  **FIFO-like** policies only place
queue-station work on the miss path, so demand (and queueing) vanish as
``p_hit → 1`` and throughput is monotone increasing.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.queueing import ClosedNetwork

LRU_LIKE = "LRU-like"
FIFO_LIKE = "FIFO-like"


def classify_structural(net: ClosedNetwork, eps: float = 1e-9) -> str:
    """Classify by whether any queue station's demand increases in p_hit."""
    ps = np.linspace(0.0, 1.0, 101)
    for s in net.queue_stations():
        d = np.array([net.demands(float(p), tail_mode="nominal")[s.name] for p in ps])
        if np.any(np.diff(d) > eps) and d[-1] > eps:
            return LRU_LIKE
    return FIFO_LIKE


def classify_by_throughput(net: ClosedNetwork, rel_tol: float = 0.01) -> str:
    """Classify by whether the analytic bound ever decreases in p_hit.

    Measured as the cumulative drop below the running max (robust to grid
    resolution, unlike a per-step derivative test).  The 1% behavioural
    threshold matches the paper's reading of Fig. 8: Prob-LRU at
    q = 1 - 1/N is called FIFO-like even though the bound dips ~0.2% in the
    final sliver p_hit > 1 - 1/N.
    """
    ps = np.linspace(0.0, 1.0, 2001)
    x = net.throughput_upper(ps)
    running_max = np.maximum.accumulate(x)
    drop = (running_max - x) / np.maximum(running_max, 1e-12)
    return LRU_LIKE if np.any(drop > rel_tol) else FIFO_LIKE


# Paper Table 1 (evaluated) — "does increasing hit ratio always help?"
TABLE1 = {
    "lru": ("no", LRU_LIKE),
    "fifo": ("yes", FIFO_LIKE),
    "prob_lru(q=0.5)": ("depends on q", LRU_LIKE),
    "prob_lru(q=0.986)": ("depends on q", FIFO_LIKE),
    "clock": ("yes", FIFO_LIKE),
    "slru": ("no", LRU_LIKE),
    "s3fifo": ("yes", FIFO_LIKE),
}

# Paper Table 2 (conjectured) — encoded for the classification benchmark.
TABLE2_CONJECTURE = {
    LRU_LIKE: ["ARC", "LIRS", "TinyLFU", "LeCaR", "CACHEUS", "LFU"],
    FIFO_LIKE: [
        "CLOCK-variants", "SIEVE", "QDLP", "Hyperbolic", "Random", "LHD", "LRB",
    ],
}

# Structural reason strings used in reports.
REASONS = {
    LRU_LIKE: "performs a delink/promotion on the global structure upon a cache hit",
    FIFO_LIKE: "never updates the global structure upon a cache hit "
               "(bit-set only, or no global structure at all)",
}
