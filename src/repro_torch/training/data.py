"""The serving workload generator.

A copy of ``zipf_request_stream`` from ``src/repro/training/data.py`` (numpy
only; the training batch source there stays with queue 1 item 15).  Change
both together.
"""

from __future__ import annotations

import numpy as np


def zipf_request_stream(n_requests: int, n_prefixes: int, prefix_len: int,
                        vocab: int, theta: float = 0.99, seed: int = 0,
                        new_tokens: int = 8):
    """Serving workload: requests share Zipf-popular prefixes (the serving
    analogue of the paper's Zipf block workload).  Returns a list of
    (prefix_id, tokens) with tokens = shared prefix + unique suffix."""
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, vocab, size=(n_prefixes, prefix_len))
    ranks = np.arange(1, n_prefixes + 1, dtype=np.float64)
    p = ranks**-theta
    p /= p.sum()
    perm = rng.permutation(n_prefixes)
    out = []
    for _ in range(n_requests):
        pid = perm[rng.choice(n_prefixes, p=p)]
        suffix = rng.integers(0, vocab, size=(new_tokens,))
        out.append((int(pid), np.concatenate([prefixes[pid], suffix])))
    return out
