"""Trace replay, the Mattson LRU sweep and delayed-hit classification
(port of ``repro.cache.replay``).

* :func:`replay_grid` replays a (capacity x seed) grid through one policy
  on the flat engine: the replay kernel on the card, its plain PyTorch
  version (:mod:`repro_torch.cache.flat`) on the CPU.
* :func:`lru_sweep` is the exact one-pass LRU sweep over every capacity
  (host numpy, copied from the reference).
* :func:`classify_inflight` overlays an MSHR-style in-flight window on an
  already replayed trace: true miss / true hit / delayed hit.

The window plumbing (:func:`_window_stream`, :func:`refetch_attempts`)
draws from the same ``SeedSequence`` substreams as the reference, so the
same seeds give the same windows.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from numpy.typing import ArrayLike

from repro_torch import resolve_device

TRUE_MISS, TRUE_HIT, DELAYED_HIT = 0, 1, 2
_FAR_PAST = np.int32(-(2**30))  # "no fetch ever" sentinel for last-fetch times


class ReplayResult(NamedTuple):
    """Per-request replay outputs (leading axes: [capacity, [seed,]] ).

    ``ops`` columns are (delink, head, tail, scan) — the paper's queue
    stations.
    """

    hits: np.ndarray  # bool   (..., T)
    evicted: np.ndarray  # int64  (..., T), -1 when none
    ops: np.ndarray  # int64  (..., T, 4)


def _padded(capacity: int, pad_to: int | None) -> int:
    """Resolve the slot-array size: ``pad_to`` (defaulting to capacity)."""
    pad = int(capacity if pad_to is None else pad_to)
    if pad < capacity:
        raise ValueError(f"pad_to={pad} < capacity={capacity}")
    return pad


def _resolve_key_space(keys: ArrayLike, key_space: int | None) -> int:
    """Resolve and VALIDATE the key space: out-of-range keys must fail
    loudly (a key-indexed table would otherwise be read out of range)."""
    keys = np.asarray(keys)
    if keys.size and keys.min() < 0:
        raise ValueError("trace keys must be non-negative")
    kmax = int(keys.max()) if keys.size else -1
    if not key_space:
        return kmax + 1
    if kmax >= int(key_space):
        raise ValueError(f"trace key {kmax} out of range for "
                         f"key_space={int(key_space)}")
    return int(key_space)


def _count_leq_before(x: np.ndarray, span: int) -> np.ndarray:
    """c[t] = #{s < t : x[s] <= x[t]}, by bottom-up merge counting.

    O(T log^2 T) in vectorized numpy: at each level, elements of every
    right half-block are ranked into their sorted left half-block with one
    global ``searchsorted`` (rows made disjoint by adding ``i * span``,
    which requires every value to sit in [0, span - 1]).
    """
    T = len(x)
    n = 1 << max(1, int(T - 1).bit_length())
    pad_val = span - 1  # sorts after every real value, never counted
    xp = np.full(n, pad_val, np.int64)
    xp[:T] = x
    counts = np.zeros(n, np.int64)
    w = 1
    while w < n:
        npair = n // (2 * w)
        blocks = xp.reshape(npair, 2 * w)
        left_sorted = np.sort(blocks[:, :w], axis=1)
        offs = np.arange(npair, dtype=np.int64)[:, None] * span
        flat_left = (left_sorted + offs).ravel()
        pos = np.searchsorted(flat_left, (blocks[:, w:] + offs).ravel(),
                              side="right")
        c = pos - np.repeat(np.arange(npair, dtype=np.int64) * w, w)
        idx = (np.arange(npair)[:, None] * 2 * w + w
               + np.arange(w)[None, :]).ravel()
        counts[idx] += c
        w *= 2
    return counts[:T]


def lru_sweep(keys: ArrayLike,
              capacities: ArrayLike) -> tuple[np.ndarray, np.ndarray]:
    """Exact LRU replay of one trace at EVERY capacity in one pass.

    LRU is a stack algorithm (Mattson et al. 1970): a request hits at
    capacity C iff its stack distance d (distinct keys touched since its
    previous access) satisfies d < C.  With P[t] the previous occurrence
    of key_t and D_t the number of distinct keys seen before t,
    ``d_t = D_t - P[t] - 1 + C_t`` where ``C_t = #{s < t : 0 <= P[s] <=
    P[t]}`` is the merge-count above.

    Returns (hits, ops) shaped (len(capacities), T) / (..., 4): hit ->
    (1,1,0,0), miss -> (0,1,evict,0).  Evicted keys are not tracked.
    """
    keys = np.asarray(keys, np.int64)
    T = len(keys)
    order = np.lexsort((np.arange(T), keys))
    sk = keys[order]
    P = np.full(T, -1, np.int64)
    same = sk[1:] == sk[:-1]
    P[order[1:][same]] = order[:-1][same]
    first = P < 0
    D = np.cumsum(first) - first  # distinct keys seen strictly before t
    # first occurrences get a sentinel above every real P so they are never
    # counted as expired stack positions (and never produce hits anyway).
    x = np.where(first, np.int64(T + 1), P)
    C = _count_leq_before(x, span=T + 4)
    d = D - P - 1 + C

    caps = np.asarray(list(capacities), np.int64)[:, None]
    hits = (~first)[None, :] & (d[None, :] < caps)
    evict = (~hits) & (D[None, :] >= caps)
    ops = np.zeros((len(caps), T, 4), np.int64)
    ops[..., 0] = hits  # delink on every hit
    ops[..., 1] = 1  # head update on every request
    ops[..., 2] = evict  # tail update when a miss evicts
    return hits, ops


def replay_grid(policy: str, keys: ArrayLike, us: ArrayLike,
                capacities: ArrayLike, *, key_space: int | None = None,
                pad_to: int | None = None, device: str = "cuda",
                **params: Any) -> ReplayResult:
    """Replay a (capacity x seed) measurement grid on the flat engine.

    ``keys``/``us`` are (T,) for a single stream or (S, T) for S seed
    streams.  Returns host arrays shaped (len(capacities), S, T[, 4]).
    """
    from repro_torch.kernels.replay import replay_grid_fused, unpack_grid_ops

    keys = np.atleast_2d(np.asarray(keys))
    us = np.atleast_2d(np.asarray(us))
    res = replay_grid_fused(policy, keys, us, capacities, key_space=key_space,
                            pad_to=pad_to, device=device, **params)
    return ReplayResult(res.hits.cpu().numpy(),
                        res.evicted.cpu().numpy().astype(np.int64),
                        unpack_grid_ops(res))


# ---------------------------------------------------------------------------
# Delayed-hit (in-flight window) classification.
# ---------------------------------------------------------------------------


def refetch_attempts(n: int, fail_prob: float, seed: int = 0) -> np.ndarray:
    """Per-request fetch attempt counts under TTL-style failure/re-issue.

    Geometric(1 - fail_prob) >= 1 attempts behind each request's fetch,
    drawn from the fourth ``SeedSequence(seed)`` substream, as the
    reference draws them.  ``fail_prob=0`` yields all-ones.
    """
    if not 0.0 <= fail_prob < 1.0:
        raise ValueError("fail_prob must be in [0, 1)")
    if fail_prob == 0.0:
        return np.ones(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(4)[3])
    return rng.geometric(1.0 - fail_prob, size=n).astype(np.int64)


def _window_stream(window: ArrayLike | None, n_t: int, fail_prob: float,
                   fail_seed: int) -> np.ndarray:
    """Scalar or (T,) windows, validated and stretched by TTL re-issue
    attempts, resolved to an int32 (T,) stream — the single source of the
    fetch-expiry semantics for the classifier and the replay kernel."""
    windows = np.asarray(0 if window is None else window, dtype=np.int64)
    if windows.ndim > 1:
        raise ValueError(f"window must be a scalar or (T,), got {windows.shape}")
    if np.any(windows < 0):
        raise ValueError("window must be >= 0")
    if windows.ndim == 1 and windows.shape[0] != n_t:
        raise ValueError(f"per-request windows {windows.shape} vs "
                         f"{n_t} requests")
    out = np.broadcast_to(windows, (n_t,))
    if fail_prob:
        out = out * refetch_attempts(n_t, fail_prob, fail_seed)
    return out.astype(np.int32)


def _classify_lanes(keys: torch.Tensor, hits: torch.Tensor,
                   windows: torch.Tensor, key_space: int) -> torch.Tensor:
    """Classify ``(L, T)`` lanes against per-request windows.

    The carried state is the per-key fetch *expiry* index: the fetch that
    started at t with window w stays outstanding through t + w.  Returns
    ``(L, T)`` int8 classes on the lanes' device.
    """
    n_l, n_t = keys.shape
    dev = keys.device
    expiry = torch.full((n_l, key_space), int(_FAR_PAST), dtype=torch.int32,
                        device=dev)
    cls = torch.empty((n_l, n_t), dtype=torch.int8, device=dev)
    lane = torch.arange(n_l, device=dev)
    keys = keys.long()
    hits = hits.bool()
    windows = windows.to(torch.int32)
    for t in range(n_t):
        k = keys[:, t]
        h = hits[:, t]
        outstanding = t <= expiry[lane, k]
        cls[:, t] = torch.where(outstanding, DELAYED_HIT,
                                torch.where(h, TRUE_HIT, TRUE_MISS)).to(torch.int8)
        starts = ~outstanding & ~h
        expiry[lane, k] = torch.where(starts, t + windows[:, t], expiry[lane, k])
    return cls


def classify_inflight(keys: ArrayLike, hits: ArrayLike | torch.Tensor,
                      window: ArrayLike, key_space: int | None = None,
                      fail_prob: float = 0.0, fail_seed: int = 0,
                      device: str = "cuda") -> np.ndarray:
    """Classify each replayed request as true hit / delayed hit / true miss.

    A miss at request ``t`` starts a fetch that stays outstanding for the
    next ``window`` requests (scalar, or one window per request).  A
    request for the same key inside that window is a **delayed hit**
    (Manohar et al. 2020), whatever the policy called it; requests outside
    any window keep their policy classification, and each true miss
    starts a fresh fetch.  ``fail_prob`` stretches each fetch's window by
    its geometric re-issue attempts (:func:`refetch_attempts` at
    ``fail_seed``).

    ``keys`` is (T,) or (S, T); ``hits`` is (..., T) with any leading grid
    axes (when ``keys`` is (S, T) the second-to-last hits axis must be S).
    ``window`` may also be shaped like ``hits`` (at least 2-D): one window
    stream per hits row, every row still classified in the same single
    pass over the requests, each bit for bit as that row alone with its
    own window.  Returns int8 classes shaped like ``hits``, {TRUE_MISS=0,
    TRUE_HIT=1, DELAYED_HIT=2}, as a host array.
    """
    dev = resolve_device(device)
    keys = np.asarray(keys)
    hits_t = torch.as_tensor(hits).to(dev)
    n_t = int(keys.shape[-1])
    per_row = np.asarray(0 if window is None else window)
    if per_row.ndim >= 2:
        if per_row.shape != tuple(hits_t.shape):
            raise ValueError(f"per-row windows {per_row.shape} vs hits "
                             f"{tuple(hits_t.shape)}")
        windows = np.stack([_window_stream(w, n_t, fail_prob, fail_seed)
                            for w in per_row.reshape(-1, n_t)])
    else:
        windows = _window_stream(window, n_t, fail_prob, fail_seed)
    key_space = _resolve_key_space(keys, key_space)
    if keys.ndim == 1:
        keys2 = keys[None, :]
    elif keys.ndim == 2:
        keys2 = keys
    else:
        raise ValueError(f"keys must be (T,) or (S, T), got {keys.shape}")
    if hits_t.shape[-1] != keys2.shape[-1]:
        raise ValueError(f"hits {tuple(hits_t.shape)} vs keys {keys.shape}: "
                         "trailing request axes differ")
    S = keys2.shape[0]
    flat_h = hits_t.reshape(-1, hits_t.shape[-1])
    if S > 1:
        if hits_t.ndim < 2 or hits_t.shape[-2] != S:
            raise ValueError(f"hits {tuple(hits_t.shape)} second-to-last axis "
                             f"must match {S} key streams")
        key_lane = np.tile(np.arange(S), flat_h.shape[0] // S)
    else:
        key_lane = np.zeros(flat_h.shape[0], np.int64)
    n_l = flat_h.shape[0]
    cls = _classify_lanes(
        torch.from_numpy(keys2[key_lane].astype(np.int64)).to(dev), flat_h,
        torch.from_numpy(np.broadcast_to(windows, (n_l, n_t)).copy()).to(dev),
        key_space)
    return cls.cpu().numpy().reshape(tuple(hits_t.shape))

