"""Streaming observability: fixed-shape estimators that run *inside* the
request loop (port of ``repro.obs.streaming``, ``src/repro/obs/streaming.py``).

The estimator state is a small, shape-static set of tensors
(:class:`SketchState`) updated once per simulator event, so it rides inside
the event-sim kernel (``csrc/sketch.cuh``, included by its sketched
instantiations) and its plain versions (:mod:`repro_torch.kernels.event_sim`)
behind a ``sketch_cap=0`` flag that is bit-identical off: with
``sketch_cap=0`` no state exists and no sketch code runs.

Three estimator families share the state:

* **Windowed + EWMA rates** — a tumbling ring of ``N_WINDOWS`` windows
  of ``window_us`` each (completion / hit / delayed-hit / arrival
  counts, per-branch completion counts for shard heat), plus
  exponentially-weighted hit/delayed fractions with an explicit debias
  norm (``(1 - alpha)^n``).  Ring rows store their absolute window id,
  so stale rows are zeroed lazily on first touch — no per-window flush.
* **Key-popularity sketch** — a count-min sketch (``CM_DEPTH`` rows of
  deterministic integer hashes; overestimate-only by construction) and
  a SpaceSaving top-k table (``sketch_cap`` slots; every count is an
  upper bound and ``count - err`` a lower bound).  The recovery of a
  measured profile from them lives in :mod:`repro_torch.obs.profile`.
* **Per-shard heat gauges** — per-branch windowed completion rates fold
  to per-shard heat / imbalance via the model's branch → shard map.

The port's state has a leading lane axis (``L``, one lane per simulated
(seed, p) cell), and :func:`sketch_init`, :func:`stream_tick`,
:func:`stream_arrival`, :func:`stream_done`, :func:`stream_done_many` and
:func:`stream_key` are plain torch functions over every lane at once,
each with a per-lane ``mask``; they update the state in place.  A lane a
mask leaves out is not touched at all: where the reference steers a masked
update into the scrap row (index ``-1``) of each array, the port writes
nothing, so its scrap rows stay as :func:`sketch_init` made them (decoding
drops them either way).  The float32 arithmetic is the reference's as XLA's
CPU backend compiles it: the EWMA step ``s * decay + where(x, a, 0)`` is
one fused multiply-add (:func:`~repro_torch.fma_f32`; the kernel's
``__fmaf_rn``), the window id is ``floor(elapsed_us / float32(window_us))``
by IEEE float32 division, and ``stream_done_many``'s ``(1 - alpha)^n`` is
read from one float32 table (:func:`pow_table`) that the kernel reads
too.  The hashes are uint32 arithmetic with wraparound, computed in int64
masked to 32 bits, each multiply split into 16-bit halves so that no
product leaves int64.

The host side (:class:`SketchEstimates`, :func:`decode_sketch`,
:func:`decode_sketch_grid`, :func:`sketch_trace_py` and the exact-counting
twin :class:`PyStreamSketch`) is the reference's numpy, copied as it is;
:func:`decode_sketch` takes any object with :class:`SketchState`'s field
names whose leaves are numpy arrays or tensors (one lane), the reference's
state among them.  Sketch error bounds documented here and asserted by
tests: count-min never underestimates; SpaceSaving ``count - err <= true
<= count``; top-k recall >= 0.9 at the default widths on Zipf streams.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import fma_f32, resolve_device

__all__ = [
    "CM_DEPTH", "N_WINDOWS", "EWMA_ALPHA",
    "SketchState", "SketchEstimates", "PyStreamSketch",
    "sketch_init", "stream_tick", "stream_arrival", "stream_key",
    "stream_done", "stream_done_many", "pow_table",
    "decode_sketch", "decode_sketch_grid",
    "sketch_trace", "sketch_trace_py",
]

#: Tumbling windows kept in the ring (plus one scrap row).
N_WINDOWS = 64
#: Count-min hash rows.
CM_DEPTH = 4
#: Per-completion EWMA decay for the hit/delayed fraction estimators.
EWMA_ALPHA = 0.01

# Distinct odd 32-bit salts, one per count-min row (splitmix/murmur
# finalizer constants — any fixed odd constants work).
_CM_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
_CM_MULT = 0x9E3779B1
_MIX_A = 0x7FEB352D
_MIX_B = 0x846CA68B
_M32 = 0xFFFFFFFF


def cm_width(sketch_cap: int) -> int:
    """Count-min columns for a given SpaceSaving capacity: 8x the top-k
    width (error ~ 2/width of the stream length per row) with a floor."""
    return max(64, 8 * int(sketch_cap))


class SketchState(NamedTuple):
    """The streaming estimator state of ``L`` lanes (the reference's field
    names; each field has a leading lane axis).

    All integer counters are int32; EWMA scalars are float32.  Ring arrays
    carry ``n_windows + 1`` rows and the SpaceSaving table ``sketch_cap +
    1`` rows — the extra row is the reference's scrap row, which the port
    never writes.  ``win_id`` holds the absolute tumbling-window index
    occupying each ring row (-1 = never used)."""

    win_id: torch.Tensor  # (L, W+1) i32 absolute window index, -1 empty
    win_done_count: torch.Tensor  # (L, W+1) i32 completions
    win_hit_count: torch.Tensor  # (L, W+1) i32 hit-branch completions
    win_delayed_count: torch.Tensor  # (L, W+1) i32 delayed-hit completions
    win_arrival_count: torch.Tensor  # (L, W+1) i32 arrivals (open loop)
    win_branch_count: torch.Tensor  # (L, W+1, B) i32 per-branch completions
    ewma_hit_frac: torch.Tensor  # (L,) f32, debias with ewma_norm_frac
    ewma_delayed_frac: torch.Tensor  # (L,) f32
    ewma_norm_frac: torch.Tensor  # (L,) f32 (1-alpha)^n debias norm
    cm_count: torch.Tensor  # (L, CM_DEPTH, width+1) i32, last col scrap
    ss_key: torch.Tensor  # (L, K+1) i32 SpaceSaving keys, -1 empty
    ss_count: torch.Tensor  # (L, K+1) i32 upper-bound counts
    ss_err_count: torch.Tensor  # (L, K+1) i32 overestimation bounds
    key_count: torch.Tensor  # (L,) i32 total key observations


def sketch_init(sketch_cap: int, n_branches: int, n_lanes: int,
                n_windows: int = N_WINDOWS,
                device: str | torch.device = "cuda") -> Optional[SketchState]:
    """Fresh :class:`SketchState` of ``n_lanes`` lanes on ``device``, or
    None when ``sketch_cap == 0`` (the reference's ``()``: no state, no
    sketch code)."""
    if sketch_cap <= 0:
        return None
    dev = resolve_device(device)
    L, W, K = int(n_lanes), int(n_windows), int(sketch_cap)
    width = cm_width(K)

    def z(*s):
        return torch.zeros((L, *s), dtype=torch.int32, device=dev)

    def f(v):
        return torch.full((L,), v, dtype=torch.float32, device=dev)

    return SketchState(
        win_id=z(W + 1) - 1,
        win_done_count=z(W + 1), win_hit_count=z(W + 1),
        win_delayed_count=z(W + 1), win_arrival_count=z(W + 1),
        win_branch_count=z(W + 1, int(n_branches)),
        ewma_hit_frac=f(0.0), ewma_delayed_frac=f(0.0), ewma_norm_frac=f(1.0),
        cm_count=z(CM_DEPTH, width + 1),
        ss_key=z(K + 1) - 1,
        ss_count=z(K + 1), ss_err_count=z(K + 1),
        key_count=torch.zeros(L, dtype=torch.int32, device=dev),
    )


def pow_table(n_max: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 ``(1 - EWMA_ALPHA)^n`` for ``n = 0 .. n_max``: the batch
    decay of :func:`stream_done_many`, which the reference computes with
    ``jnp.power``.  Each entry is the float64 power of the float32 base,
    rounded once to float32, so it does not depend on any device's
    ``powf``; the kernel reads the same table."""
    base = np.float64(np.float32(1.0) - np.float32(EWMA_ALPHA))
    tab = (base ** np.arange(int(n_max) + 1, dtype=np.float64)).astype(
        np.float32)
    return torch.from_numpy(tab).to(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant on ``device``, made once and shared by every caller, so
    never written to: a 0-d tensor of one value (a device tensor, not a
    Python scalar, so that division by it is an IEEE division on every
    device; and no copy from the host at each event), or a 1-d tensor of
    a tuple."""
    return torch.tensor(values, dtype=dtype, device=device)


def _lanes(sk: SketchState) -> torch.Tensor:
    dev = sk.win_id.device
    return _const(tuple(range(sk.win_id.shape[0])), torch.int64, dev)


def _none(mask) -> bool:
    """True when a mask tensor selects no lane: the masked update then
    changes nothing, and is skipped (one read of the mask to the host
    in place of every operation of the update)."""
    return isinstance(mask, torch.Tensor) and not bool(mask.any())


def _all(sk: SketchState, mask) -> torch.Tensor:
    if mask is None:
        return _const((True,) * sk.win_id.shape[0], torch.bool,
                      sk.win_id.device)
    return torch.as_tensor(mask, device=sk.win_id.device).bool().expand(
        sk.win_id.shape[0])


def window_ids(elapsed_us: torch.Tensor, window_us: float) -> torch.Tensor:
    """The tumbling-window id of each elapsed time (float32 µs, any
    shape): ``floor(elapsed_us / float32(window_us))`` by IEEE float32
    division, clamped at 0, int32."""
    w = _const(float(np.float32(window_us)), torch.float32, elapsed_us.device)
    wid = torch.floor(elapsed_us.to(torch.float32) / w).to(torch.int32)
    return wid.clamp(min=0)


def stream_tick(sk: SketchState, elapsed_us: torch.Tensor, window_us: float,
                mask=None, wid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Advance each lane's tumbling-window ring to the window containing
    its ``elapsed_us`` ((L,) float32; or ``wid``, its
    :func:`window_ids`, when the caller has them); returns the (L,) ring
    rows that the event's adds target.  A row whose stored absolute
    window id differs is stale (its window scrolled out ``n_windows``
    windows ago) and is zeroed before reuse.  Lanes outside ``mask`` are
    left as they are."""
    mask = _all(sk, mask)
    lane = _lanes(sk)
    W = sk.win_id.shape[1] - 1
    if wid is None:
        wid = window_ids(elapsed_us, window_us)
    slot = torch.remainder(wid, W).long()
    stale = mask & (sk.win_id[lane, slot] != wid)
    if not bool(stale.any()):  # every row already holds its window
        return slot
    for a in (sk.win_done_count, sk.win_hit_count, sk.win_delayed_count,
              sk.win_arrival_count):
        a[lane, slot] = torch.where(stale, 0, a[lane, slot])
    sk.win_branch_count[lane, slot] = torch.where(
        stale[:, None], 0, sk.win_branch_count[lane, slot])
    sk.win_id[lane, slot] = torch.where(stale, wid, sk.win_id[lane, slot])
    return slot


def stream_arrival(sk: SketchState, slot: torch.Tensor, mask) -> None:
    """Count one (masked) arrival into each lane's current window."""
    sk.win_arrival_count[_lanes(sk), slot] += _all(sk, mask).to(torch.int32)


def stream_done(sk: SketchState, slot: torch.Tensor, branch_j: torch.Tensor,
                is_hit: torch.Tensor, delayed, mask) -> None:
    """Record one (masked) request completion per lane: window counters
    plus one EWMA step (``x = is_hit`` for the hit estimator, ``x =
    delayed`` for the delayed-hit estimator, norm decays by ``1 -
    alpha``).  A branch index past the table is not counted per branch,
    as JAX drops an out-of-bounds scatter."""
    if _none(mask):
        return
    mask = _all(sk, mask)
    lane = _lanes(sk)
    dev = mask.device

    def flag(x) -> torch.Tensor:
        if isinstance(x, bool):
            x = _const(x, torch.bool, dev)
        return x.bool() & mask

    no_delay = delayed is False
    is_hit, delayed = flag(is_hit), flag(delayed)
    n_b = sk.win_branch_count.shape[2]
    sk.win_done_count[lane, slot] += mask.to(torch.int32)
    sk.win_hit_count[lane, slot] += is_hit.to(torch.int32)
    sk.win_delayed_count[lane, slot] += delayed.to(torch.int32)
    sk.win_branch_count[lane, slot, branch_j.clamp(max=n_b - 1)] += (
        mask & (branch_j < n_b)).to(torch.int32)
    a = _const(float(np.float32(EWMA_ALPHA)), torch.float32, dev)
    one = _const(1.0, torch.float32, dev)
    zero = _const(0.0, torch.float32, dev)
    decay = torch.where(mask, one - a, one)
    sk.ewma_hit_frac.copy_(fma_f32(sk.ewma_hit_frac, decay,
                                   torch.where(is_hit, a, zero)))
    if no_delay:  # fma(s, decay, 0) is s * decay, rounded once
        sk.ewma_delayed_frac.mul_(decay)
    else:
        sk.ewma_delayed_frac.copy_(fma_f32(sk.ewma_delayed_frac, decay,
                                           torch.where(delayed, a, zero)))
    sk.ewma_norm_frac.mul_(decay)


def stream_done_many(sk: SketchState, slot: torch.Tensor,
                     branch_vec: torch.Tensor, mask_vec: torch.Tensor,
                     decay_table: torch.Tensor) -> None:
    """Record a batch of delayed-hit completions per lane (an MSHR fill
    waking every parked request at once): window adds per branch, and the
    closed-form batch EWMA step for ``n`` identical ``x = 1`` delayed
    observations (``s' = s * d^n + (1 - d^n)``, one fused multiply-add),
    ``d^n`` read from ``decay_table`` (:func:`pow_table`).  ``branch_vec``
    and ``mask_vec`` are (L, N)."""
    lane = _lanes(sk)
    n_b = sk.win_branch_count.shape[2]
    n = mask_vec.sum(dim=1)
    sk.win_done_count[lane, slot] += n.to(torch.int32)
    sk.win_delayed_count[lane, slot] += n.to(torch.int32)
    keep = (mask_vec & (branch_vec < n_b)).to(torch.int32)
    col = slot[:, None] * n_b + branch_vec.clamp(max=n_b - 1)
    sk.win_branch_count.view(len(lane), -1).scatter_add_(1, col, keep)
    d = decay_table[n]
    sk.ewma_hit_frac.mul_(d)
    sk.ewma_delayed_frac.copy_(fma_f32(sk.ewma_delayed_frac, d, 1.0 - d))
    sk.ewma_norm_frac.mul_(d)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2**32 for int64 ``x`` in [0, 2**32), in 16-bit halves
    of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` on int64 tensors holding uint32 values."""
    x = _mul32(x ^ (x >> 16), _MIX_A)
    x = _mul32(x ^ (x >> 15), _MIX_B)
    return x ^ (x >> 16)


def cm_columns(key: torch.Tensor, width: int) -> torch.Tensor:
    """The count-min column of each key (any shape) in each of the
    ``CM_DEPTH`` rows: (..., CM_DEPTH) int64."""
    ku = key.long() & _M32
    salt = _const(_CM_SALTS[:CM_DEPTH], torch.int64, key.device)
    return _mix32_t((_mul32(ku, _CM_MULT)[..., None] + salt) & _M32) % width


def stream_key(sk: SketchState, key: torch.Tensor, mask,
               cols: Optional[torch.Tensor] = None) -> None:
    """Feed one (masked) key observation per lane to the popularity
    sketches (``cols``: the keys' :func:`cm_columns`, when the caller has
    them).

    Count-min: +1 in one hashed column per row (so the per-key minimum
    over rows never underestimates).  SpaceSaving: increment the key's
    slot if present (the lowest such slot), else evict the minimum-count
    slot (the lowest on a tie), inheriting its count as the new key's
    overestimation bound ``err``."""
    if _none(mask):
        return
    mask = _all(sk, mask)
    lane = _lanes(sk)
    K = sk.ss_key.shape[1] - 1
    width = sk.cm_count.shape[2] - 1
    ku = key.long() & _M32
    m = mask.to(torch.int32)
    col = cm_columns(ku, width) if cols is None else cols
    row = _const(tuple(range(CM_DEPTH)), torch.int64, key.device)
    sk.cm_count[lane[:, None], row, col] += m[:, None]
    key32 = _as_int32(ku)
    match = (sk.ss_key[:, :K] == key32[:, None]) & mask[:, None]
    has = match.any(dim=1)
    j = torch.where(has, match.to(torch.int32).argmax(dim=1),
                    sk.ss_count[:, :K].argmin(dim=1))
    c_j = sk.ss_count[lane, j]
    e_j = sk.ss_err_count[lane, j]
    sk.ss_key[lane, j] = torch.where(mask, key32, sk.ss_key[lane, j])
    sk.ss_count[lane, j] = torch.where(mask, c_j + 1, c_j)
    sk.ss_err_count[lane, j] = torch.where(mask & ~has, c_j, e_j)
    sk.key_count.add_(m)


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) as int32, wrapping as ``astype(int32)``."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _mix32(x):
    """splitmix32 finalizer over uint32 (wrapping) — deterministic, no
    RNG draws (numpy ``np.uint32`` arithmetic; :func:`_mix32_t` is the
    same on tensors)."""
    x = (x ^ (x >> 16)) * np.uint32(_MIX_A)
    x = (x ^ (x >> 15)) * np.uint32(_MIX_B)
    return x ^ (x >> 16)


def _np(x) -> np.ndarray:
    """A leaf as numpy: tensors (any device) are copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------- host side


@dataclasses.dataclass(frozen=True)
class SketchEstimates:
    """Decoded, host-side view of one lane's :class:`SketchState`.

    Window arrays are sorted by ascending absolute window id with empty
    and scrap rows dropped; rates are per µs over ``window_us``.  EWMA
    fractions are debiased (divided by ``1 - (1 - alpha)^n``; NaN before
    the first completion).  ``exact=True`` marks estimates produced by
    the exact-counting twin, which additionally carries the full
    ``exact_key``/``exact_count`` tables (its ``topk_err_count`` is 0
    and ``cm_depth_count`` is None)."""

    window_us: float
    window_id: np.ndarray  # (w,) ascending absolute window ids
    win_done_count: np.ndarray  # (w,)
    win_hit_frac: np.ndarray  # (w,) NaN where no completions
    win_delayed_frac: np.ndarray  # (w,)
    win_done_rate: np.ndarray  # (w,) completions / µs
    win_arrival_rate: np.ndarray  # (w,) arrivals / µs
    win_branch_rate: np.ndarray  # (w, B) completions / µs per branch
    ewma_hit_frac: float
    ewma_delayed_frac: float
    topk_key: np.ndarray  # (k,) by descending count upper bound
    topk_count: np.ndarray  # (k,) upper bounds
    topk_err_count: np.ndarray  # (k,) overestimation bounds
    key_count: int
    exact: bool = False
    cm_depth_count: np.ndarray | None = None  # (CM_DEPTH, width)
    exact_key: np.ndarray | None = None
    exact_count: np.ndarray | None = None

    def cm_estimate(self, keys) -> np.ndarray:
        """Count-min frequency estimates (never below the true count).
        On the exact twin, returns the true counts."""
        keys = np.asarray(keys, np.int64)
        if self.exact:
            lut = dict(zip(self.exact_key.tolist(),
                           self.exact_count.tolist()))
            return np.array([lut.get(int(k), 0) for k in keys], np.int64)
        width = self.cm_depth_count.shape[1]
        ku = keys.astype(np.uint32)
        est = np.full(len(keys), np.iinfo(np.int64).max)
        for r, salt in enumerate(_CM_SALTS[:CM_DEPTH]):
            h = _mix32(ku * np.uint32(_CM_MULT) + np.uint32(salt))
            est = np.minimum(est, self.cm_depth_count[r, h % width])
        return est.astype(np.int64)

    def topk(self, k: int | None = None):
        """``(keys, count_upper, err)`` for the heaviest ``k`` keys."""
        k = len(self.topk_key) if k is None else min(k, len(self.topk_key))
        return (self.topk_key[:k], self.topk_count[:k],
                self.topk_err_count[:k])

    def saturation_frac(self) -> float:
        """SpaceSaving pressure: the minimum slot count (the bound on
        how much any stored count may overestimate) over the stream
        length.  ~0 while the table comfortably holds the head of the
        popularity distribution; -> 1 as it thrashes."""
        if self.exact or len(self.topk_count) == 0 or self.key_count == 0:
            return 0.0
        return float(self.topk_count.min()) / float(self.key_count)

    def shard_heat(self, branch_shard, n_shards: int) -> np.ndarray:
        """Per-window, per-shard completion rates (w, n_shards) folded
        from the per-branch windowed counters."""
        shard = np.asarray(branch_shard)
        out = np.zeros((len(self.window_id), n_shards))
        for k in range(n_shards):
            out[:, k] = self.win_branch_rate[:, shard == k].sum(axis=1)
        return out

    def heat_imbalance(self, branch_shard, n_shards: int) -> float:
        """max/mean of the per-shard mean completion rates (1.0 =
        perfectly balanced; NaN with no completions)."""
        heat = self.shard_heat(branch_shard, n_shards).mean(axis=0)
        mean = heat.mean()
        return float(heat.max() / mean) if mean > 0 else float("nan")


def _debias(s: float, norm: float) -> float:
    denom = 1.0 - norm
    return float(s / denom) if denom > 0 else float("nan")


def decode_sketch(sk, window_us: float) -> SketchEstimates:
    """Decode one lane's state: any object with :class:`SketchState`'s
    field names whose leaves are numpy arrays or tensors (the reference's
    jnp state converts through ``np.asarray``)."""
    sk = SketchState(*(_np(getattr(sk, f)) for f in SketchState._fields))
    win_id = np.asarray(sk.win_id)[:-1]
    keep = np.flatnonzero(win_id >= 0)
    keep = keep[np.argsort(win_id[keep], kind="stable")]
    done = np.asarray(sk.win_done_count)[keep]
    hit = np.asarray(sk.win_hit_count)[keep]
    dly = np.asarray(sk.win_delayed_count)[keep]
    arr = np.asarray(sk.win_arrival_count)[keep]
    br = np.asarray(sk.win_branch_count)[keep]
    with np.errstate(invalid="ignore", divide="ignore"):
        hit_frac = np.where(done > 0, hit / np.maximum(done, 1), np.nan)
        dly_frac = np.where(done > 0, dly / np.maximum(done, 1), np.nan)

    ss_key = np.asarray(sk.ss_key)[:-1]
    ss_count = np.asarray(sk.ss_count)[:-1]
    ss_err = np.asarray(sk.ss_err_count)[:-1]
    filled = np.flatnonzero(ss_key >= 0)
    order = filled[np.lexsort((ss_key[filled], -ss_count[filled]))]
    return SketchEstimates(
        window_us=float(window_us),
        window_id=win_id[keep],
        win_done_count=done,
        win_hit_frac=hit_frac,
        win_delayed_frac=dly_frac,
        win_done_rate=done / window_us,
        win_arrival_rate=arr / window_us,
        win_branch_rate=br / window_us,
        ewma_hit_frac=_debias(float(np.asarray(sk.ewma_hit_frac)),
                              float(np.asarray(sk.ewma_norm_frac))),
        ewma_delayed_frac=_debias(float(np.asarray(sk.ewma_delayed_frac)),
                                  float(np.asarray(sk.ewma_norm_frac))),
        topk_key=ss_key[order],
        topk_count=ss_count[order].astype(np.int64),
        topk_err_count=ss_err[order].astype(np.int64),
        key_count=int(np.asarray(sk.key_count)),
        cm_depth_count=np.asarray(sk.cm_count)[:, :-1],
    )


def decode_sketch_grid(sk, n_seeds: int, n_p: int,
                       window_us: float) -> list:
    """Decode a vmapped (seed x p) grid of sketch states into
    ``[seed][p]`` :class:`SketchEstimates` (lane order matches
    :func:`repro_torch.obs.trace.decode_trace_grid`: ``lane = s * n_p + p``)."""
    leaves = [_np(getattr(sk, f)) for f in SketchState._fields]
    out = []
    for s in range(n_seeds):
        row = []
        for p in range(n_p):
            lane = SketchState(*(leaf[s * n_p + p] for leaf in leaves))
            row.append(decode_sketch(lane, window_us))
        out.append(row)
    return out


# ------------------------------------------------------ trace-stream twins


def sketch_trace(keys, t_us=None, hits=None, sketch_cap: int = 64,
                 window_us: float = 1000.0, n_windows: int = N_WINDOWS,
                 device: str = "cuda") -> SketchEstimates:
    """Run the streaming estimators over a key trace — the standalone
    path for replayed traces (and the fast half of the reference's
    ``stream-sketch`` differential pair).

    Per event, in the reference's order (its ``_sketch_trace`` scan):
    tick, arrival, key, done.  On the card one launch of the
    ``sketch_trace`` kernel
    (:func:`repro_torch.kernels.sketch.sketch_trace_lanes`, one warp per
    stream); on the CPU its plain version, the loop of the lane
    functions above.  ``t_us`` defaults to one event per µs;
    ``hits`` (0/1 per event) feeds the hit-ratio estimators when given.
    """
    from repro_torch.kernels.sketch import sketch_trace_lanes

    if sketch_cap <= 0:
        raise ValueError("sketch_trace needs sketch_cap > 0")
    if window_us <= 0:
        raise ValueError("sketch_trace needs window_us > 0")
    dev = resolve_device(device)
    keys = torch.as_tensor(np.asarray(keys, np.int32), device=dev)
    n = keys.shape[0]
    t = (torch.arange(n, dtype=torch.float32, device=dev) if t_us is None
         else torch.as_tensor(np.asarray(t_us, np.float32), device=dev))
    h = (torch.zeros(n, dtype=torch.int32, device=dev) if hits is None
         else torch.as_tensor(np.asarray(hits, np.int32), device=dev))
    sk = sketch_trace_lanes(keys[None], t[None], h[None],
                            sketch_cap=sketch_cap, window_us=float(window_us),
                            n_windows=n_windows)
    est = decode_sketch_grid(sk, 1, 1, float(window_us))[0][0]
    if hits is None:
        est = dataclasses.replace(est, ewma_hit_frac=float("nan"),
                                  win_hit_frac=np.full_like(
                                      est.win_hit_frac, np.nan))
    return est


def sketch_trace_py(keys, t_us=None, hits=None, sketch_cap: int = 64,
                    window_us: float = 1000.0,
                    n_windows: int = N_WINDOWS) -> SketchEstimates:
    """Exact-counting oracle twin of :func:`sketch_trace` (dict
    counters, same float32 EWMA order, same ring retention)."""
    if sketch_cap <= 0:
        raise ValueError("sketch_trace_py needs sketch_cap > 0")
    if window_us <= 0:
        raise ValueError("sketch_trace_py needs window_us > 0")
    keys = np.asarray(keys, np.int64)
    n = len(keys)
    t = (np.arange(n, dtype=np.float32) if t_us is None
         else np.asarray(t_us, np.float32))
    h = (np.zeros(n, np.int64) if hits is None
         else np.asarray(hits, np.int64))
    py = PyStreamSketch(sketch_cap, n_branches=1, window_us=window_us,
                        n_windows=n_windows)
    for i in range(n):
        py.arrival(float(t[i]))
        py.key(int(keys[i]))
        py.done(float(t[i]), 0, is_hit=bool(h[i]))
    est = py.estimates()
    if hits is None:
        est = dataclasses.replace(est, ewma_hit_frac=float("nan"),
                                  win_hit_frac=np.full_like(
                                      est.win_hit_frac, np.nan))
    return est


class PyStreamSketch:
    """Exact-counting Python twin of the in-kernel estimators.

    Keys are counted exactly (a dict), windows keep exact per-window
    counters, and the EWMA scalars apply the identical float32
    operations in the identical per-event order as the kernels, so the
    decoded :class:`SketchEstimates` agree with the jitted side within
    documented bounds (exactly, for every integer counter on the same
    event stream; to float32 round-off for the EWMAs; count-min/
    SpaceSaving replaced by the truth).  ``estimates`` emulates the ring
    retention: per ring row only the most recent window survives."""

    def __init__(self, sketch_cap: int, n_branches: int = 1,
                 window_us: float = 1000.0, n_windows: int = N_WINDOWS):
        if sketch_cap <= 0:
            raise ValueError("PyStreamSketch needs sketch_cap > 0")
        if window_us <= 0:
            raise ValueError("PyStreamSketch needs window_us > 0")
        self.sketch_cap = int(sketch_cap)
        self.n_branches = int(n_branches)
        self.window_us = float(window_us)
        self.n_windows = int(n_windows)
        self.key_freq: dict = {}
        self.key_count = 0
        # wid -> [done, hit, delayed, arrivals, per-branch np array]
        self.windows: dict = {}
        self.ewma_hit = np.float32(0.0)
        self.ewma_delayed = np.float32(0.0)
        self.ewma_norm = np.float32(1.0)

    def _win(self, t_us: float):
        wid = max(int(np.float32(t_us) / np.float32(self.window_us)), 0)
        w = self.windows.get(wid)
        if w is None:
            w = [0, 0, 0, 0, np.zeros(self.n_branches, np.int64)]
            self.windows[wid] = w
        return w

    def key(self, key: int) -> None:
        self.key_freq[key] = self.key_freq.get(key, 0) + 1
        self.key_count += 1

    def arrival(self, t_us: float) -> None:
        self._win(t_us)[3] += 1

    def done(self, t_us: float, branch: int = 0, is_hit: bool = False,
             delayed: bool = False) -> None:
        w = self._win(t_us)
        w[0] += 1
        w[1] += 1 if is_hit else 0
        w[2] += 1 if delayed else 0
        w[4][branch] += 1
        a = np.float32(EWMA_ALPHA)
        decay = np.float32(1.0) - a
        self.ewma_hit = self.ewma_hit * decay + (a if is_hit
                                                 else np.float32(0.0))
        self.ewma_delayed = self.ewma_delayed * decay + (
            a if delayed else np.float32(0.0))
        self.ewma_norm = self.ewma_norm * decay

    def estimates(self) -> SketchEstimates:
        W = self.n_windows
        survivors: dict = {}
        for wid in self.windows:
            r = wid % W
            if r not in survivors or wid > survivors[r]:
                survivors[r] = wid
        wids = sorted(survivors.values())
        done = np.array([self.windows[w][0] for w in wids], np.int64)
        hit = np.array([self.windows[w][1] for w in wids], np.int64)
        dly = np.array([self.windows[w][2] for w in wids], np.int64)
        arr = np.array([self.windows[w][3] for w in wids], np.int64)
        br = (np.stack([self.windows[w][4] for w in wids])
              if wids else np.zeros((0, self.n_branches), np.int64))
        with np.errstate(invalid="ignore", divide="ignore"):
            hit_frac = np.where(done > 0, hit / np.maximum(done, 1), np.nan)
            dly_frac = np.where(done > 0, dly / np.maximum(done, 1), np.nan)
        items = sorted(self.key_freq.items(),
                       key=lambda kv: (-kv[1], kv[0]))
        keys = np.array([k for k, _ in items], np.int64)
        counts = np.array([c for _, c in items], np.int64)
        k = min(self.sketch_cap, len(items))
        return SketchEstimates(
            window_us=self.window_us,
            window_id=np.asarray(wids, np.int64),
            win_done_count=done,
            win_hit_frac=hit_frac,
            win_delayed_frac=dly_frac,
            win_done_rate=done / self.window_us,
            win_arrival_rate=arr / self.window_us,
            win_branch_rate=br / self.window_us,
            ewma_hit_frac=_debias(float(self.ewma_hit),
                                  float(self.ewma_norm)),
            ewma_delayed_frac=_debias(float(self.ewma_delayed),
                                      float(self.ewma_norm)),
            topk_key=keys[:k],
            topk_count=counts[:k],
            topk_err_count=np.zeros(k, np.int64),
            key_count=self.key_count,
            exact=True,
            exact_key=keys,
            exact_count=counts,
        )
