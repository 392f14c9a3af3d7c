"""Flat-array cache policy state, batched over lanes (port of ``repro.cache.flat``).

Every policy of the suite is re-expressed over a **timestamp layout**:
list order *is* descending push-timestamp, one monotone ``now`` counter is
bumped on every (re-)push, the list tail is the occupied slot with minimum
``ts``, and two lists that share one slot array (SLRU's B/T, S3-FIFO's
S/M) are membership masks over the same ``ts`` vector.  Victim search is a
masked argmin over the padded slot axis.

The JAX package writes each step for one lane and ``vmap``s it.  Here the
lane axis is explicit: every field of :class:`FlatState` carries a leading
``(L,)`` axis, and a step processes one request on every lane at once::

    hit, evicted, ops = FLAT_STEPS[policy](state, key, u, p, q)

``state`` is **updated in place**; ``key`` is ``(L,)`` int64, ``u`` and
``q`` are ``(L,)`` float32 and ``p`` is the ``(L, N_PARAMS)`` int32
parameter block.  ``lax.cond`` becomes ``torch.where`` on lane masks (each
lane's row is written only under its own branch's mask), and the bounded
``while_loop`` of the CLOCK scan runs until every lane is done.

These steps are the replay kernel's plain version
(``repro_torch/kernels/csrc/replay.cu`` runs the same arithmetic per lane)
and are bit-identical to ``repro.cache.flat.FLAT_STEPS``.

Where bit-exactness could break, and what is done about it:

* **Argmin ties.**  ``jnp.argmin`` returns the first index; so does
  ``torch.argmin``.  An all-masked :func:`_min_slot` returns slot 0.
* **Index semantics.**  JAX clamps out-of-range gathers and drops
  out-of-range scatters; torch raises.  In every *taken* branch the
  indices below are in range (the JAX code guards ``NIL`` with
  ``maximum(x, 0)`` exactly where it can occur, e.g. :func:`_clear_key`);
  lanes that do not take a branch may compute a ``NIL`` index, which
  :func:`_take` / :func:`_put` clamp and the lane mask then discards.
* **Wraparound.**  State stays int32, as in the reference, so the SIEVE
  ``_WRAP_BIAS`` sum is the same int32 arithmetic.
* **Admission coin.**  prob_lru compares ``u >= q`` in float32 with ``q``
  already rounded to float32 (:func:`flat_lane_params`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

NIL = -1
_INT32_MAX = 2**31 - 1
# bias for collapsing a cyclic hand scan into one argmin (see _sieve_step);
# timestamps stay far below this (at most a couple of bumps per request)
_WRAP_BIAS = 2**30

# -- regs vector layout (per-lane scalar registers) -------------------------
R_SIZE = 0      # slots ever filled, saturating at capacity
R_NOW = 1       # monotone push counter (list order == descending ts)
R_SIZET = 2     # SLRU: protected-list population
R_SIZES = 3     # S3-FIFO: small-queue population
R_SIZEM = 4     # S3-FIFO: main-queue population
R_GPOS = 5      # S3-FIFO: ghost-ring write cursor
R_HAND = 6      # SIEVE: hand slot, NIL when unset
N_REGS = 8

# -- per-lane parameter vector layout ---------------------------------------
P_CAP = 0
P_MAX_SCAN = 1
P_PROT_CAP = 2
P_S_CAP = 3
P_M_CAP = 4
P_GHOST_CAP = 5
N_PARAMS = 6

# Packed op-vector bit layout (delink, head, tail, scan) -> one int32.
_OPS_HEAD_SHIFT = 1
_OPS_TAIL_SHIFT = 9
_OPS_SCAN_SHIFT = 12
_OPS_HEAD_MASK = 0xFF      # 8 bits
_OPS_TAIL_MASK = 0x7       # 3 bits
_OPS_SCAN_MASK = 0x7FFFF   # 19 bits

_PARAM_NAMES = {
    "lru": (),
    "fifo": (),
    "prob_lru": ("q",),
    "clock": ("max_scan",),
    "slru": ("protected_frac",),
    "s3fifo": ("small_frac", "max_scan"),
    "sieve": (),
}
POLICY_IDS = {name: i for i, name in enumerate(_PARAM_NAMES)}


class FlatState(NamedTuple):
    """Uniform flat policy state, ``(L, ...)`` int32 (booleans as 0/1).

    ``aux`` is the policy's second membership bit: ``in_T`` for SLRU,
    ``in_M`` for S3-FIFO, unused elsewhere.  ``ghost`` is the S3-FIFO
    ghost ring (NIL-filled for other policies).  ``regs`` packs the
    scalar registers (see the ``R_*`` indices).
    """

    key2slot: torch.Tensor   # (L, K) slot of each key, NIL when absent
    slot2key: torch.Tensor   # (L, P) key in each slot, NIL when free
    ts: torch.Tensor         # (L, P) push timestamp (list position)
    bit: torch.Tensor        # (L, P) CLOCK/SIEVE/S3 reference bit
    aux: torch.Tensor        # (L, P) secondary membership bit
    ghost: torch.Tensor      # (L, P) evicted-key ring (S3-FIFO)
    regs: torch.Tensor       # (L, N_REGS) scalar registers


def flat_state_init(key_space: int, pad: int, lanes: int = 1,
                    device: str | torch.device = "cuda") -> FlatState:
    """Zero state shared by every policy (SIEVE's hand starts at NIL)."""
    def full(n: int, v: int) -> torch.Tensor:
        return torch.full((lanes, n), v, dtype=torch.int32, device=device)

    regs = full(N_REGS, 0)
    regs[:, R_HAND] = NIL
    return FlatState(key2slot=full(key_space, NIL), slot2key=full(pad, NIL),
                     ts=full(pad, 0), bit=full(pad, 0), aux=full(pad, 0),
                     ghost=full(pad, NIL), regs=regs)


def flat_lane_params(policy: str, capacity: int,
                     **params: Any) -> Tuple[np.ndarray, float]:
    """Derive one lane's ``(p_vec, q)`` from the policy's init kwargs.

    The same derivations as the JAX package (``prot_cap = max(1, int(C *
    protected_frac))`` etc.), so both agree on every rounded-down boundary.
    """
    if policy not in _PARAM_NAMES:
        raise KeyError(f"unknown policy {policy!r}")
    unknown = set(params) - set(_PARAM_NAMES[policy])
    if unknown:
        raise TypeError(
            f"policy {policy!r} got unexpected params {sorted(unknown)}"
        )
    cap = int(capacity)
    if policy == "s3fifo" and cap < 2:
        # m_cap == 0 leaves no main list to evict from
        raise ValueError(
            "s3fifo needs capacity >= 2 (one small + one main slot)")
    if int(params.get("max_scan", 3)) < 0:
        # the scan would never pick a victim (NIL slot)
        raise ValueError("max_scan must be >= 0")
    s_cap = max(1, int(cap * float(params.get("small_frac", 0.1))))
    vec = np.zeros((N_PARAMS,), np.int32)
    vec[P_CAP] = cap
    vec[P_MAX_SCAN] = int(params.get("max_scan", 3))
    vec[P_PROT_CAP] = max(1, int(cap * float(params.get("protected_frac", 0.5))))
    vec[P_S_CAP] = s_cap
    vec[P_M_CAP] = cap - s_cap
    vec[P_GHOST_CAP] = max(1, cap - s_cap)
    # prob_lru stores q as float32: replicate the rounding so the coin
    # comparison is bit-identical
    q = float(np.float32(params.get("q", 0.5)))
    return vec, q


def pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., 4)`` (delink, head, tail, scan) op vectors into int32."""
    return (ops[..., 0]
            | (ops[..., 1] << _OPS_HEAD_SHIFT)
            | (ops[..., 2] << _OPS_TAIL_SHIFT)
            | (ops[..., 3] << _OPS_SCAN_SHIFT)).to(torch.int32)


def unpack_ops(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_ops`; appends a trailing length-4 axis."""
    packed = packed.to(torch.int32)
    return torch.stack(
        [
            packed & 1,
            (packed >> _OPS_HEAD_SHIFT) & _OPS_HEAD_MASK,
            (packed >> _OPS_TAIL_SHIFT) & _OPS_TAIL_MASK,
            (packed >> _OPS_SCAN_SHIFT) & _OPS_SCAN_MASK,
        ],
        dim=-1,
    )


# -- lane-batched scalar access ---------------------------------------------


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[l, idx[l]]`` per lane.  Indices are clamped: only lanes that
    discard the result can hold an out-of-range (NIL) index."""
    i = idx.long().clamp(0, a.shape[1] - 1).unsqueeze(1)
    return a.gather(1, i).squeeze(1)


def _put(a: torch.Tensor, idx: torch.Tensor, val: Any,
         mask: torch.Tensor) -> None:
    """``a[l, idx[l]] = val[l]`` on the lanes where ``mask`` holds (in place)."""
    i = idx.long().clamp(0, a.shape[1] - 1).unsqueeze(1)
    cur = a.gather(1, i).squeeze(1)
    if not torch.is_tensor(val):
        val = torch.full_like(cur, int(val))
    a.scatter_(1, i, torch.where(mask, val.to(a.dtype), cur).unsqueeze(1))


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _ops4(delink: Any = 0, head: Any = 0, tail: Any = 0, scan: Any = 0, *,
          like: torch.Tensor) -> torch.Tensor:
    """``(L, 4)`` int32 op vectors from per-lane (or scalar) columns."""
    cols = [c.to(torch.int32) if torch.is_tensor(c)
            else torch.full(like.shape, int(c), dtype=torch.int32,
                            device=like.device)
            for c in (delink, head, tail, scan)]
    return torch.stack(cols, dim=1)


def _min_slot(ts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Slot with minimum ts among ``mask`` — the masked list's tail.

    First index on ties (as ``jnp.argmin``); all-masked gives slot 0."""
    return torch.where(mask, ts, _INT32_MAX).argmin(dim=1)


def _occupied(st: FlatState) -> torch.Tensor:
    return st.slot2key != NIL


def _clear_key(key2slot: torch.Tensor, old_key: torch.Tensor,
               mask: torch.Tensor) -> None:
    """The guarded mapping clear (no-op when old_key is NIL), in place."""
    _put(key2slot, old_key.clamp(min=0), NIL, mask & (old_key != NIL))


def _reg(st: FlatState, r: int) -> torch.Tensor:
    return st.regs[:, r].clone()


def _set_reg(st: FlatState, r: int, val: torch.Tensor,
             mask: torch.Tensor | None = None) -> None:
    if mask is not None:
        val = torch.where(mask, val, st.regs[:, r])
    st.regs[:, r] = val.to(torch.int32)


# ---------------------------------------------------------------------------
# LRU family (LRU / FIFO / Prob-LRU) — branch-free.
# ---------------------------------------------------------------------------


def _make_list_step(reorder_of: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor]):
    def step(st: FlatState, key: torch.Tensor, u: torch.Tensor,
             p: torch.Tensor, q: torch.Tensor):
        slot = _take(st.key2slot, key)
        hit = slot != NIL
        reorder = reorder_of(u, q)
        miss = ~hit
        size = _reg(st, R_SIZE)
        now = _reg(st, R_NOW)
        cap = p[:, P_CAP]
        full = size >= cap
        evict = miss & full
        victim = _min_slot(st.ts, _occupied(st))
        s = torch.where(hit, slot.long(), torch.where(full, victim, size.long()))
        old_key = _take(st.slot2key, s)
        evicted = torch.where(evict, old_key, NIL)
        idx_clear = torch.where(evict, old_key.clamp(min=0).long(), key)
        _put(st.key2slot, idx_clear, NIL, miss)
        _put(st.key2slot, key, s, miss)
        _put(st.slot2key, s, key, miss)
        act = miss | (hit & reorder)
        _put(st.ts, s, now, act)
        _set_reg(st, R_SIZE, torch.minimum(size + _i32(miss), cap))
        _set_reg(st, R_NOW, now + _i32(act))
        ops = _ops4(delink=hit & reorder, head=act, tail=evict, like=key)
        return hit, evicted, ops

    return step


_lru_step = _make_list_step(lambda u, q: torch.ones_like(u, dtype=torch.bool))
_fifo_step = _make_list_step(lambda u, q: torch.zeros_like(u, dtype=torch.bool))
_prob_lru_step = _make_list_step(lambda u, q: u.float() >= q)


# ---------------------------------------------------------------------------
# CLOCK — bounded tail scan, reinsert 1-bit items.
# ---------------------------------------------------------------------------


def _clock_scan_evict(ts: torch.Tensor, bit: torch.Tensor, now: torch.Tensor,
                      mask: torch.Tensor, max_scan: torch.Tensor,
                      active: torch.Tensor):
    """Shared CLOCK/S3-M eviction scan over a fixed membership mask.

    Runs on the ``active`` lanes until every one of them has picked its
    victim; ``ts`` and ``bit`` are updated in place for reinserted slots.
    The victim stays in the mask for the whole loop, so the mask never
    changes.  Returns (victim, n_reinsert, now) per lane.
    """
    now = now.clone()
    scans = torch.zeros_like(now)
    victim = torch.full_like(now, NIL, dtype=torch.long)
    run = active & (scans <= max_scan)
    while bool(run.any()):
        s = _min_slot(ts, mask)
        give = run & (_take(bit, s) != 0) & (scans < max_scan)
        _put(ts, s, now, give)
        _put(bit, s, 0, give)
        now = now + _i32(give)
        victim = torch.where(run & ~give, s, victim)
        scans = scans + _i32(run)
        run = give & (scans <= max_scan)
    return victim, scans - 1, now


def _clock_step(st: FlatState, key: torch.Tensor, u: torch.Tensor,
                p: torch.Tensor, q: torch.Tensor):
    del u, q
    slot = _take(st.key2slot, key)
    hit = slot != NIL
    miss = ~hit
    cap = p[:, P_CAP]
    _put(st.bit, slot.clamp(min=0), 1, hit)

    size = _reg(st, R_SIZE)
    fresh = size < cap
    ev = miss & ~fresh
    victim, n_re, now_ev = _clock_scan_evict(
        st.ts, st.bit, _reg(st, R_NOW), _occupied(st), p[:, P_MAX_SCAN], ev)
    old_key = _take(st.slot2key, victim)
    _clear_key(st.key2slot, old_key, ev)
    _put(st.slot2key, victim, NIL, ev)
    _set_reg(st, R_NOW, now_ev, ev)
    ops = torch.where(ev[:, None],
                      _ops4(head=n_re, tail=1, scan=n_re, like=key), 0)

    new_slot = torch.where(fresh, size.long(), victim)
    old_key = torch.where(fresh, NIL, old_key)
    now = _reg(st, R_NOW)
    _put(st.key2slot, key, new_slot, miss)
    _put(st.slot2key, new_slot, key, miss)
    _put(st.ts, new_slot, now, miss)
    _put(st.bit, new_slot, 0, miss)
    _set_reg(st, R_NOW, now + 1, miss)
    _set_reg(st, R_SIZE, torch.minimum(size + 1, cap), miss)
    evicted = torch.where(miss, old_key, NIL)
    ops = torch.where(miss[:, None], ops + _ops4(head=1, like=key), 0)
    return hit, evicted, ops


# ---------------------------------------------------------------------------
# SLRU — probationary (aux=0) + protected (aux=1) masks over one ts vector.
# ---------------------------------------------------------------------------


def _slru_step(st: FlatState, key: torch.Tensor, u: torch.Tensor,
               p: torch.Tensor, q: torch.Tensor):
    del u, q
    slot0 = _take(st.key2slot, key)
    hit = slot0 != NIL
    miss = ~hit
    slot = slot0.clamp(min=0)
    hit_t = hit & (_take(st.aux, slot) != 0)
    hit_b = hit & ~hit_t
    cap = p[:, P_CAP]
    prot_cap = p[:, P_PROT_CAP]
    now0 = _reg(st, R_NOW)
    size_t0 = _reg(st, R_SIZET)
    size0 = _reg(st, R_SIZE)

    # hit in T: move to T's head
    _put(st.ts, slot, now0, hit_t)

    # hit in B: promote to T; demote T's tail when T overflows.  The
    # promoted slot carries the newest ts, so it is never that tail.
    _put(st.aux, slot, 1, hit_b)
    _put(st.ts, slot, now0, hit_b)
    now_b = now0 + 1
    size_tb = size_t0 + 1
    demote = hit_b & (size_tb > prot_cap)
    t_tail = _min_slot(st.ts, _occupied(st) & (st.aux != 0))
    _put(st.aux, t_tail, 0, demote)
    _put(st.ts, t_tail, now_b, demote)
    now_b = now_b + _i32(demote)
    size_tb = size_tb - _i32(demote)
    ops_b = _ops4(delink=1, head=1 + _i32(demote), tail=demote, like=key)

    # miss: evict B's tail, falling back to T's tail only when B is empty
    fresh = size0 < cap
    ev = miss & ~fresh
    occ = _occupied(st)
    b_mask = occ & (st.aux == 0)
    victim = torch.where(b_mask.any(dim=1), _min_slot(st.ts, b_mask),
                         _min_slot(st.ts, occ & (st.aux != 0)))
    old_key = _take(st.slot2key, victim)
    _clear_key(st.key2slot, old_key, ev)
    _put(st.slot2key, victim, NIL, ev)
    new_slot = torch.where(fresh, size0.long(), victim)
    old_key = torch.where(fresh, NIL, old_key)
    # the victim may have come from T (B empty): shrink sizeT using the
    # pre-clear membership bit, then mark the slot probationary.
    size_tm = size_t0 - _i32(_take(st.aux, new_slot) != 0)
    _put(st.key2slot, key, new_slot, miss)
    _put(st.slot2key, new_slot, key, miss)
    _put(st.ts, new_slot, now0, miss)
    _put(st.aux, new_slot, 0, miss)
    ops_m = _ops4(head=1, tail=ev, like=key)

    _set_reg(st, R_NOW, torch.where(hit_b, now_b, now0 + 1))
    _set_reg(st, R_SIZET, torch.where(hit_t, size_t0,
                                      torch.where(hit_b, size_tb, size_tm)))
    _set_reg(st, R_SIZE, torch.minimum(size0 + 1, cap), miss)
    evicted = torch.where(miss, old_key, NIL)
    ops = torch.where(hit_t[:, None], _ops4(delink=1, head=1, like=key),
                      torch.where(hit_b[:, None], ops_b, ops_m))
    return hit, evicted, ops


# ---------------------------------------------------------------------------
# S3-FIFO — small (aux=0) + main (aux=1) masks + ghost ring.
# ---------------------------------------------------------------------------


def _s3_evict_m(st: FlatState, p: torch.Tensor, active: torch.Tensor):
    """Evict from M with the CLOCK scan on the ``active`` lanes (in place);
    returns (old_key, ops)."""
    m_mask = _occupied(st) & (st.aux != 0)
    victim, n_re, now = _clock_scan_evict(
        st.ts, st.bit, _reg(st, R_NOW), m_mask, p[:, P_MAX_SCAN], active)
    old_key = _take(st.slot2key, victim)
    _clear_key(st.key2slot, old_key, active)
    _put(st.slot2key, victim, NIL, active)
    _put(st.aux, victim, 0, active)
    _set_reg(st, R_NOW, now, active)
    _set_reg(st, R_SIZEM, _reg(st, R_SIZEM) - 1, active)
    ops = torch.where(active[:, None],
                      _ops4(head=n_re, tail=1, scan=n_re, like=old_key), 0)
    return old_key, ops


def _s3fifo_step(st: FlatState, key: torch.Tensor, u: torch.Tensor,
                 p: torch.Tensor, q: torch.Tensor):
    del u, q
    slot = _take(st.key2slot, key)
    hit = slot != NIL
    miss = ~hit
    cap = p[:, P_CAP]
    _put(st.bit, slot.clamp(min=0), 1, hit)

    in_ghost = miss & (st.ghost == key[:, None]).any(dim=1)
    evicted = torch.full_like(slot, NIL)
    ops = _ops4(like=key)

    need_m = in_ghost & (_reg(st, R_SIZEM) >= p[:, P_M_CAP])
    old, eops = _s3_evict_m(st, p, need_m)
    ops = ops + eops
    evicted = torch.where(need_m, old, evicted)

    need_s = miss & ~in_ghost & (_reg(st, R_SIZES) >= p[:, P_S_CAP])
    s_tail = _min_slot(st.ts, _occupied(st) & (st.aux == 0))
    promote = need_s & (_take(st.bit, s_tail) != 0)
    to_ghost = need_s & ~promote

    # promote S's tail to M (making room in M first)
    room_m = promote & (_reg(st, R_SIZEM) >= p[:, P_M_CAP])
    old, eops = _s3_evict_m(st, p, room_m)
    ops = ops + eops
    evicted = torch.where(room_m, old, evicted)
    now = _reg(st, R_NOW)
    _put(st.ts, s_tail, now, promote)
    _put(st.aux, s_tail, 1, promote)
    _put(st.bit, s_tail, 0, promote)
    _set_reg(st, R_NOW, now + 1, promote)
    _set_reg(st, R_SIZES, _reg(st, R_SIZES) - 1, promote)
    _set_reg(st, R_SIZEM, _reg(st, R_SIZEM) + 1, promote)
    ops = ops + torch.where(promote[:, None],
                            _ops4(head=1, tail=1, like=key), 0)

    # or evict S's tail into the ghost ring
    old = _take(st.slot2key, s_tail)
    _clear_key(st.key2slot, old, to_ghost)
    _put(st.slot2key, s_tail, NIL, to_ghost)
    gpos = _reg(st, R_GPOS)
    _put(st.ghost, gpos, old, to_ghost)
    _set_reg(st, R_GPOS, (gpos + 1) % p[:, P_GHOST_CAP], to_ghost)
    _set_reg(st, R_SIZES, _reg(st, R_SIZES) - 1, to_ghost)
    ops = ops + torch.where(to_ghost[:, None], _ops4(tail=1, like=key), 0)
    evicted = torch.where(to_ghost, old, evicted)

    # place: next warmup slot while filling, else first freed slot
    size = _reg(st, R_SIZE)
    first_free = (st.slot2key == NIL).to(torch.int32).argmax(dim=1)
    new_slot = torch.where(size < cap, size.long(), first_free)
    now = _reg(st, R_NOW)
    to_m = in_ghost
    _put(st.key2slot, key, new_slot, miss)
    _put(st.slot2key, new_slot, key, miss)
    _put(st.ts, new_slot, now, miss)
    _put(st.aux, new_slot, _i32(to_m), miss)
    _put(st.bit, new_slot, 0, miss)
    _set_reg(st, R_NOW, now + 1, miss)
    _set_reg(st, R_SIZES, _reg(st, R_SIZES) + _i32(~to_m), miss)
    _set_reg(st, R_SIZEM, _reg(st, R_SIZEM) + _i32(to_m), miss)
    _set_reg(st, R_SIZE, torch.minimum(size + 1, cap), miss)
    ops = torch.where(miss[:, None], ops + _ops4(head=1, like=key), 0)
    return hit, evicted, ops


# ---------------------------------------------------------------------------
# SIEVE — lazy promotion; the hand is a slot index, NIL when unset.
# ---------------------------------------------------------------------------


def _sieve_step(st: FlatState, key: torch.Tensor, u: torch.Tensor,
                p: torch.Tensor, q: torch.Tensor):
    del u, q
    slot = _take(st.key2slot, key)
    hit = slot != NIL
    miss = ~hit
    cap = p[:, P_CAP]
    _put(st.bit, slot.clamp(min=0), 1, hit)

    size = _reg(st, R_SIZE)
    fresh = size < cap
    ev = miss & ~fresh
    occ = _occupied(st)
    tail = _min_slot(st.ts, occ)
    hand = _reg(st, R_HAND)
    start = torch.where(hand == NIL, tail, hand.long())
    # The hand walk visits occupied slots in cyclic ts order from start,
    # clearing bits until the first clear-bit slot: the victim is the
    # first original-bit-0 slot in cyclic order (or start after a full
    # clearing cycle); the cleared slots are the cyclic prefix before it.
    # Cyclic order collapses to one argmin by biasing the wrapped lower
    # segment (ts < ts[start]) by _WRAP_BIAS, in int32 as the reference.
    ts_start = _take(st.ts, start)
    bit0 = occ & (st.bit == 0)
    ck = st.ts + torch.where(st.ts < ts_start[:, None],
                             torch.tensor(_WRAP_BIAS, dtype=torch.int32,
                                          device=key.device),
                             torch.tensor(0, dtype=torch.int32,
                                          device=key.device))
    idx = torch.where(bit0, ck, _INT32_MAX).argmin(dim=1)
    found = _take(bit0, idx)
    victim = torch.where(found, idx, start)
    ts_v = _take(st.ts, victim)
    scanned = occ & torch.where(found[:, None],
                                ck < _take(ck, victim)[:, None], True)
    st.bit.copy_(torch.where(ev[:, None] & scanned, 0, st.bit))
    scans = scanned.to(torch.int32).sum(dim=1)
    # the hand moves one step past the victim toward the head (NIL at the
    # head -> restart from the tail), computed before the victim leaves
    above = occ & (st.ts > ts_v[:, None])
    nh = torch.where(above, st.ts, _INT32_MAX).argmin(dim=1)
    new_hand = torch.where(_take(above, nh), nh, NIL)
    old_key = _take(st.slot2key, victim)
    _clear_key(st.key2slot, old_key, ev)
    _put(st.slot2key, victim, NIL, ev)
    _set_reg(st, R_HAND, new_hand, ev)
    ops = torch.where(ev[:, None], _ops4(tail=1, scan=scans, like=key), 0)

    new_slot = torch.where(fresh, size.long(), victim)
    old_key = torch.where(fresh, NIL, old_key)
    now = _reg(st, R_NOW)
    _put(st.key2slot, key, new_slot, miss)
    _put(st.slot2key, new_slot, key, miss)
    _put(st.ts, new_slot, now, miss)
    _put(st.bit, new_slot, 0, miss)
    _set_reg(st, R_NOW, now + 1, miss)
    _set_reg(st, R_SIZE, torch.minimum(size + 1, cap), miss)
    evicted = torch.where(miss, old_key, NIL)
    ops = torch.where(miss[:, None], ops + _ops4(head=1, like=key), 0)
    return hit, evicted, ops


FLAT_STEPS: Dict[str, Callable[..., Any]] = {
    "lru": _lru_step,
    "fifo": _fifo_step,
    "prob_lru": _prob_lru_step,
    "clock": _clock_step,
    "slru": _slru_step,
    "s3fifo": _s3fifo_step,
    "sieve": _sieve_step,
}
