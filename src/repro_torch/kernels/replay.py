"""The replay engine: the whole (capacity x seed) grid in one launch.

Port of ``repro.kernels.replay`` (the Pallas ``_replay_kernel``).  Each
lane is one (capacity, seed) pair; it replays the full request stream
through one policy of the flat engine (:mod:`repro_torch.cache.flat`) with
the delayed-hit classifier fused into the same pass through a per-key
fetch-expiry table, and writes per request: hit, evicted key, packed op
vector and class.

:func:`replay_lanes` is the kernel wrapper.  On a CUDA tensor it launches
the hand-written kernel (``csrc/replay.cu``: one warp per lane, each
policy's lists in place of the flat engine's masked argmins) or raises; on
a CPU tensor it runs the plain PyTorch version, :func:`replay_lanes_plain`,
which loops the flat steps over the stream with every lane batched.  The
two are bit-identical.  :func:`replay_layout` places a lane's state: in
shared memory, or in device memory when it does not fit there.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache import flat
from repro_torch.cache.replay import (DELAYED_HIT, TRUE_HIT, TRUE_MISS,
                                      _FAR_PAST, _padded, _resolve_key_space,
                                      _window_stream)
from repro_torch.kernels import _build

# Where a lane's state lives (``LAYOUT`` in ``csrc/replay.cu``): per-key
# tables and slot arrays in shared memory with int16 links, or all in
# device memory with int32 links.
LAYOUTS = ("shared", "global")
_STAGE_BYTES = 7 * 32 * 4  # one batch of 32 requests in and out
_INT16_MAX_PAD = 1 << 15


class ReplayLayout(NamedTuple):
    """A lane's state layout and its bytes (``csrc/replay.cu``'s)."""

    kind: str            # one of LAYOUTS
    shared_bytes: int    # dynamic shared memory per block
    scratch_bytes: int   # device-memory scratch per lane


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def layout_bytes(policy: str, key_space: int, pad: int,
                 kind: str) -> ReplayLayout:
    """The bytes of one lane's state in layout ``kind``: the per-key
    region (expiry int32, key2slot, S3-FIFO's ghost counts) and the
    per-slot region (slot2key int32, S3-FIFO's ghost ring and free
    bitmaps, two links, the reference and membership bytes)."""
    link = 4 if kind == "global" else 2
    words = -(-pad // 32)
    keys = _align16(4 * key_space) + _align16(link * key_space)
    slots = _align16(4 * pad) + 2 * _align16(link * pad)
    if policy == "s3fifo":
        keys += _align16(link * key_space)
        slots += (_align16(4 * pad) + _align16(4 * words)
                  + _align16(4 * -(-words // 32)))
    slots += _align16(pad) * ((policy in ("clock", "s3fifo", "sieve"))
                              + (policy in ("slru", "s3fifo")))
    if kind == "shared":
        return ReplayLayout(kind, _STAGE_BYTES + keys + slots, 0)
    return ReplayLayout(kind, _STAGE_BYTES, keys + slots)


def layout_fits(layout: ReplayLayout, pad: int) -> bool:
    """Whether one block holds the layout's shared memory, and its int16
    links the pad."""
    return layout.kind == "global" or (
        pad <= _INT16_MAX_PAD
        and layout.shared_bytes <= _build.MAX_SHARED_BYTES)


def replay_layout(policy: str, key_space: int, pad: int) -> ReplayLayout:
    """The first layout of LAYOUTS that fits (the last always does)."""
    layouts = (layout_bytes(policy, key_space, pad, kind) for kind in LAYOUTS)
    return next(lay for lay in layouts if layout_fits(lay, pad))


class ReplayGridResult(NamedTuple):
    """Replay grid output on the run's device, shaped (C, S, T).

    ``ops`` is packed (:func:`unpack_grid_ops` appends the length-4 op
    axis); ``cls`` is the fused delayed-hit classification (int8) or None
    when no window was given.
    """

    hits: torch.Tensor          # (C, S, T) bool
    evicted: torch.Tensor       # (C, S, T) int32, -1 if none
    ops: torch.Tensor           # (C, S, T) int32, packed op vectors
    cls: Optional[torch.Tensor]  # (C, S, T) int8, or None


def replay_lanes_plain(policy: str, pvecs: torch.Tensor, qs: torch.Tensor,
                       keys: torch.Tensor, us: torch.Tensor,
                       windows: torch.Tensor, key_space: int,
                       pad: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's plain PyTorch version: the flat step plus the fused
    classification, one request at a time over all lanes at once.

    Returns ``(hits, evicted, packed_ops, cls)``, each ``(L, T)`` int32.
    """
    n_l, n_t = keys.shape
    dev = keys.device
    st = flat.flat_state_init(key_space, pad, lanes=n_l, device=dev)
    expiry = torch.full((n_l, key_space), int(_FAR_PAST), dtype=torch.int32,
                        device=dev)
    outs = [torch.empty((n_l, n_t), dtype=torch.int32, device=dev)
            for _ in range(4)]
    step = flat.FLAT_STEPS[policy]
    keys = keys.long()
    for t in range(n_t):
        k = keys[:, t]
        hit, evicted, ops4 = step(st, k, us[:, t], pvecs, qs)
        outstanding = t <= flat._take(expiry, k)
        cls = torch.where(outstanding, DELAYED_HIT,
                          torch.where(hit, TRUE_HIT, TRUE_MISS))
        flat._put(expiry, k, t + windows[:, t], ~outstanding & ~hit)
        outs[0][:, t] = hit.to(torch.int32)
        outs[1][:, t] = evicted
        outs[2][:, t] = flat.pack_ops(ops4)
        outs[3][:, t] = cls
    return tuple(outs)


def _check_lane_inputs(pvecs, qs, keys, us, windows) -> None:
    n_l, n_t = keys.shape
    want = {"pvecs": (pvecs, torch.int32, (n_l, flat.N_PARAMS)),
            "qs": (qs, torch.float32, (n_l,)),
            "keys": (keys, torch.int32, (n_l, n_t)),
            "us": (us, torch.float32, (n_l, n_t)),
            "windows": (windows, torch.int32, (n_l, n_t))}
    for name, (t, dtype, shape) in want.items():
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def replay_lanes(policy: str, pvecs: torch.Tensor, qs: torch.Tensor,
                 keys: torch.Tensor, us: torch.Tensor, windows: torch.Tensor,
                 key_space: int, pad: int) -> Tuple[torch.Tensor, ...]:
    """Replay ``(L, T)`` lanes: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns ``(hits, evicted, packed_ops, cls)``,
    each ``(L, T)`` int32 on the inputs' device.

    Inputs: ``pvecs`` (L, N_PARAMS) int32, ``qs`` (L,) float32, ``keys``
    (L, T) int32 in ``[0, key_space)``, ``us`` (L, T) float32 and
    ``windows`` (L, T) int32, all contiguous on one device.
    """
    if policy not in flat.POLICY_IDS:
        raise KeyError(f"unknown policy {policy!r}")
    _check_lane_inputs(pvecs, qs, keys, us, windows)
    _check_params(policy, pvecs, pad)
    if keys.device.type == "cpu":
        return replay_lanes_plain(policy, pvecs, qs, keys, us, windows,
                                  key_space, pad)
    if keys.device.type != "cuda":
        raise ValueError(f"no replay kernel for device {keys.device}")
    if keys.numel() and (int(keys.min()) < 0 or int(keys.max()) >= key_space):
        raise ValueError(f"keys out of range for key_space={key_space}")
    return _launch(_build.load_library(), policy,
                   replay_layout(policy, key_space, pad),
                   (pvecs, qs, keys, us, windows), key_space, pad)


def _check_params(policy: str, pvecs: torch.Tensor, pad: int) -> None:
    """Both versions index slots by the parameters: hold them to the slot
    arrays (``flat_lane_params`` gives cap <= pad for a grid)."""
    if pad < 1:
        raise ValueError(f"pad must be >= 1, got {pad}")
    p = pvecs.cpu()
    cap, ghost = p[:, flat.P_CAP], p[:, flat.P_GHOST_CAP]
    if p.numel() and int(cap.max()) > pad:
        raise ValueError(f"capacity {int(cap.max())} > pad {pad}")
    if policy == "s3fifo" and p.numel() and not (
            int(ghost.min()) >= 1 and int(ghost.max()) <= pad):
        raise ValueError(f"ghost ring capacity outside [1, pad={pad}]")


def _launch(lib, policy: str, layout: ReplayLayout, args, key_space: int,
            pad: int) -> Tuple[torch.Tensor, ...]:
    """One launch of ``lib``'s replay kernel in ``layout`` on the inputs'
    device, counted in ``replay_lanes.launches``; the scratch is allocated
    here, for every lane."""
    keys = args[2]
    n_l, n_t = keys.shape
    outs = [torch.empty((n_l, n_t), dtype=torch.int32, device=keys.device)
            for _ in range(4)]
    scratch = torch.empty(max(1, n_l * layout.scratch_bytes),
                          dtype=torch.uint8, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.replay_launch(
            flat.POLICY_IDS[policy], LAYOUTS.index(layout.kind),
            *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
            scratch.data_ptr(), scratch.numel(), n_l, n_t, key_space, pad,
            stream)
    _build.check(err, f"replay kernel launch ({layout.kind} layout)")
    replay_lanes.launches += 1
    return tuple(outs)


replay_lanes.launches = 0  # kernel launches (CUDA path only)


def _lane_inputs(policy: str, keys, us, capacities, key_space, pad_to,
                 params) -> Tuple[Any, ...]:
    """Host-side lane setup: validate, normalise to (S, T), build per-lane
    parameter vectors, and tile everything to the (C*S,) lane axis
    (lane = c * S + s, so outputs reshape to (C, S, T))."""
    keys = np.asarray(keys)
    us = np.asarray(us)
    if keys.shape != us.shape:
        raise ValueError(f"keys {keys.shape} vs us {us.shape} shape mismatch")
    if keys.ndim == 1:
        keys = keys[None, :]
        us = us[None, :]
    elif keys.ndim != 2:
        raise ValueError(f"keys must be (T,) or (S, T), got {keys.shape}")
    key_space = _resolve_key_space(keys, key_space)
    caps = [int(c) for c in np.atleast_1d(np.asarray(capacities))]
    if not caps:
        raise ValueError("need at least one capacity")
    pad = _padded(max(caps), pad_to)
    per_cap = [flat.flat_lane_params(policy, c, **params) for c in caps]
    pvecs = np.stack([v for v, _ in per_cap])
    qs = np.asarray([q for _, q in per_cap], np.float32)
    n_s = keys.shape[0]
    keys_l = np.tile(keys, (len(caps), 1)).astype(np.int32)
    us_l = np.tile(us, (len(caps), 1)).astype(np.float32)
    pvecs_l = np.repeat(pvecs, n_s, axis=0)
    qs_l = np.repeat(qs, n_s)
    return keys_l, us_l, pvecs_l, qs_l, key_space, pad, len(caps), n_s


class GridLanes(NamedTuple):
    """A (capacity x seed) grid laid out as lanes for :func:`replay_lanes`."""

    args: Tuple[torch.Tensor, ...]  # (pvecs, qs, keys, us, windows)
    key_space: int
    pad: int
    shape: Tuple[int, int, int]  # (C, S, T)


def grid_lanes(policy: str, keys, us, capacities, *,
               key_space: Optional[int] = None, pad_to: Optional[int] = None,
               window=None, fail_prob: float = 0.0, fail_seed: int = 0,
               device: str = "cuda", **params: Any) -> GridLanes:
    """Validate a grid and lay it out as lane tensors on ``device``."""
    dev = resolve_device(device)
    (keys_l, us_l, pvecs_l, qs_l, key_space, pad,
     n_caps, n_s) = _lane_inputs(policy, keys, us, capacities, key_space,
                                 pad_to, params)
    win_l = np.broadcast_to(
        _window_stream(window, keys_l.shape[1], fail_prob, fail_seed),
        keys_l.shape,
    )
    args = tuple(torch.tensor(a, device=dev)
                 for a in (pvecs_l, qs_l, keys_l, us_l, win_l))
    return GridLanes(args, key_space, pad, (n_caps, n_s, keys_l.shape[1]))


def replay_grid_fused(policy: str, keys, us, capacities, *,
                      key_space: Optional[int] = None,
                      pad_to: Optional[int] = None,
                      window=None, fail_prob: float = 0.0,
                      fail_seed: int = 0, device: str = "cuda",
                      **params: Any) -> ReplayGridResult:
    """Replay a (capacity x seed) grid with the flat engine, fusing the
    delayed-hit classification into the same pass.

    The counterpart of ``repro.kernels.replay.replay_grid_pallas``: the
    same hits / evicted keys / packed ops, plus the ``classify_inflight``
    classes when ``window`` is given (scalar or per-request (T,) array;
    ``fail_prob`` stretches windows by geometric re-issue attempts exactly
    like the classifier).  One kernel launch on the card.
    """
    grid = grid_lanes(policy, keys, us, capacities, key_space=key_space,
                      pad_to=pad_to, window=window, fail_prob=fail_prob,
                      fail_seed=fail_seed, device=device, **params)
    hits, evicted, ops, cls = replay_lanes(policy, *grid.args,
                                           grid.key_space, grid.pad)
    return ReplayGridResult(
        hits=hits.reshape(grid.shape) != 0,
        evicted=evicted.reshape(grid.shape),
        ops=ops.reshape(grid.shape),
        cls=(cls.reshape(grid.shape).to(torch.int8)
             if window is not None else None),
    )


def unpack_grid_ops(res: ReplayGridResult) -> np.ndarray:
    """Host-side (C, S, T, 4) int64 op counts, matching ReplayResult.ops."""
    return flat.unpack_ops(res.ops).cpu().numpy().astype(np.int64)
