"""The streaming estimators over replayed key streams: ``sketch_trace``.

Port of the reference's ``_sketch_trace`` (``src/repro/obs/streaming.py``),
a jitted ``lax.scan``; the reference has no Pallas kernel for it.  Each
lane is one key stream; per event, in the reference's order: tick,
arrival, key, completion (branch 0, a hit as the stream says, never
delayed) on the lane's :class:`~repro_torch.obs.streaming.SketchState`.

:func:`sketch_trace_lanes` is the kernel wrapper: on CUDA tensors it
launches the hand-written kernel (``csrc/sketch_trace.cu``: one warp per
stream, on the device code of ``csrc/sketch.cuh`` that the event-sim
kernel's sketched instantiations run too, the SpaceSaving table in
registers up to a cap of 512, in the form :func:`sketch_trace_form`
chooses) or raises; on CPU tensors it runs the plain version,
:func:`sketch_trace_plain`, the loop of the lane functions of
:mod:`repro_torch.obs.streaming` over every lane at once.
Both give the reference's state: every integer field exactly, the EWMA
bit for bit where XLA's CPU backend computes the reference's (fused
multiply-adds, IEEE division).

:class:`_SketchArgs` is the ``SketchArgs`` struct of ``csrc/sketch.cuh``:
the state's device pointers, the batch-decay table and the sizes, shared
with the event-sim kernel's sketched launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.obs.streaming import (N_WINDOWS, SketchState, cm_columns,
                                       pow_table, sketch_init, stream_arrival,
                                       stream_done, stream_key, stream_tick,
                                       window_ids)


class _SketchArgs(ctypes.Structure):
    """``SketchArgs`` of ``csrc/sketch.cuh``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "win_id", "win_done", "win_hit", "win_dly", "win_arr", "win_br",
        "ewma_hit", "ewma_dly", "ewma_norm", "cm", "ss_key", "ss_count",
        "ss_err", "key_count", "decay", "bmiss")]
        + [("window_us", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in (
            "n_windows", "n_b", "cap", "width", "n_decay")])


def sketch_args(sk: SketchState, window_us: float, decay: torch.Tensor,
                bmiss: Optional[torch.Tensor] = None) -> _SketchArgs:
    """The launch struct of the CUDA state ``sk`` (contiguous tensors,
    updated in place), the decay table ``decay`` and, for the simulator,
    the (L, B) int32 miss classes ``bmiss``; the caller keeps the tensors
    alive until the launch ends."""
    for name, t in sk._asdict().items():
        if not t.is_contiguous():
            raise ValueError(f"sketch state {name} must be contiguous")
    a = _SketchArgs(*(t.data_ptr() for t in sk), decay.data_ptr(),
                    None if bmiss is None else bmiss.data_ptr())
    a.window_us = float(window_us)
    a.n_windows = sk.win_id.shape[1] - 1
    a.n_b = sk.win_branch_count.shape[2]
    a.cap = sk.ss_key.shape[1] - 1
    a.width = sk.cm_count.shape[2] - 1
    a.n_decay = decay.shape[0]
    return a


@torch.inference_mode()
def sketch_trace_plain(keys: torch.Tensor, t_us: torch.Tensor,
                       hits: torch.Tensor, *, sketch_cap: int,
                       window_us: float,
                       n_windows: int = N_WINDOWS) -> SketchState:
    """The kernel's plain PyTorch version: every lane's events in order,
    the lanes batched, on the inputs' device.  The events' window ids,
    count-min columns and hit flags depend on the inputs alone, so they
    are computed for the whole stream before the loop; an event in the
    same window as the one before it, in every lane, finds its ring row
    holding that window, so its tick is its row alone."""
    n_l, n = keys.shape
    sk = sketch_init(sketch_cap, 1, n_l, n_windows, device=keys.device)
    branch = torch.zeros(n_l, dtype=torch.int64, device=keys.device)
    wids = window_ids(t_us, window_us)
    slots = torch.remainder(wids, n_windows).long()
    moved = [True] + (wids[:, 1:] != wids[:, :-1]).any(dim=0).tolist()
    cols = cm_columns(keys, sk.cm_count.shape[2] - 1)
    hit = hits > 0
    for i in range(n):
        slot = (stream_tick(sk, t_us[:, i], window_us, wid=wids[:, i])
                if moved[i] else slots[:, i])
        stream_arrival(sk, slot, None)
        stream_key(sk, keys[:, i], None, cols=cols[:, i])
        stream_done(sk, slot, branch, hit[:, i], False, None)
    return sk


# The kernel's register table (csrc/sketch.cuh RegTable): S slots a thread
# for caps up to 32 * S; a larger cap keeps the table in device memory (S 0)
REG_SLOTS = (1, 2, 4, 8, 16)
# its packed form holds a count in PACK_COUNT_BITS bits, so it takes streams
# of at most PACK_MAX_KEYS keys (no count reaches 2**PACK_COUNT_BITS)
PACK_COUNT_BITS = 22
PACK_MAX_KEYS = (1 << PACK_COUNT_BITS) - 1


def sketch_trace_form(sketch_cap: int, n: int) -> tuple[int, bool]:
    """The kernel's instantiation for streams of ``n`` keys at
    ``sketch_cap``: ``(S, packed)``, S SpaceSaving slots a thread in
    registers (the least of :data:`REG_SLOTS` with ``32 * S >=
    sketch_cap``; 0 past 512: the table in device memory), ``packed`` one
    warp reduction per key (where S > 0 and ``n <= PACK_MAX_KEYS``), else
    three."""
    slots = next((s for s in REG_SLOTS if 32 * s >= sketch_cap), 0)
    return slots, slots > 0 and n <= PACK_MAX_KEYS


def _check_form(form, sketch_cap: int, n: int) -> tuple[int, bool]:
    """``form``, or :func:`sketch_trace_form`'s when None; raises unless
    the kernel has that instantiation and it takes these streams."""
    if form is None:
        return sketch_trace_form(sketch_cap, n)
    slots, packed = int(form[0]), bool(form[1])
    if slots not in (0,) + REG_SLOTS or (slots and 32 * slots < sketch_cap):
        raise ValueError(f"no sketch_trace form with {slots} slots a thread "
                         f"at sketch_cap {sketch_cap}")
    if packed and (slots == 0 or n > PACK_MAX_KEYS):
        raise ValueError(f"the packed form needs slots > 0 and n <= "
                         f"{PACK_MAX_KEYS}, got {slots} slots, n {n}")
    return slots, packed


def sketch_trace_lanes(keys: torch.Tensor, t_us: torch.Tensor,
                       hits: torch.Tensor, *, sketch_cap: int,
                       window_us: float, n_windows: int = N_WINDOWS,
                       form: Optional[tuple[int, bool]] = None
                       ) -> SketchState:
    """The sketches of ``L`` key streams: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    ``keys`` is (L, n) int32, ``t_us`` (L, n) float32 event times in µs,
    ``hits`` (L, n) int32 (nonzero: a hit), all on one device.  Returns
    the lanes' :class:`~repro_torch.obs.streaming.SketchState`.
    ``form`` picks another instantiation than :func:`sketch_trace_form`'s,
    ``(S, packed)``: every form gives the same state.  Launches are counted
    in ``sketch_trace_lanes.launches``.
    """
    if sketch_cap <= 0:
        raise ValueError("sketch_trace needs sketch_cap > 0")
    if window_us <= 0:
        raise ValueError("sketch_trace needs window_us > 0")
    if n_windows < 1:
        raise ValueError(f"n_windows must be >= 1, got {n_windows}")
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError("keys must be (L, n) int32")
    for name, a, dt in (("t_us", t_us, torch.float32),
                        ("hits", hits, torch.int32)):
        if a.shape != keys.shape or a.dtype != dt:
            raise ValueError(f"{name} must be {dt} {tuple(keys.shape)}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != keys.device:
            raise ValueError(f"{name} on {a.device}, keys on {keys.device}")
    slots, packed = _check_form(form, sketch_cap, keys.shape[1])
    dev = keys.device
    if dev.type == "cpu":
        return sketch_trace_plain(keys, t_us, hits, sketch_cap=sketch_cap,
                                  window_us=window_us, n_windows=n_windows)
    if dev.type != "cuda":
        raise ValueError(f"no sketch_trace kernel for device {dev}")
    n_l, n = keys.shape
    sk = sketch_init(sketch_cap, 1, n_l, n_windows, device=dev)
    decay = pow_table(0, device=dev)
    ins = [a.contiguous() for a in (keys, t_us, hits)]
    args = sketch_args(sk, window_us, decay)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sketch_trace_launch(ctypes.byref(args),
                                      *(a.data_ptr() for a in ins), n_l, n,
                                      slots, int(packed), stream)
    _build.check(err, "sketch_trace kernel launch")
    sketch_trace_lanes.launches += 1
    return sk


sketch_trace_lanes.launches = 0  # kernel launches (CUDA path only)
