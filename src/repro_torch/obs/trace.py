"""Per-request trace records and the ring buffers the simulator fills.

Port of ``repro.obs.trace`` (``src/repro/obs/trace.py``).  The host-side
half (the class ids, :class:`TraceRecords`, :func:`make_records`,
:func:`trace_from_rings` and :func:`decode_trace_grid`) is numpy and is
copied as it is; :class:`TraceRings` holds the simulator's ring buffers as
torch tensors with an explicit lane axis.  :class:`PyTraceCollector`, the
heapq oracles' collector (``repro_torch.core.py_sim``), is copied as well.

One trace record describes one *completed request* (one pass through a
routing branch of the queueing network):

==============  =======  ====================================================
field           dtype    meaning
==============  =======  ====================================================
``req``         int32    global completion index (0-based, includes warmup)
``branch``      int32    routing-branch id (encodes key class / tier / shard)
``cls``         int32    sojourn class: 0 miss, 1 true hit, 2 delayed hit
``nvis``        int32    stations visited (delayed hits stop at the park
                         visit; the MSHR leader's fill serves them)
``parked_us``   float32  interval parked on an MSHR entry (0 unless delayed)
``enter_us``    float32  ``(L,)`` absolute sim-clock µs entering visit *i*
``leave_us``    float32  ``(L,)`` absolute sim-clock µs leaving visit *i*
==============  =======  ====================================================

Station ids are not stored per record: they are a pure function of
``branch`` through the network's static ``visits`` table and are rebuilt
at decode time (:func:`make_records`).

The rings have ``cap + 1`` rows per lane; row ``cap`` is a scrap row that
the plain simulator's masked writes land in, and decode drops it.  A
record is written at row ``req % cap``, so on overflow the ring holds the
last ``cap`` records.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Sojourn classes.
CLS_MISS = 0
CLS_HIT = 1
CLS_DELAYED = 2

CLASS_NAMES = {CLS_MISS: "miss", CLS_HIT: "hit", CLS_DELAYED: "delayed"}


# ---------------------------------------------------------------------------
# Simulator-side ring buffers (torch, lane-batched)
# ---------------------------------------------------------------------------


class TraceRings(NamedTuple):
    """Fixed-capacity struct-of-arrays ring buffers, one per lane.

    Record arrays have ``cap + 1`` rows per lane; the last row is scrap
    and is dropped at decode time.  ``n_count`` is the number of records
    each lane *emitted* (overwritten ones included), so
    ``max(0, n_count - cap)`` is its overflow drop count.
    """

    n_count: torch.Tensor  # (lanes,) int32
    req: torch.Tensor  # (lanes, cap+1) int32, -1 = never written
    branch: torch.Tensor  # (lanes, cap+1) int32
    cls: torch.Tensor  # (lanes, cap+1) int32
    nvis: torch.Tensor  # (lanes, cap+1) int32
    parked_us: torch.Tensor  # (lanes, cap+1) float32
    enter_us: torch.Tensor  # (lanes, cap+1, L) float32
    leave_us: torch.Tensor  # (lanes, cap+1, L) float32


def init_rings(lanes: int, cap: int, route_len: int,
               device: torch.device) -> TraceRings:
    """Empty rings: ``req`` -1 (never written), everything else 0."""
    if cap <= 0:
        raise ValueError(f"trace ring capacity must be > 0, got {cap}")

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((lanes, cap + 1) + shape, dtype=dtype,
                           device=device)

    return TraceRings(
        n_count=torch.zeros(lanes, dtype=torch.int32, device=device),
        req=torch.full((lanes, cap + 1), -1, dtype=torch.int32,
                       device=device),
        branch=zeros(), cls=zeros(), nvis=zeros(),
        parked_us=zeros(dtype=torch.float32),
        enter_us=zeros(route_len, dtype=torch.float32),
        leave_us=zeros(route_len, dtype=torch.float32),
    )


# ---------------------------------------------------------------------------
# Host-side decoded trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceRecords:
    """A decoded, req-sorted batch of trace records (host-side numpy)."""

    req: np.ndarray  # (M,) int64, ascending
    branch: np.ndarray  # (M,) int64
    cls: np.ndarray  # (M,) int64
    nvis: np.ndarray  # (M,) int64
    parked_us: np.ndarray  # (M,) float64
    enter_us: np.ndarray  # (M, L) float64, NaN past nvis
    leave_us: np.ndarray  # (M, L) float64, NaN past nvis
    station: np.ndarray  # (M, L) int64, -1 past nvis (or visits unknown)
    n_emitted: int  # total records the run produced (>= M on overflow)

    def __len__(self) -> int:
        return int(self.req.shape[0])

    @property
    def n_dropped(self) -> int:
        """Records lost to ring-buffer overflow."""
        return max(0, self.n_emitted - len(self))

    @property
    def start_us(self) -> np.ndarray:
        return self.enter_us[:, 0]

    @property
    def end_us(self) -> np.ndarray:
        if len(self) == 0:
            return np.zeros(0)
        last = np.maximum(self.nvis - 1, 0)
        return self.leave_us[np.arange(len(self)), last]

    @property
    def sojourn_us(self) -> np.ndarray:
        return self.end_us - self.start_us

    def class_counts(self) -> dict[str, int]:
        return {
            name: int((self.cls == c).sum()) for c, name in CLASS_NAMES.items()
        }

    def branch_counts(self, n_branches: int) -> np.ndarray:
        return np.bincount(self.branch, minlength=n_branches)[:n_branches]


def make_records(
    req,
    branch,
    cls,
    nvis,
    parked_us,
    enter_us,
    leave_us,
    visits=None,
    n_emitted=None,
) -> TraceRecords:
    """Normalize per-record arrays (lists/arrays) into TraceRecords.

    Takes already-valid per-record arrays, sorts them by ``req``, and
    rebuilds per-visit station ids from the network's static ``visits``
    table.
    """
    req = np.asarray(req, dtype=np.int64)
    order = np.argsort(req, kind="stable")
    req = req[order]
    branch = np.asarray(branch, dtype=np.int64)[order]
    cls = np.asarray(cls, dtype=np.int64)[order]
    nvis = np.asarray(nvis, dtype=np.int64)[order]
    parked_us = np.asarray(parked_us, dtype=np.float64)[order]
    enter_us = np.asarray(enter_us, dtype=np.float64)[order]
    leave_us = np.asarray(leave_us, dtype=np.float64)[order]
    if enter_us.ndim == 1:
        enter_us = enter_us[:, None]
        leave_us = leave_us[:, None]
    m, route_len = enter_us.shape
    cols = np.arange(route_len)[None, :]
    pad = cols >= nvis[:, None]
    enter_us = np.where(pad, np.nan, enter_us)
    leave_us = np.where(pad, np.nan, leave_us)
    if visits is not None:
        station = np.asarray(visits, dtype=np.int64)[branch]
        station = np.where(pad, -1, station[:, :route_len])
    else:
        station = np.full((m, route_len), -1, dtype=np.int64)
    return TraceRecords(
        req=req,
        branch=branch,
        cls=cls,
        nvis=nvis,
        parked_us=parked_us,
        enter_us=enter_us,
        leave_us=leave_us,
        station=station,
        n_emitted=int(len(req) if n_emitted is None else n_emitted),
    )


def trace_from_rings(
    n,
    req,
    branch,
    cls,
    nvis,
    parked_us,
    enter_us,
    leave_us,
    visits=None,
) -> TraceRecords:
    """Decode one lane's ring arrays (numpy) into TraceRecords.

    The scrap row (last) and never-written slots (``req < 0``) are
    dropped; on overflow the surviving slots are exactly the last ``cap``
    records.
    """
    req = np.asarray(req)[:-1]
    keep = req >= 0
    return make_records(
        req[keep],
        np.asarray(branch)[:-1][keep],
        np.asarray(cls)[:-1][keep],
        np.asarray(nvis)[:-1][keep],
        np.asarray(parked_us)[:-1][keep],
        np.asarray(enter_us)[:-1][keep],
        np.asarray(leave_us)[:-1][keep],
        visits=visits,
        n_emitted=int(n),
    )


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def decode_trace_grid(rings: TraceRings, visits, S: int, P: int):
    """Decode lane-batched :class:`TraceRings` (lane ``s*P + p``, on any
    device) into ``[seed][p]`` :class:`TraceRecords` lists."""
    n, req, branch, cls, nvis, parked_us, enter_us, leave_us = (
        _host(a) for a in rings)
    visits = _host(visits)
    out = []
    for s in range(S):
        row = []
        for p in range(P):
            i = s * P + p
            row.append(
                trace_from_rings(
                    n[i], req[i], branch[i], cls[i], nvis[i], parked_us[i],
                    enter_us[i], leave_us[i], visits=visits,
                )
            )
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Python-oracle collector
# ---------------------------------------------------------------------------


class PyTraceCollector:
    """Trace collector for the heapq oracles (same schema, same capping).

    The oracle stamps ``enter(j, pos, t)`` when job *j* is placed at its
    ``pos``-th visit, ``leave(j, pos, t)`` when that visit's service (or
    MSHR park) ends, and ``complete(...)`` when the request finishes.
    ``finish(visits)`` keeps the last ``cap`` records, mirroring the
    ring buffer's overwrite semantics.
    """

    def __init__(self, cap: int, n_jobs: int, route_len: int):
        self.cap = int(cap)
        self.route_len = int(route_len)
        self._enter_us = [[np.nan] * route_len for _ in range(n_jobs)]
        self._leave_us = [[np.nan] * route_len for _ in range(n_jobs)]
        self._records: list[tuple] = []
        self.n_emitted = 0

    def start(self, j: int, t_us: float) -> None:
        self._enter_us[j] = [np.nan] * self.route_len
        self._leave_us[j] = [np.nan] * self.route_len
        self._enter_us[j][0] = t_us

    def enter(self, j: int, pos: int, t_us: float) -> None:
        self._enter_us[j][pos] = t_us

    def leave(self, j: int, pos: int, t_us: float) -> None:
        self._leave_us[j][pos] = t_us

    def enter_at(self, j: int, pos: int) -> float:
        return self._enter_us[j][pos]

    def complete(
        self, j: int, branch: int, cls: int, nvis: int, parked_us: float
    ) -> int:
        """Emit job j's record; returns the assigned request id."""
        req = self.n_emitted
        self.n_emitted += 1
        self._records.append(
            (
                req,
                branch,
                cls,
                nvis,
                parked_us,
                list(self._enter_us[j]),
                list(self._leave_us[j]),
            )
        )
        if self.cap > 0 and len(self._records) > self.cap:
            del self._records[0]
        return req

    def finish(self, visits=None) -> TraceRecords:
        if not self._records:
            empty_l = np.zeros((0, self.route_len))
            return make_records(
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int64),
                np.zeros(0),
                empty_l,
                empty_l,
                visits=visits,
                n_emitted=self.n_emitted,
            )
        req, branch, cls, nvis, parked_us, enter_us, leave_us = zip(
            *self._records
        )
        return make_records(
            req,
            branch,
            cls,
            nvis,
            parked_us,
            np.asarray(enter_us),
            np.asarray(leave_us),
            visits=visits,
            n_emitted=self.n_emitted,
        )
