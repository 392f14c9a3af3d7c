"""Network -> simulator-spec compilation (port of ``repro.core.simspec``).

:func:`compile_network` freezes a :class:`~repro_torch.core.queueing.ClosedNetwork`
at one hit ratio into flat arrays (:class:`SimSpec`) that an event loop
indexes with station ids; :func:`stack_specs` stacks a grid of them along a
leading lane axis, padding networks of different shapes.  The arrays are
built in numpy exactly as the JAX package builds them and then placed on
the requested device as tensors.

:class:`SimResult` is the closed-loop summary the simulator returns.

:class:`MshrSpec` is the cross-tier MSHR annotation table of a tiered
(hierarchy) network: per-(branch, visit-position) acquire and release
marks that generalize the single ``disk_rank`` convention to a DAG of
caches (numpy, a copy of the reference's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.queueing import QUEUE, ClosedNetwork

# Sentinels: "idle / not ready" times and "not enqueued" sequence numbers.
INF_NS = np.int32(2**31 - 1)
BIG_SEQ = np.int32(2**31 - 1)

_DIST_IDS = {"det": 0, "exp": 1, "pareto": 2}


class SimSpec(NamedTuple):
    """A closed network compiled to tensors at one (or a grid of) p_hit."""

    is_queue: torch.Tensor  # (K,) bool
    svc_ns: torch.Tensor  # (K,) f32 mean service in ns
    dist_id: torch.Tensor  # (K,) i32
    dist_params: torch.Tensor  # (K, 4) f32: alpha, lo, hi, raw_mean (pareto)
    branch_cum: torch.Tensor  # (B,) f32 cumulative branch probabilities
    visits: torch.Tensor  # (B, L) i32 station indices, -1 padded
    servers: torch.Tensor  # (K,) i32 FCFS server count (1 for think stations)
    disk_rank: torch.Tensor  # (K,) i32 backing-store group id, -1 for non-disks
    mpl: int


def _bounded_pareto_mean(alpha: float, lo: float, hi: float) -> float:
    if abs(alpha - 1.0) < 1e-9:
        return lo * hi / (hi - lo) * math.log(hi / lo)
    num = lo**alpha * alpha * (lo ** (1 - alpha) - hi ** (1 - alpha))
    den = (alpha - 1.0) * (1.0 - (lo / hi) ** alpha)
    return num / den


def compile_network(net: ClosedNetwork, p_hit: float,
                    device: str = "cuda") -> SimSpec:
    """Freeze a network at a given hit ratio into simulator tensors."""
    dev = resolve_device(device)
    names = [s.name for s in net.stations]
    idx = {n: i for i, n in enumerate(names)}
    K = len(names)
    is_queue = np.array([s.kind == QUEUE for s in net.stations], dtype=bool)
    svc_ns = np.array(
        [s.mean_service(p_hit) * 1e3 for s in net.stations], dtype=np.float32
    )
    dist_id = np.array([_DIST_IDS[s.dist] for s in net.stations], dtype=np.int32)
    dist_params = np.zeros((K, 4), dtype=np.float32)
    for i, s in enumerate(net.stations):
        if s.dist == "pareto":
            alpha, lo, hi = s.dist_params
            dist_params[i] = (alpha, lo, hi, _bounded_pareto_mean(alpha, lo, hi))
        else:
            dist_params[i] = (1.0, 1.0, 1.0, 1.0)

    probs = np.array([b.probability(p_hit) for b in net.branches], dtype=np.float64)
    if not math.isclose(probs.sum(), 1.0, abs_tol=1e-5):
        raise ValueError(f"branch probs sum to {probs.sum()} at p={p_hit}")
    probs = np.maximum(probs, 0.0)
    branch_cum = np.cumsum(probs / probs.sum()).astype(np.float32)

    L = max(len(b.visits) for b in net.branches)
    if min(len(b.visits) for b in net.branches) == 0:
        raise ValueError("empty branch routes are not supported")
    visits = np.full((len(net.branches), L), -1, dtype=np.int32)
    for bi, b in enumerate(net.branches):
        for vi, v in enumerate(b.visits):
            visits[bi, vi] = idx[v]
    if is_queue[visits[:, 0]].any():
        # init places all mpl jobs straight into service at their first
        # station; a queue-first route would bypass the busy accounting.
        raise ValueError("branch routes must start at a think station")

    servers = np.array(
        [s.servers if s.kind == QUEUE else 1 for s in net.stations],
        dtype=np.int32,
    )

    # A station is a backing store if it is named "disk" (bare or a
    # per-shard "sK:disk" replica); each gets its own rank.
    disk_rank = np.full(K, -1, dtype=np.int32)
    rank = 0
    for i, name in enumerate(names):
        if name.split(":")[-1] == "disk":
            disk_rank[i] = rank
            rank += 1

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    return SimSpec(
        is_queue=t(is_queue), svc_ns=t(svc_ns), dist_id=t(dist_id),
        dist_params=t(dist_params), branch_cum=t(branch_cum),
        visits=t(visits), servers=t(servers), disk_rank=t(disk_rank),
        mpl=net.mpl,
    )


class MshrSpec(NamedTuple):
    """Cross-tier MSHR annotations for one composed (tiered) network.

    All arrays are shaped like ``SimSpec.visits`` (B branches × L route
    positions, -1 meaning "nothing here") and are *hit-ratio independent*
    (branch probabilities change with p, routes do not):

    ``acq_group[b, i]``
        MSHR group acquired on ARRIVAL at visit ``(b, i)``.  With F flows
        per group, the fetch for flow ``f`` of group ``g`` lives at leader
        slot ``g*F + f``.  Groups 0..n_clients-1 are the per-client L1
        tables; the shard-local origin tables follow (the deeper tier's
        coalescing never crosses shards).
    ``acq_slot[b, i]``
        Which of the job's ``max_held`` held-entry registers the
        acquisition writes (0 = shallowest tier).
    ``rel_slot[b, i]``
        Held-entry register released on COMPLETION of visit ``(b, i)`` —
        the fill lands, every request parked on that slot completes as a
        delayed hit (cascading across tiers: a woken job releases *its*
        held entries too, waking its own followers).

    Semantics contract (the event-sim kernel, its plain version and the
    heapq oracle :mod:`repro_torch.core.py_sim`): a job samples one flow
    per request at its first acquire point; arriving at an acquire
    position whose slot already has a leader, it parks — no queue
    position, no I/O-depth slot, no further route visits — and completes
    at fill time, skipping all fill metadata (the single-tier delayed-hit
    convention).
    """

    acq_group: np.ndarray  # (B, L) i32, -1 = no acquire at this visit
    acq_slot: np.ndarray  # (B, L) i32, -1 matching acq_group
    rel_slot: np.ndarray  # (B, L) i32, -1 = no release at this visit
    n_groups: int
    max_held: int

    def validate(self, visits: np.ndarray) -> None:
        """Structural checks against a compiled route table."""
        ag = np.asarray(self.acq_group)
        asl = np.asarray(self.acq_slot)
        rs = np.asarray(self.rel_slot)
        if ag.shape != visits.shape or asl.shape != visits.shape \
                or rs.shape != visits.shape:
            raise ValueError(
                f"MshrSpec arrays {ag.shape} do not match visits "
                f"{visits.shape}")
        if ((ag >= 0) != (asl >= 0)).any():
            raise ValueError("acq_group and acq_slot must mark the same "
                             "positions")
        if (ag >= self.n_groups).any() or (asl >= self.max_held).any() \
                or (rs >= self.max_held).any():
            raise ValueError("MshrSpec group/slot index out of range")
        if (ag[:, 0] >= 0).any():
            raise ValueError("a branch cannot acquire at its first visit "
                             "(requests start at a think station)")
        for b in range(ag.shape[0]):
            acquired = {int(s) for s in asl[b] if s >= 0}
            released = {int(s) for s in rs[b] if s >= 0}
            if acquired != released:
                raise ValueError(
                    f"branch {b}: acquired slots {sorted(acquired)} != "
                    f"released slots {sorted(released)} — a leaked leader "
                    f"entry would deadlock the closed loop")
            for s in acquired:
                a_pos = int(np.nonzero(asl[b] == s)[0][0])
                r_pos = int(np.nonzero(rs[b] == s)[0][0])
                if r_pos < a_pos:
                    raise ValueError(
                        f"branch {b}: slot {s} released at position "
                        f"{r_pos} before its acquire at {a_pos}")


def stack_specs(specs: Sequence[SimSpec]) -> SimSpec:
    """Stack specs along a leading lane axis, padded to the largest station
    (K), branch (B) and route (Lr) counts.

    Padding changes no lane's trajectory: padded stations are never
    visited; padded routes end at their first ``-1`` as before; padded
    branches carry a cumulative law of 2.0, above every uniform, and a
    copy of the lane's last real route, so a draw above the lane's last
    cumulative value picks branch ``B_lane`` and reads that copy, as the
    unpadded clamped gather ``visits[min(b, B_lane - 1)]`` reads its last
    row.  Specs of one shape are stacked unchanged.
    """
    mpl = specs[0].mpl
    if any(s.mpl != mpl for s in specs):
        raise ValueError("stacked specs must share one mpl")
    n_k = max(s.svc_ns.shape[0] for s in specs)
    n_b = max(s.visits.shape[0] for s in specs)
    n_r = max(s.visits.shape[1] for s in specs)

    def pad(s: SimSpec) -> list[torch.Tensor]:
        dk = n_k - s.svc_ns.shape[0]
        b, r = s.visits.shape

        def more(a: torch.Tensor, value, rows: int) -> torch.Tensor:
            return torch.cat([a, torch.full((rows, *a.shape[1:]), value,
                                            dtype=a.dtype, device=a.device)])

        visits = torch.cat([s.visits, torch.full(
            (b, n_r - r), -1, dtype=s.visits.dtype, device=s.visits.device)],
            dim=1)
        visits = torch.cat([visits, visits[-1:].expand(n_b - b, n_r)])
        return [more(s.is_queue, False, dk), more(s.svc_ns, 1.0, dk),
                more(s.dist_id, 0, dk), more(s.dist_params, 1.0, dk),
                more(s.branch_cum, 2.0, n_b - b), visits,
                more(s.servers, 1, dk), more(s.disk_rank, -1, dk)]

    padded = [pad(s) for s in specs]
    return SimSpec(*[torch.stack(col) for col in zip(*padded)], mpl=mpl)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Closed-loop summary: mean throughput and CI95 across seeds, and
    with coalescing the delayed-hit fraction and the per-branch rates (the
    reference's fields, in its order)."""

    p_hit: np.ndarray
    throughput: np.ndarray  # requests/µs == M req/s
    ci95: np.ndarray  # 95% CI half-width across seeds
    n_requests: int
    # fraction of measured completions that were delayed hits (coalesced
    # onto an in-flight fetch); zeros unless coalesce_flows > 0.
    delayed_frac: np.ndarray | None = None
    # per-branch completion rates (requests/µs), (P, B) in the order of
    # ``net.branches``; ``branch_delayed`` is the delayed-hit subset of the
    # same completions.  Filled when coalesce_flows > 0, else None.
    branch_throughput: np.ndarray | None = None
    branch_delayed: np.ndarray | None = None
    # tiered (MshrSpec) runs only: delayed-hit completions split by the
    # held-slot level the job parked at, (P, max_held) fractions of
    # measured completions.  None otherwise.
    delayed_tier_frac: np.ndarray | None = None
    # decoded per-lane trace records ([seed][p]
    # repro_torch.obs.trace.TraceRecords); None unless the run asked for
    # tracing (simulate_network(trace=K)).
    traces: list | None = None
    # decoded per-lane streaming estimators ([seed][p]
    # repro_torch.obs.streaming.SketchEstimates), None unless
    # simulate_network(sketch_cap=K) requested them.
    sketches: list | None = None
