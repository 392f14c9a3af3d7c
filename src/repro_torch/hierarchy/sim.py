"""Simulating tiered hierarchies — the port of ``repro.hierarchy.sim``.

* :func:`simulate_hierarchy` — the composed hierarchy network over the
  (global-p × seed) grid as ONE launch of the event-sim kernel on the card
  (its plain version on the CPU): with ``coalesce_flows > 0`` the tiered
  instantiation (``kTiers``: cross-tier leader tables, cascading fills;
  ``simulate_network(tiers=...)``), with 0 the counting instantiation
  (``kCount``: the plain closed loop with per-branch counts).  Per-branch
  completion counts fold back into per-level (L1-hit / L2-hit / origin)
  throughput shares and per-tier delayed-hit fractions.
* :func:`simulate_hierarchy_py` — the heapq oracle twin at one global p
  (:func:`repro_torch.core.py_sim.simulate_py` with ``tiers``), folded
  the same way.

The reference runs the tiered loop on its threefry engine and the port
on its counter engine, so the two agree statistically.  ``sketch_cap > 0``
runs the streaming estimators on both twins (the sketched instantiation of
the kernel; the oracle's exact twin), and ``trace > 0`` keeps
per-request records on both (the traced tiered instantiation: the jobs a
cascade wakes are delayed records).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.py_sim import simulate_py
from repro_torch.core.simulator import simulate_network
from repro_torch.hierarchy.model import HierarchyModel
from repro_torch.kernels.event_sim import simulate_grid

__all__ = ["HierarchySimResult", "simulate_hierarchy",
           "simulate_hierarchy_py"]

@dataclasses.dataclass(frozen=True)
class HierarchySimResult:
    """Tier-folded view of a hierarchy simulation.

    ``level_throughput`` columns are [served at L1, served at L2,
    served at origin] — delayed hits count where their *fill* came from
    (the branch they parked on).  ``delayed_l1_frac`` is the fraction of
    completions that coalesced at a client-local L1 table,
    ``delayed_l2_frac`` at a shard-local origin table.
    """

    p_hit: np.ndarray  # (P,) global L1 hit-ratio knob
    throughput: np.ndarray  # (P,) requests/µs
    ci95: np.ndarray  # (P,)
    level_throughput: np.ndarray  # (P, 3) requests/µs per serving level
    shard_throughput: np.ndarray  # (P, N) L1-miss stream per L2 shard
    delayed_frac: np.ndarray  # (P,)
    delayed_l1_frac: np.ndarray  # (P,) parked at the client's L1 table
    delayed_l2_frac: np.ndarray  # (P,) parked at a shard origin table
    n_requests: int
    # per-request trace records when the run asked for tracing
    # (``trace=K``): [seed][p] TraceRecords from the simulator, a single
    # TraceRecords from the heapq oracle.  None otherwise.
    traces: object = None
    # streaming-estimator decodes when the run asked for them
    # (``sketch_cap=K``): [seed][p] SketchEstimates from the simulator, a
    # single SketchEstimates from the heapq oracle.  None otherwise.
    sketches: object = None


def _fold(model: HierarchyModel, p_hit, x, ci, bx, delayed, tier_dl,
          n_requests: int, traces=None, sketches=None) -> HierarchySimResult:
    level = np.asarray(model.branch_level)
    shard = np.asarray(model.branch_shard)
    P = len(p_hit)
    lvl_x = np.zeros((P, 3))
    for lv in range(3):
        lvl_x[:, lv] = bx[:, level == lv].sum(axis=1)
    sh_x = np.zeros((P, model.n_shards))
    for k in range(model.n_shards):
        sh_x[:, k] = bx[:, shard == k].sum(axis=1)
    if tier_dl is None:
        tier_dl = np.zeros((P, 2))
    return HierarchySimResult(
        p_hit=np.asarray(p_hit), throughput=np.asarray(x),
        ci95=np.asarray(ci), level_throughput=lvl_x, shard_throughput=sh_x,
        delayed_frac=np.asarray(delayed),
        delayed_l1_frac=tier_dl[:, 0], delayed_l2_frac=tier_dl[:, 1],
        n_requests=n_requests, traces=traces, sketches=sketches,
    )


def simulate_hierarchy(model: HierarchyModel, p_hits,
                       n_requests: int = 40_000, seeds=(0, 1, 2),
                       warmup_frac: float = 0.25,
                       coalesce_flows: int = 0,
                       coalesce_theta: float = 0.0,
                       trace: int = 0,
                       sketch_cap: int = 0,
                       window_us: float = 0.0,
                       device: str = "cuda") -> HierarchySimResult:
    """Simulate the composed hierarchy over a grid of global hit ratios.

    ``coalesce_flows`` sizes every MSHR table's hot-flow group (per
    client at L1, per shard at the origin) and runs the tiered kernel;
    0 runs the plain closed loop (the counting kernel, which takes the
    per-branch counts the fold reads) as the no-coalescing reference.
    ``trace=K`` keeps the last K per-request trace records per (seed, p)
    lane on the result's ``traces`` — the branch id
    in each record resolves a request to its client / shard / serving
    level through ``model.branch_client`` & friends.  ``sketch_cap=K``
    threads the streaming estimators (:mod:`repro_torch.obs.streaming`,
    sampled every ``window_us`` simulated µs) and decodes them onto
    ``sketches``.  Wraps
    :func:`repro_torch.core.simulator.simulate_network`.
    """
    if sketch_cap and window_us <= 0.0:
        raise ValueError("sketch_cap > 0 requires window_us > 0 (the "
                         "tumbling-window width in simulated µs)")
    if coalesce_flows:
        res = simulate_network(
            model.network, p_hits, n_requests=n_requests, seeds=seeds,
            warmup_frac=warmup_frac, coalesce_flows=coalesce_flows,
            coalesce_theta=coalesce_theta, tiers=model.mshr, trace=trace,
            sketch_cap=sketch_cap, window_us=window_us, device=device)
    else:
        # simulate_network leaves the per-branch rates None without
        # coalescing; the counting instantiation takes them
        res = simulate_grid(model.network, p_hits, n_requests=n_requests,
                            seeds=seeds, warmup_frac=warmup_frac,
                            trace=trace, count_branches=True,
                            sketch_cap=sketch_cap, window_us=window_us,
                            device=device)
    return _fold(model, res.p_hit, res.throughput, res.ci95,
                 res.branch_throughput, res.delayed_frac,
                 res.delayed_tier_frac, n_requests, traces=res.traces,
                 sketches=res.sketches)


def simulate_hierarchy_py(model: HierarchyModel, p_hit: float,
                          n_requests: int = 20_000, seed: int = 0,
                          warmup_frac: float = 0.25,
                          coalesce_flows: int = 0,
                          coalesce_theta: float = 0.0,
                          trace: int = 0,
                          sketch_cap: int = 0,
                          window_us: float = 0.0) -> HierarchySimResult:
    """Heapq-oracle twin of :func:`simulate_hierarchy` at one global p
    (on the host)."""
    out = simulate_py(
        model.network, float(p_hit), n_requests=n_requests, seed=seed,
        warmup_frac=warmup_frac, coalesce_flows=coalesce_flows,
        coalesce_theta=coalesce_theta, full=True,
        tiers=model.mshr if coalesce_flows else None,
        trace=trace, sketch_cap=sketch_cap, window_us=window_us,
    )
    bx = (np.asarray(out["branch_done"], np.float64)
          / out["t_measured"])[None, :]
    tier_dl = out.get("delayed_tier_frac")
    tier_dl = (np.asarray(tier_dl)[None, :] if tier_dl is not None
               else None)
    return _fold(model, np.array([float(p_hit)]),
                 np.array([out["x"]]), np.array([0.0]), bx,
                 np.array([out["delayed_frac"]]), tier_dl, n_requests,
                 traces=out.get("trace"), sketches=out.get("sketch"))
