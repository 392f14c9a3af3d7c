"""Event-driven simulation of the closed queueing networks — prong B
(port of ``repro.core.simulator.simulate_network``).

This slice runs the **closed loop without coalescing**: exactly ``mpl``
jobs, think stations infinite-server, queue stations c-server FCFS, a
completed request re-entering at once with a fresh branch, optionally
traced (``trace=K``: per-request records, :mod:`repro_torch.obs`).  The whole
(p_hit x seed) grid is one launch of the event-sim kernel
(:mod:`repro_torch.kernels.event_sim`) on the card, or its plain version
on the CPU.  Its counter-based RNG is the one of the reference's
``backend="pallas"`` engine, so the two agree statistically with the
reference's threefry engine and exactly with its pallas engine on
deterministic service.
"""

from __future__ import annotations

from repro_torch.core.queueing import ClosedNetwork
from repro_torch.core.simspec import (BIG_SEQ, INF_NS, SimResult, SimSpec,
                                      compile_network, stack_specs)
from repro_torch.kernels.event_sim import simulate_grid

__all__ = ["BIG_SEQ", "INF_NS", "SimResult", "SimSpec", "compile_network",
           "stack_specs", "simulate_network"]

# Options of the reference that this slice of the port does not carry yet,
# each with the ROADMAP item that ports it.
_LATER = {
    "coalesce_flows": "ROADMAP queue 1, item 6.2 (MSHR coalescing)",
    "arrival_rate": "ROADMAP queue 1, item 6.3 (open loop)",
    "burst": "ROADMAP queue 1, item 6.3 (open loop, ON-OFF bursts)",
    "tiers": "ROADMAP queue 1, item 6.4 (tiered MSHR tables)",
    "sketch_cap": "ROADMAP queue 1, item 8 (streaming sketches)",
}


def simulate_network(
    net: ClosedNetwork,
    p_hits,
    n_requests: int = 40_000,
    seeds=(0, 1, 2),
    warmup_frac: float = 0.25,
    coalesce_flows: int = 0,
    arrival_rate=None,
    burst=None,
    tiers=None,
    trace: int = 0,
    sketch_cap: int = 0,
    device: str = "cuda",
) -> SimResult:
    """Simulate ``net`` over a grid of hit ratios (closed loop).

    The full (p_hit x seed) grid runs as ONE launch: the per-p_hit specs
    are tiled across seeds so every (p, seed) cell is an independent lane
    (lane seed ``seed*1000 + p_index``), each lane stops after
    ``n_requests`` completions (or ``n_requests * (Lr + 2) * 3`` events),
    and throughput is measured after the first ``warmup_frac`` of them.
    Returns the mean throughput (requests/µs) and its CI95 half-width
    across seeds.  ``trace=K`` keeps the last K per-request trace records
    of every lane (the traced kernel) and decodes them onto the result's
    ``traces``, ``[seed][p]``; the statistics are the untraced run's bit
    for bit.

    ``coalesce_flows``, ``arrival_rate``, ``burst``, ``tiers`` and
    ``sketch_cap`` belong to later slices of the port and raise
    :class:`NotImplementedError` naming their ROADMAP item.
    """
    later = {"coalesce_flows": coalesce_flows, "arrival_rate": arrival_rate,
             "burst": burst, "tiers": tiers, "sketch_cap": sketch_cap}
    for name, value in later.items():
        if value is None or (isinstance(value, (int, float)) and value == 0):
            continue
        raise NotImplementedError(
            f"simulate_network({name}=...) is not ported yet: "
            f"{_LATER[name]}")
    return simulate_grid(net, p_hits, n_requests=n_requests, seeds=seeds,
                         warmup_frac=warmup_frac, trace=trace, device=device)
