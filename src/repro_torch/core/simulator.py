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
# Each is refused when it differs from the reference's default (second).
_LATER = {
    "coalesce_flows": ("ROADMAP queue 1, item 6.2 (MSHR coalescing)", 0),
    "coalesce_theta": ("ROADMAP queue 1, item 6.2 (Zipf-weighted hot-key "
                       "flows)", 0.0),
    "arrival_rate": ("ROADMAP queue 1, item 6.3 (open loop)", None),
    "max_in_system": ("ROADMAP queue 1, item 6.3 (open loop job slots)", 128),
    "burst": ("ROADMAP queue 1, item 6.3 (open loop, ON-OFF bursts)", None),
    "tiers": ("ROADMAP queue 1, item 6.4 (tiered MSHR tables)", None),
    "sketch_cap": ("ROADMAP queue 1, item 8 (streaming sketches)", 0),
    "window_us": ("ROADMAP queue 1, item 8 (streaming sketch windows)", 0.0),
}


def simulate_network(
    net: ClosedNetwork,
    p_hits,
    n_requests: int = 40_000,
    seeds=(0, 1, 2),
    warmup_frac: float = 0.25,
    coalesce_flows: int = 0,
    coalesce_theta: float = 0.0,
    arrival_rate=None,
    max_in_system: int = 128,
    burst=None,
    backend: str = "pallas",
    tiers=None,
    trace: int = 0,
    sketch_cap: int = 0,
    window_us: float = 0.0,
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

    The keywords are the reference's.  ``backend`` names the engine: the
    port has one, the reference's counter-RNG ``"pallas"`` engine, so that
    is its default and ``"jax"`` (the reference's threefry engine) raises
    :class:`ValueError`.  ``coalesce_flows``, ``coalesce_theta``,
    ``arrival_rate``, ``max_in_system``, ``burst``, ``tiers``,
    ``sketch_cap`` and ``window_us`` belong to later slices of the port:
    away from their defaults they raise :class:`NotImplementedError`
    naming their ROADMAP item.
    """
    if backend not in ("jax", "pallas"):
        raise ValueError(f"unknown backend {backend!r} (want 'jax' or "
                         "'pallas')")
    if backend == "jax":
        raise ValueError("backend='jax' is the reference's threefry engine, "
                         "which the port does not have: its one engine is "
                         "the counter-RNG engine of backend='pallas'")
    given = {"coalesce_flows": coalesce_flows,
             "coalesce_theta": coalesce_theta, "arrival_rate": arrival_rate,
             "max_in_system": max_in_system, "burst": burst, "tiers": tiers,
             "sketch_cap": sketch_cap, "window_us": window_us}
    for name, value in given.items():
        item, default = _LATER[name]
        if value is default or (default is not None and value == default):
            continue
        raise NotImplementedError(
            f"simulate_network({name}=...) is not ported yet: {item}")
    return simulate_grid(net, p_hits, n_requests=n_requests, seeds=seeds,
                         warmup_frac=warmup_frac, trace=trace, device=device)
