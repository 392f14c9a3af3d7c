"""Tiered cache hierarchies (L1 clients → sharded L2 → origin).

The port of ``repro.hierarchy``: composition and analytics live in
:mod:`repro_torch.hierarchy.model` (numpy, equal to the reference's); the
tiered simulator twins in :mod:`repro_torch.hierarchy.sim` (the event-sim
kernel's tiered instantiation on the card, and the heapq oracle).
"""

from repro_torch.hierarchy.model import (
    HierarchyModel,
    TierSpec,
    TieredProfile,
    che_hit,
    coalesced_hierarchy,
    compose_tiers,
    hierarchy_network,
    measured_tiered_profile,
    tier_sigma_of,
    tiered_profile,
)

__all__ = [
    "HierarchyModel", "TierSpec", "TieredProfile", "che_hit",
    "coalesced_hierarchy", "compose_tiers", "hierarchy_network",
    "measured_tiered_profile", "tier_sigma_of", "tiered_profile",
    "HierarchySimResult", "simulate_hierarchy", "simulate_hierarchy_py",
]


def __getattr__(name):
    if name in ("HierarchySimResult", "simulate_hierarchy",
                "simulate_hierarchy_py"):
        from repro_torch.hierarchy import sim

        return getattr(sim, name)
    raise AttributeError(name)
