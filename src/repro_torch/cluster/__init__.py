"""repro_torch.cluster — the sharded cache-cluster prong (fourth subsystem).

The port of ``repro.cluster``.  Lifts all three single-node prongs to an
N-shard hash-routed cluster:

* routing     -> repro_torch.cluster.hashing  (consistent-hash ring,
                 two-choice maps, trace partitioning, measured imbalance)
* theory      -> repro_torch.cluster.model    (per-shard station sets
                 composed into one ClosedNetwork; shard profiles p -> p_k;
                 cluster bounds, MVA, lambda_max, R(p, lambda))
* simulation  -> repro_torch.cluster.sim      (one event-sim launch with
                 shard-local MSHR tables + a key-routing heapq oracle)

The headline: under Zipf skew the hot shard's hit-path metadata
saturates while the cluster-average hit ratio still looks safe, so the
cluster-level throughput-optimal p* sits strictly below the single-node
forecast for LRU-like policies; FIFO-like policies stay monotone.
"""

from repro_torch.cluster.hashing import (
    HashRing,
    imbalance,
    partition_trace,
    shard_weights,
    two_choice_assignment,
)
from repro_torch.cluster.model import (
    ClusterModel,
    ShardProfile,
    cluster_network,
    compose_cluster,
    ideal_shard_profile,
    measured_shard_profile,
    uniform_profile,
    zipf_key_probs,
)
from repro_torch.cluster.sim import (
    ClusterSimResult,
    simulate_cluster,
    simulate_cluster_py,
)

__all__ = [
    "HashRing", "imbalance", "partition_trace", "shard_weights",
    "two_choice_assignment",
    "ClusterModel", "ShardProfile", "cluster_network", "compose_cluster",
    "ideal_shard_profile", "measured_shard_profile", "uniform_profile",
    "zipf_key_probs",
    "ClusterSimResult", "simulate_cluster", "simulate_cluster_py",
]
