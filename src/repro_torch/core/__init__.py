"""repro_torch.core — the closed queueing-network models (numpy copies of
the reference), the network -> simulator-spec compiler, the closed- and
open-loop simulator, the prong-C measurement harness and the
LRU-like/FIFO-like classification.

The package exports the names the reference's ``repro.core`` exports:
the models of :mod:`repro_torch.core.queueing` and
:mod:`repro_torch.core.policy_models` and the classification of
:mod:`repro_torch.core.classify`.  The tiered networks' MSHR table
:class:`~repro_torch.core.simspec.MshrSpec` is importable from here too,
outside ``__all__``, which stays the reference's.
"""

from repro_torch.core.queueing import (
    QUEUE,
    THINK,
    Branch,
    ClosedNetwork,
    Station,
    bypass_network,
    coalesced_network,
    exponential_analogue,
    optimal_bypass_beta,
    sigma_of,
    zipf_flow_weights,
)
from repro_torch.core.policy_models import (
    POLICY_BUILDERS,
    build,
    clock_network,
    fifo_network,
    lru_network,
    paper_fifo_bound,
    paper_lru_bound,
    paper_prob_lru_bound,
    prob_lru_network,
    s3fifo_network,
    slru_network,
)
from repro_torch.core.simspec import MshrSpec
from repro_torch.core.classify import (
    FIFO_LIKE,
    LRU_LIKE,
    TABLE1,
    TABLE2_CONJECTURE,
    classify_by_throughput,
    classify_structural,
)

__all__ = [
    "QUEUE", "THINK", "Branch", "ClosedNetwork", "Station",
    "bypass_network", "coalesced_network", "exponential_analogue",
    "optimal_bypass_beta", "sigma_of", "zipf_flow_weights",
    "POLICY_BUILDERS", "build",
    "lru_network", "fifo_network", "prob_lru_network", "clock_network",
    "slru_network", "s3fifo_network",
    "paper_lru_bound", "paper_fifo_bound", "paper_prob_lru_bound",
    "LRU_LIKE", "FIFO_LIKE", "TABLE1", "TABLE2_CONJECTURE",
    "classify_structural", "classify_by_throughput",
]
