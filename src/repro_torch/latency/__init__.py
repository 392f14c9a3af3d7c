"""repro_torch.latency — the open-loop latency prong.

A copy of ``src/repro/latency/__init__.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

The paper's closed-loop stack answers "how fast can the system go"
(throughput X(p) under a fixed multiprogramming limit).  This package
answers the question users actually feel: "how long does a request take"
— under *open-loop* Poisson arrivals at rate lambda, which is how real
front-ends load a cache.

Three pieces, mirroring the repo's three prongs:

  analytic   -> repro_torch.latency.analytic   (Erlang-C / M/M/c layer over the
                existing Station/Branch networks: R(p, lambda), tails,
                stability boundary lambda_max(p))
  simulation -> repro_torch.core.simulator's ``simulate_network(arrival_rate=...)``
                and the heapq twin ``repro.core.py_sim.simulate_py`` —
                per-request sojourns, including time parked on the MSHR
                outstanding-miss table (delayed hits)
  serving    -> repro_torch.latency.forecast (SLO-aware operating points;
                ``Engine.forecast_slo`` wires it to measured controller
                profiles)
"""

from repro_torch.latency.analytic import (
    OpenAnalysis,
    analyze_open,
    erlang_c,
    lambda_max,
    observed_response,
    response_percentile,
    response_time,
)
from repro_torch.latency.forecast import (
    LatencyForecast,
    max_arrival_for_slo,
    slo_forecast,
)

__all__ = [
    "OpenAnalysis", "analyze_open", "erlang_c", "lambda_max",
    "observed_response", "response_percentile", "response_time",
    "LatencyForecast", "max_arrival_for_slo", "slo_forecast",
]
