"""Observability for the port: per-request trace records, per-station
timelines and Perfetto export (port of ``repro.obs``' ``trace``,
``metrics`` and ``export`` modules).

Tracing is off by default.  ``simulate_network(..., trace=K)`` keeps the
last ``K`` per-request records of every lane in ring buffers filled by the
traced event-sim kernel (or its plain version on the CPU), and decodes
them to :class:`TraceRecords`; tracing draws no random numbers, so a
traced run's statistics are the untraced run's bit for bit.
"""

from __future__ import annotations

from repro_torch.obs.metrics import DistSketch, Metrics
from repro_torch.obs.trace import TraceRecords, make_records, trace_from_rings

__all__ = [
    "DistSketch",
    "Metrics",
    "TraceRecords",
    "make_records",
    "trace_from_rings",
]
