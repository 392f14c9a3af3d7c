"""Observability for the port: per-request trace records, per-station
timelines and Perfetto export, the streaming estimators, the drift
detectors and provenance stamps (port of ``repro.obs``' ``trace``,
``metrics``, ``export``, ``streaming``, ``drift``, ``profile``,
``residuals`` and ``provenance`` modules).

Tracing is off by default.  ``simulate_network(..., trace=K)`` keeps the
last ``K`` per-request records of every lane in ring buffers filled by the
traced event-sim kernel (or its plain version on the CPU), and decodes
them to :class:`TraceRecords`, in every simulator mode; tracing draws no
random numbers, so a traced run's statistics are the untraced run's bit
for bit.  The
streaming estimators (``simulate_network(..., sketch_cap=K)``,
:func:`sketch_trace`) are off by default as well, and draw no random
numbers either.

:mod:`repro_torch.obs.profile` and :mod:`repro_torch.obs.residuals` sit
above the cluster / hierarchy / latency layers and are imported directly,
not re-exported here, as in the reference.
"""

from __future__ import annotations

from repro_torch.obs.drift import (Cusum, PageHinkley, cusum_scan,
                                   page_hinkley_scan)
from repro_torch.obs.metrics import DistSketch, Metrics
from repro_torch.obs.provenance import (config_hash, lineage_diff, stamp,
                                        validate_payload)
from repro_torch.obs.streaming import (PyStreamSketch, SketchEstimates,
                                       sketch_trace, sketch_trace_py)
from repro_torch.obs.trace import TraceRecords, make_records, trace_from_rings

__all__ = [
    "Cusum",
    "DistSketch",
    "Metrics",
    "PageHinkley",
    "PyStreamSketch",
    "SketchEstimates",
    "TraceRecords",
    "config_hash",
    "cusum_scan",
    "lineage_diff",
    "make_records",
    "page_hinkley_scan",
    "sketch_trace",
    "sketch_trace_py",
    "stamp",
    "trace_from_rings",
    "validate_payload",
]
