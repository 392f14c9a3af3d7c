"""Metric registry and trace-derived station timelines.

Port of ``repro.obs.metrics`` (``src/repro/obs/metrics.py``), copied as
it is: numpy only, reading the port's
:class:`~repro_torch.obs.trace.TraceRecords`.

Two halves:

* :class:`Metrics` — a tiny process-local registry of counters, gauges
  and log-bucketed distribution sketches.  Every metric name must carry
  one of the repo's established unit suffixes (``_us``, ``_rate``,
  ``_count``, …) — enforced here at registration time and statically by
  ``tools/analysis/obs_lint.py``.
* timeline functions — per-station occupancy/utilization step functions
  and busy-period (convoy) statistics computed from decoded
  :class:`~repro_torch.obs.trace.TraceRecords`.  These give the first direct
  measurement of the convoy regime: a fill-synchronized convoy is
  a long busy period with high mean occupancy at the disk station.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.obs.trace import TraceRecords

#: Allowed metric-name unit suffixes.  Time units match tools/analysis/
#: units_lint.py; the dimensionless tails make intent explicit.
UNIT_SUFFIXES = (
    "_ns",
    "_us",
    "_ms",
    "_s",
    "_rate",
    "_count",
    "_frac",
    "_ratio",
    "_bytes",
)


def check_metric_name(name: str) -> str:
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(
            f"metric name {name!r} lacks a unit suffix; expected one of "
            f"{UNIT_SUFFIXES}"
        )
    return name


@dataclasses.dataclass
class DistSketch:
    """Log-bucketed distribution sketch (count/sum/min/max + histogram)."""

    lo: float = 1e-3
    hi: float = 1e7
    bins: int = 64

    def __post_init__(self) -> None:
        self.counts = np.zeros(self.bins + 2, dtype=np.int64)
        self.n_count = 0
        self.total = 0.0
        self.min_v = math.inf
        self.max_v = -math.inf
        self._log_lo = math.log(self.lo)
        self._log_hi = math.log(self.hi)

    def _bucket(self, x: float) -> int:
        if x < self.lo:
            return 0
        if x >= self.hi:
            return self.bins + 1
        frac = (math.log(x) - self._log_lo) / (self._log_hi - self._log_lo)
        return 1 + min(self.bins - 1, int(frac * self.bins))

    def add(self, x: float) -> None:
        x = float(x)
        self.counts[self._bucket(x)] += 1
        self.n_count += 1
        self.total += x
        self.min_v = min(self.min_v, x)
        self.max_v = max(self.max_v, x)

    def extend(self, xs) -> None:
        for x in np.asarray(xs).ravel():
            self.add(x)

    @property
    def mean(self) -> float:
        return self.total / self.n_count if self.n_count else math.nan

    def quantile(self, q: float) -> float:
        """Bucket-upper-edge quantile estimate (exact for min/max ends)."""
        if self.n_count == 0:
            return math.nan
        if q <= 0.0:
            return self.min_v
        if q >= 1.0:
            return self.max_v
        target = q * self.n_count
        seen = 0
        for b, c in enumerate(self.counts):
            seen += int(c)
            if seen >= target:
                if b == 0:
                    return self.lo
                if b == self.bins + 1:
                    return self.max_v
                frac = b / self.bins
                return math.exp(
                    self._log_lo + frac * (self._log_hi - self._log_lo)
                )
        return self.max_v

    def snapshot(self) -> dict:
        return {
            "count": int(self.n_count),
            "sum": float(self.total),
            "min": float(self.min_v) if self.n_count else None,
            "max": float(self.max_v) if self.n_count else None,
            "mean": float(self.mean) if self.n_count else None,
            "p50": float(self.quantile(0.5)) if self.n_count else None,
            "p99": float(self.quantile(0.99)) if self.n_count else None,
        }


class Metrics:
    """Process-local registry of unit-suffixed counters/gauges/sketches."""

    def __init__(self) -> None:
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._dists: dict[str, DistSketch] = {}

    def count(self, name: str, inc: float = 1) -> None:
        check_metric_name(name)
        self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        check_metric_name(name)
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        check_metric_name(name)
        if name not in self._dists:
            self._dists[name] = DistSketch()
        self._dists[name].add(value)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "dists": {k: d.snapshot() for k, d in self._dists.items()},
        }


# ---------------------------------------------------------------------------
# Trace-derived timelines
# ---------------------------------------------------------------------------


def visit_intervals(trace: TraceRecords):
    """Flatten a trace into (station, t_enter_us, t_leave_us) interval arrays.

    Only real visits (col < nvis, station >= 0) are kept.  The MSHR
    parked tail of a delayed hit is part of its park visit's interval.
    """
    mask = ~np.isnan(trace.enter_us) & ~np.isnan(trace.leave_us)
    mask &= trace.station >= 0 if trace.station.size else mask
    station = trace.station[mask]
    t_enter_us = trace.enter_us[mask]
    t_leave_us = trace.leave_us[mask]
    return station, t_enter_us, t_leave_us


def occupancy_timeline(trace: TraceRecords, station: int):
    """Step-function occupancy at one station: (times_us, occupancy_count).

    ``occupancy_count[i]`` holds on ``[times_us[i], times_us[i+1])``.
    Counts jobs present (queued + in service + parked) at the station.
    """
    st, enter_us, leave_us = visit_intervals(trace)
    sel = st == station
    edges = np.concatenate([enter_us[sel], leave_us[sel]])
    deltas = np.concatenate(
        [np.ones(sel.sum(), dtype=np.int64), -np.ones(sel.sum(), dtype=np.int64)]
    )
    order = np.argsort(edges, kind="stable")
    times_us = edges[order]
    occupancy_count = np.cumsum(deltas[order])
    return times_us, occupancy_count


def station_utilization(trace: TraceRecords, n_stations: int) -> dict:
    """Per-station busy-time fraction and time-averaged occupancy.

    Measured over the trace's own span ``[min enter, max leave]``.
    Returns ``{station: {"busy_frac", "mean_occupancy_count", "span_us"}}``.
    """
    st, enter_us, leave_us = visit_intervals(trace)
    if enter_us.size == 0:
        return {}
    t0 = float(enter_us.min())
    t1 = float(leave_us.max())
    span_us = max(t1 - t0, 1e-9)
    out = {}
    for k in range(n_stations):
        times_us, occ = occupancy_timeline(trace, k)
        if times_us.size == 0:
            continue
        widths = np.diff(times_us)
        occ_steps = occ[:-1]
        busy_us = float(widths[occ_steps > 0].sum())
        occ_time = float((widths * occ_steps).sum())
        out[k] = {
            "busy_frac": busy_us / span_us,
            "mean_occupancy_count": occ_time / span_us,
            "span_us": span_us,
        }
    return out


def busy_periods(trace: TraceRecords, station: int) -> np.ndarray:
    """Durations (µs) of maximal occupancy>0 intervals at one station."""
    times_us, occ = occupancy_timeline(trace, station)
    if times_us.size == 0:
        return np.zeros(0)
    periods = []
    start = None
    for i in range(len(times_us)):
        if occ[i] > 0 and start is None:
            start = times_us[i]
        elif occ[i] == 0 and start is not None:
            periods.append(times_us[i] - start)
            start = None
    if start is not None:
        periods.append(times_us[-1] - start)
    return np.asarray(periods)


def convoy_stats(trace: TraceRecords, station: int) -> dict:
    """Busy-period (convoy) summary at one station.

    A fill-synchronized convoy shows up as a small number of long
    busy periods that together cover most of the span.
    """
    periods_us = busy_periods(trace, station)
    if periods_us.size == 0:
        return {
            "n_count": 0,
            "mean_us": math.nan,
            "max_us": math.nan,
            "total_us": 0.0,
        }
    return {
        "n_count": int(periods_us.size),
        "mean_us": float(periods_us.mean()),
        "max_us": float(periods_us.max()),
        "total_us": float(periods_us.sum()),
    }


def trace_summary(trace: TraceRecords, n_stations: int | None = None) -> dict:
    """One-call rollup used by benches: classes, sojourns, utilization."""
    out: dict = {
        "records_count": len(trace),
        "emitted_count": trace.n_emitted,
        "dropped_count": trace.n_dropped,
        "classes_count": trace.class_counts(),
    }
    if len(trace):
        soj = trace.sojourn_us
        out["sojourn_mean_us"] = float(soj.mean())
        out["sojourn_max_us"] = float(soj.max())
        out["parked_mean_us"] = float(trace.parked_us.mean())
    if n_stations:
        out["stations"] = {
            str(k): v for k, v in station_utilization(trace, n_stations).items()
        }
    return out
