"""Live model-vs-measured residual monitoring.

A copy of ``src/repro/obs/residuals.py``, over the port's
:mod:`repro_torch.core.queueing`, :mod:`repro_torch.latency.analytic` and
:mod:`repro_torch.obs.drift`.  Change both together.

The analytic half of the paper (MVA for closed loops, the M/G/c
decomposition behind :func:`repro_torch.latency.analytic.analyze_open` for
open ones) predicts throughput / response time *for a given profile*.
The :class:`ResidualMonitor` closes the loop at runtime: every window
it compares the measured rate (closed X, or open mean sojourn R)
against the forecast at the currently *estimated* operating point, and
feeds drift detectors with the relative residuals.  Structured
:class:`Alarm` records come out in three kinds:

``model-drift``
    The CUSUM over relative forecast residuals tripped: measured
    behaviour has walked away from the analytic model at the estimated
    operating point (service times shifted, a station saturated in a
    way the model misses, burst arrivals against a Poisson model, ...).
``phase-change``
    The Page-Hinkley test over the estimated hit-ratio stream tripped:
    the workload itself changed regime (popularity churn, ON/OFF
    bursts) — re-estimate the profile before trusting any forecast.
``sketch-saturation``
    The SpaceSaving table's error bound crossed ``saturation_limit`` —
    the estimated masses themselves are suspect; widen ``sketch_cap``.

The monitor is plain host-side Python (it consumes decoded
:class:`repro_torch.obs.streaming.SketchEstimates`, not kernel state) and is
surfaced through ``Engine.telemetry()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.queueing import ClosedNetwork
from repro_torch.latency.analytic import analyze_open
from repro_torch.obs.drift import Cusum, PageHinkley

__all__ = ["Alarm", "ResidualMonitor"]


@dataclasses.dataclass(frozen=True)
class Alarm:
    """One structured monitor alarm.

    ``kind`` is one of ``model-drift`` / ``phase-change`` /
    ``sketch-saturation``; ``measured`` / ``expected`` give the pair
    that tripped it (hit ratio for phase changes, X or R for model
    drift, the saturation fraction and its limit for saturation) and
    ``score`` the detector statistic at the alarm."""

    kind: str
    window_id: int
    measured: float
    expected: float
    score: float
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ResidualMonitor:
    """Window-by-window model-vs-measured comparison with drift alarms.

    ``mode="closed"`` forecasts throughput ``X = net.mva_throughput(p)``
    and compares against the measured windowed completion rate;
    ``mode="open"`` forecasts the mean sojourn ``R`` via
    :func:`analyze_open` at the measured windowed arrival rate.  Both
    feed the *relative* residual ``(measured - expected) / expected``
    to a CUSUM; the estimated hit-ratio stream feeds a Page-Hinkley
    test.  Alarms accumulate on :attr:`alarms`.
    """

    def __init__(self, net: ClosedNetwork, mode: str = "closed",
                 tail_mode: str = "nominal",
                 resid_k: float = 0.02, resid_h: float = 0.25,
                 phase_delta: float = 0.005, phase_lam: float = 0.08,
                 warmup: int = 8, saturation_limit: float = 0.05):
        if mode not in ("closed", "open"):
            raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
        self.net = net
        self.mode = mode
        self.tail_mode = tail_mode
        self.saturation_limit = float(saturation_limit)
        self.resid_cusum = Cusum(k_slack=resid_k, h_threshold=resid_h,
                                 warmup=warmup)
        self.phase_ph = PageHinkley(delta_slack=phase_delta,
                                    lam_threshold=phase_lam, warmup=warmup)
        self.alarms: list = []
        self._saturated = False

    def expected(self, p_hat: float, arrival_rate: float | None = None
                 ) -> float:
        """Model forecast at the estimated operating point: closed
        throughput (per µs) or open mean sojourn (µs)."""
        p = float(np.clip(p_hat, 0.0, 0.999))
        if self.mode == "closed":
            return float(self.net.mva_throughput(p))
        if arrival_rate is None or not np.isfinite(arrival_rate):
            return float("nan")
        return float(analyze_open(self.net, p, float(arrival_rate),
                                  tail_mode=self.tail_mode).mean)

    def observe(self, window_id: int, p_hat: float,
                measured: float, arrival_rate: float | None = None,
                saturation_frac: float = 0.0) -> list:
        """Feed one window; returns the alarms it raised (also kept on
        :attr:`alarms`).  ``measured`` is the windowed completion rate
        (closed) or mean sojourn (open)."""
        out = []
        if np.isfinite(p_hat) and self.phase_ph.update(p_hat):
            out.append(Alarm(
                kind="phase-change", window_id=int(window_id),
                measured=float(p_hat), expected=float(self.phase_ph.mean),
                score=float(self.phase_ph.lam_threshold),
                detail="estimated hit ratio changed regime"))
        exp = self.expected(p_hat, arrival_rate)
        if np.isfinite(exp) and exp > 0 and np.isfinite(measured):
            resid = (float(measured) - exp) / exp
            if self.resid_cusum.update(resid):
                out.append(Alarm(
                    kind="model-drift", window_id=int(window_id),
                    measured=float(measured), expected=exp,
                    score=float(resid),
                    detail=f"{self.mode} forecast residual tripped CUSUM"))
        if saturation_frac > self.saturation_limit and not self._saturated:
            self._saturated = True
            out.append(Alarm(
                kind="sketch-saturation", window_id=int(window_id),
                measured=float(saturation_frac),
                expected=self.saturation_limit,
                score=float(saturation_frac),
                detail="SpaceSaving error bound exceeded the limit; "
                       "estimated masses are suspect"))
        elif saturation_frac <= self.saturation_limit:
            self._saturated = False
        self.alarms.extend(out)
        return out

    def run(self, window_ids, p_hats, measured, arrival_rates=None,
            saturation_frac: float = 0.0) -> list:
        """Feed a whole series of windows; returns all alarms raised."""
        window_ids = np.asarray(window_ids)
        p_hats = np.asarray(p_hats, float)
        measured = np.asarray(measured, float)
        if arrival_rates is None:
            arrival_rates = np.full(len(window_ids), np.nan)
        arrival_rates = np.asarray(arrival_rates, float)
        out = []
        for i in range(len(window_ids)):
            out.extend(self.observe(
                int(window_ids[i]), float(p_hats[i]), float(measured[i]),
                arrival_rate=float(arrival_rates[i]),
                saturation_frac=saturation_frac))
        return out
