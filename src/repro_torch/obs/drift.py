"""Drift detectors over the streaming estimator series.

A copy of ``src/repro/obs/drift.py`` (numpy only), kept in the port so that
``repro_torch`` imports nothing of ``repro``.  Change both together.

Two classical sequential change detectors, both self-referencing (the
baseline mean is learned from the first ``warmup`` observations, and
re-learned after every alarm):

* :class:`Cusum` — two-sided cumulative-sum test: ``g+ = max(0, g+ +
  (x - mean) - k_slack)`` (and the mirrored ``g-``), alarm when either
  statistic exceeds ``h_threshold``.  Tuned by the slack ``k_slack``
  (half the shift you want to ignore) and the threshold (trade
  detection lag against false alarms).
* :class:`PageHinkley` — cumulative deviation from the running mean
  with a min/max tracker: alarm when the cumulative sum rises
  ``lam_threshold`` above its running minimum (or, two-sided, falls
  below its running maximum).

Each class is the streaming form (call :meth:`update` per observation);
the ``*_scan`` functions run the identical recurrence over a whole
series and return the alarm indices, with the same keywords.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Cusum", "PageHinkley", "cusum_scan", "page_hinkley_scan"]


class Cusum:
    """Two-sided CUSUM with a self-learned baseline.

    During the first ``warmup`` observations the detector only
    estimates the baseline mean; afterwards each :meth:`update` returns
    True on an alarm, which also resets the statistics and starts a new
    warmup (so repeated alarms mean repeated shifts, not one long one).
    """

    def __init__(self, k_slack: float = 0.005, h_threshold: float = 0.05,
                 warmup: int = 8, two_sided: bool = True):
        if warmup < 1:
            raise ValueError("warmup must be >= 1")
        self.k_slack = float(k_slack)
        self.h_threshold = float(h_threshold)
        self.warmup = int(warmup)
        self.two_sided = bool(two_sided)
        self.reset()

    def reset(self) -> None:
        self.mean = 0.0
        self.n_seen = 0
        self.g_pos = 0.0
        self.g_neg = 0.0
        self.n_alarms = 0

    def update(self, x: float) -> bool:
        x = float(x)
        if not np.isfinite(x):
            return False
        if self.n_seen < self.warmup:
            self.mean += (x - self.mean) / (self.n_seen + 1)
            self.n_seen += 1
            return False
        self.n_seen += 1
        dev = x - self.mean
        self.g_pos = max(0.0, self.g_pos + dev - self.k_slack)
        self.g_neg = max(0.0, self.g_neg - dev - self.k_slack)
        alarm = self.g_pos > self.h_threshold or (
            self.two_sided and self.g_neg > self.h_threshold)
        if alarm:
            n = self.n_alarms + 1
            self.reset()
            self.n_alarms = n
        return alarm

    def scan(self, xs) -> np.ndarray:
        """Alarm indices over a series (the streaming recurrence)."""
        return np.array([i for i, x in enumerate(np.asarray(xs, float))
                         if self.update(x)], np.int64)


class PageHinkley:
    """Page-Hinkley test against the running mean.

    Tracks ``m_t = sum(x_i - mean_i - delta_slack)`` and alarms when
    ``m_t - min(m)`` exceeds ``lam_threshold`` (downward shifts, via
    the mirrored max-tracker, when ``two_sided``).  Alarms reset the
    detector.
    """

    def __init__(self, delta_slack: float = 0.005,
                 lam_threshold: float = 0.05, warmup: int = 8,
                 two_sided: bool = True):
        if warmup < 1:
            raise ValueError("warmup must be >= 1")
        self.delta_slack = float(delta_slack)
        self.lam_threshold = float(lam_threshold)
        self.warmup = int(warmup)
        self.two_sided = bool(two_sided)
        self.reset()

    def reset(self) -> None:
        self.mean = 0.0
        self.n_seen = 0
        # Separate slacked sums per direction: the up test tracks the
        # running minimum of sum(x - mean - delta), the down test the
        # running maximum of sum(x - mean + delta) — sharing one sum
        # would let the slack itself walk the statistic into the
        # opposite-direction threshold on stationary data.
        self.m_up = 0.0
        self.min_up = 0.0
        self.m_dn = 0.0
        self.max_dn = 0.0
        self.n_alarms = 0

    def update(self, x: float) -> bool:
        x = float(x)
        if not np.isfinite(x):
            return False
        self.mean += (x - self.mean) / (self.n_seen + 1)
        self.n_seen += 1
        if self.n_seen <= self.warmup:
            return False
        self.m_up += x - self.mean - self.delta_slack
        self.min_up = min(self.min_up, self.m_up)
        self.m_dn += x - self.mean + self.delta_slack
        self.max_dn = max(self.max_dn, self.m_dn)
        alarm = (self.m_up - self.min_up > self.lam_threshold) or (
            self.two_sided
            and self.max_dn - self.m_dn > self.lam_threshold)
        if alarm:
            n = self.n_alarms + 1
            self.reset()
            self.n_alarms = n
        return alarm

    def scan(self, xs) -> np.ndarray:
        """Alarm indices over a series (the streaming recurrence)."""
        return np.array([i for i, x in enumerate(np.asarray(xs, float))
                         if self.update(x)], np.int64)


def cusum_scan(xs, k_slack: float = 0.005, h_threshold: float = 0.05,
               warmup: int = 8, two_sided: bool = True) -> np.ndarray:
    """Alarm indices of :class:`Cusum` over a whole series."""
    return Cusum(k_slack=k_slack, h_threshold=h_threshold, warmup=warmup,
                 two_sided=two_sided).scan(xs)


def page_hinkley_scan(xs, delta_slack: float = 0.005,
                      lam_threshold: float = 0.05, warmup: int = 8,
                      two_sided: bool = True) -> np.ndarray:
    """Alarm indices of :class:`PageHinkley` over a whole series."""
    return PageHinkley(delta_slack=delta_slack,
                       lam_threshold=lam_threshold, warmup=warmup,
                       two_sided=two_sided).scan(xs)
