"""Score-drift monitoring for the serving runtime.

An anomaly-detection service has a monitoring problem the reference
never faces (its inference is an offline predict loop, reference
tools.py:310-390): in production the input distribution moves — new
lighting, a camera swap, a process change — and a k-NN scorer
calibrated on last month's "good" images silently mis-thresholds.  The
standard MLOps answer is to compare the LIVE score stream against the
score distribution seen at calibration time.

Pieces:

* `quantile_summary(scores)` — compress calibration scores to a small
  quantile grid.  Computed once at export (`serving/export.py` bakes it
  into the artifact header as ``meta["calibration"]``), so the serving
  host needs no access to calibration data.
* `ks_statistic(scores, summary)` — a Kolmogorov–Smirnov statistic
  evaluated on the quantile grid: ``max_i |F_recent(v_i) - p_i|`` where
  ``F_recent`` is the empirical CDF of the recent scores.  0 = the live
  stream matches calibration; 1 = total separation.
* `ks_alert_level(n_recent, n_calibration)` — the α=0.05 two-sample KS
  critical value ``1.358·sqrt(1/n + 1/m)``; drift above it is unlikely
  (<5%) to be sampling noise.
* `ScoreTracker` — bounded online tracker the HTTP server keeps per
  model: recent-window percentiles + the drift statistic, surfaced via
  ``GET /stats``.

Interpretation note: the baseline is the distribution of scores on
*good* (defect-free) calibration data, so a sustained burst of true
anomalies ALSO raises the statistic.  That is intentional — "many
anomalies" and "the input moved" both warrant an operator's attention;
the heatmaps/labels disambiguate them.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np

#: default quantile grid: dense in the tails, where threshold-relevant
#: movement shows first
DEFAULT_PROBS = (
    0.0, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0,
)

#: α = 0.05 two-sample Kolmogorov–Smirnov coefficient
_KS_COEFF_95 = 1.358


def quantile_summary(
    scores: Sequence[float], probs: Sequence[float] = DEFAULT_PROBS
) -> dict:
    """Calibration scores → a JSON-serializable quantile grid.

    ``{"probs": [...], "values": [...], "n": N}`` — the artifact-header
    representation (serving/export.py bakes it as
    ``meta["calibration"]``)."""
    arr = np.asarray(scores, dtype=np.float64).ravel()
    if arr.size == 0:
        raise ValueError("cannot summarize an empty score set")
    probs = [float(p) for p in probs]
    values = np.quantile(arr, probs)
    return {
        "probs": probs,
        "values": [float(v) for v in values],
        "n": int(arr.size),
    }


def ks_statistic(scores: Sequence[float], summary: dict) -> float:
    """KS distance between the empirical CDF of `scores` and the
    calibration distribution, evaluated at the baked quantile grid.

    The grid evaluation bounds the true two-sample statistic from below
    but is exact at the grid points — with the tail-dense DEFAULT_PROBS
    that is where calibration-relevant movement appears."""
    arr = np.sort(np.asarray(scores, dtype=np.float64).ravel())
    if arr.size == 0:
        raise ValueError("cannot compute drift over zero scores")
    probs = np.asarray(summary["probs"], dtype=np.float64)
    values = np.asarray(summary["values"], dtype=np.float64)
    # F_recent(v) = #(scores <= v) / n via one vectorized searchsorted
    cdf = np.searchsorted(arr, values, side="right") / arr.size
    return float(np.max(np.abs(cdf - probs)))


def ks_alert_level(n_recent: int, n_calibration: int) -> float:
    """α=0.05 critical value for the two-sample KS statistic: drift
    above this is statistically unlikely to be sampling noise."""
    if n_recent <= 0 or n_calibration <= 0:
        raise ValueError("sample counts must be positive")
    return _KS_COEFF_95 * float(np.sqrt(1.0 / n_recent + 1.0 / n_calibration))


class ScoreTracker:
    """Bounded online tracker of a model's primary score stream.

    The HTTP server observes one scalar per successful request — the
    anomaly score in image mode, the anomaly-map max in patch mode
    (the same quantity the baked calibration summarizes) — and reports
    recent-window statistics plus the drift KS against the baseline.

    `min_scores` gates the drift report: a KS over a handful of
    requests is noise, not signal."""

    def __init__(
        self,
        baseline: Optional[dict] = None,
        window: int = 512,
        min_scores: int = 32,
    ):
        self.baseline = baseline
        self.min_scores = int(min_scores)
        self._scores: deque = deque(maxlen=int(window))
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, score: float) -> None:
        with self._lock:
            self._scores.append(float(score))
            self._total += 1

    def stats(self) -> dict:
        """JSON-ready summary; drift fields are None until `min_scores`
        observations exist (and absent a baseline, stay None)."""
        with self._lock:
            scores = list(self._scores)
            total = self._total
        out: dict = {
            "observed_total": total,
            "recent_n": len(scores),
            "recent_mean": float(np.mean(scores)) if scores else None,
            "recent_p50": float(np.quantile(scores, 0.5)) if scores else None,
            "recent_p95": float(np.quantile(scores, 0.95)) if scores else None,
            "drift_ks": None,
            "drift_alert_level": None,
            "drift_alert": None,
        }
        if self.baseline is not None and len(scores) >= self.min_scores:
            ks = ks_statistic(scores, self.baseline)
            level = ks_alert_level(len(scores), int(self.baseline["n"]))
            out["drift_ks"] = round(ks, 6)
            out["drift_alert_level"] = round(level, 6)
            out["drift_alert"] = bool(ks > level)
        return out
