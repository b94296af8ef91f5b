"""Assignment-loss drift monitor for the serving layer (the port's copy
of ``repro.serve.drift``; numpy only).

The fitted medoids imply a baseline: the mean nearest-medoid distance
``mu0`` over the data they were fitted on (``FitReport.loss / n``).  As
the stream distribution moves, the mean assignment loss of ingested
points rises above that baseline; once enough evidence accumulates the
monitor trips and the service refits.

Drift rule:

    trip  iff  count >= window  and  sum/count > (1 + threshold) * mu0

``window`` guards against tripping on a handful of outliers right after a
refit; ``threshold`` is the relative loss excursion the service
tolerates.  All accounting is exact host-side float64 over the float32
per-point distances the assignment pass already produced, and
bit-identical between a live service and one restored mid-stream (the
counters ride the checkpoint as float64 / int64 numpy leaves).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DriftMonitor"]


class DriftMonitor:
    """Windowed mean-loss drift detector.

    Args:
      threshold: relative excursion over baseline that trips a refit
        (0.25 = mean ingest loss 25% above the fitted mean).
      window: minimum ingested points before the monitor may trip.
    """

    def __init__(self, threshold: float = 0.25, window: int = 256):
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.baseline = np.float64(np.inf)   # mu0; inf = never trips
        self.sum = np.float64(0.0)
        self.count = np.int64(0)

    def reset(self, baseline: float) -> None:
        """Re-arm after a (re)fit with the new mean per-point loss."""
        self.baseline = np.float64(baseline)
        self.sum = np.float64(0.0)
        self.count = np.int64(0)

    def update(self, dmin: np.ndarray) -> None:
        """Fold a chunk of nearest-medoid distances into the window."""
        d = np.asarray(dmin, np.float64).ravel()
        self.sum = np.float64(self.sum + d.sum())
        self.count = np.int64(self.count + d.shape[0])

    @property
    def mean(self) -> float:
        return float(self.sum / self.count) if self.count else 0.0

    @property
    def drifted(self) -> bool:
        if self.count < self.window or not np.isfinite(self.baseline):
            return False
        return bool(self.sum / self.count
                    > (1.0 + self.threshold) * self.baseline)

    # -- checkpoint state ------------------------------------------------
    def state(self) -> dict:
        """float64 / int64 numpy leaves: an exact round trip through
        ``repro_torch.runtime.checkpoint``."""
        return {"baseline": np.float64(self.baseline),
                "sum": np.float64(self.sum),
                "count": np.int64(self.count)}

    def load_state(self, state: dict) -> None:
        self.baseline = np.float64(state["baseline"])
        self.sum = np.float64(state["sum"])
        self.count = np.int64(state["count"])
