"""tracecheck fixture: TRC005 float32 round trip in float64 host
accounting."""

import numpy as np


class LeakyDriftMonitor:
    def __init__(self):
        self.sum = np.float64(0.0)

    def update(self, dmin):
        d = np.asarray(dmin, np.float64)
        # TRC005: silently rounds the float64 accumulator to float32.
        self.sum = np.float32(self.sum + d.sum())
        return self.sum
