"""tracecheck fixture: float64-disciplined host accounting (TRC005
negative)."""

import numpy as np


class Monitor:
    def __init__(self):
        self.sum = np.float64(0.0)
        self.count = np.int64(0)

    def update(self, dmin):
        d = np.asarray(dmin, np.float64).ravel()
        self.sum = np.float64(self.sum + d.sum(dtype=np.float64))
        self.count = np.int64(self.count + d.shape[0])
        return self.sum / np.float64(max(int(self.count), 1))
