"""tracecheck fixture: TRC005 dtype-less conversion in checkpoint restore."""

import numpy as np
import torch


def restore_leaf(arr):
    # TRC005: no dtype; float64 values through a host list come back
    # float32.
    return torch.as_tensor(arr.tolist())


def restore_stat(x):
    # TRC005: astype to float32 breaks the bit-exact round trip.
    return np.asarray(x, np.float64).astype("float32")
