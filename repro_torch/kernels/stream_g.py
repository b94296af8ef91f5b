"""Nearest / second-nearest medoid per row (top-2).

Replaces the TPU kernel ``src/repro/kernels/stream_g.py:165``
(``stream_top2_kernel``) with the CUDA kernel ``csrc/stream_g.cu``.  In
the port it carries the SWAP loop's medoid cache and candidate loss and
the fit's labels as well as assignment.  On the H100 it is memory-bound
(n=60000, k=10, d=784: 0.94 GFLOP against 188 MB of x, about 56 us);
the design stages the k medoid rows through shared memory in a narrow
[128, 16] tile and scans each row's columns in index order, so the
first-index tie rule holds and the [n, k] block never reaches device
memory.

``top2_torch`` is the plain version (``engine._top2_block`` over
512-row tiles).  ``launches`` counts kernel launches.  The streaming
BUILD/SWAP kernels of the TPU module (exact fallback) are ROADMAP B7/B8.
"""

from __future__ import annotations

import torch

from ..core.engine import _stream_top2
from . import build as _build
from .pairwise import METRIC_IDS

launches = 0


def top2_torch(x, med, metric: str):
    """Plain version: ``(d1, d2, assign int32)``, ``[n]`` each, one
    ``[512, k]`` block at a time (``engine._stream_top2``)."""
    return _stream_top2(x, med, metric)


def launch(x, med, metric: str):
    """Run the CUDA kernel on validated CUDA tensors (see ``ops``)."""
    global launches
    n, d = x.shape
    k = med.shape[0]
    d1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    d2 = torch.empty_like(d1)
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    code = _build.lib().rt_top2(
        x.data_ptr(), med.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        assign.data_ptr(), n, k, d, METRIC_IDS[metric],
        torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    _build.check(code, "top2 kernel")
    return d1, d2, assign
