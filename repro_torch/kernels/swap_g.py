"""Fused SWAP (FastPAM1) arm statistics for all k medoid-arms at once.

Replaces the TPU kernel ``src/repro/kernels/swap_g.py:85``
(``swap_g_kernel``, tile math ``swap_stats_vals`` at ``:40``) with the
CUDA kernel ``csrc/swap_g.cu``.  Its bound on the H100 is build_g's: the
distance work, compute-bound at the main path's shapes.  The TPU
kernel's one-hot ``[B, K]`` matrix product becomes a binned add into
per-thread shared-memory bins chosen by each reference point's cluster:
the same function with k times less work, no atomics, and the
``[k, m]`` engine layout written directly.  The bins cap k at
``k_max()`` (64); larger k raises (ROADMAP: lift the swap_g k cap).

``swap_g_torch`` is the plain version (the engine's one-hot form).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..core.distances import pairwise
from ..core.engine import _swap_batch_stats
from . import build as _build
from .pairwise import METRIC_IDS

launches = 0


def k_max() -> int:
    """Largest k the kernel's shared-memory bins hold."""
    return int(_build.lib().rt_swap_g_k_max())


def swap_g_torch(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g,
                 metric: str):
    """Plain version: ``(Σg, Σg², Σg·g_lead)``, each ``[k, m]``."""
    return _swap_batch_stats(pairwise(x, y, metric=metric), d1_b, d2_b,
                             assign_b, w, k, lead_g)


def launch(x, y, d1_b, d2_b, assign_b, w, k: int, lead_g, metric: str):
    """Run the CUDA kernel on validated CUDA tensors (see ``ops``)."""
    global launches
    if k > k_max():
        raise ValueError(f"swap_g kernel holds at most k={k_max()} medoid "
                         f"bins in shared memory, got k={k} (ROADMAP: lift "
                         f"the swap_g k cap)")
    m, d = x.shape
    b = y.shape[0]
    sums, sq, cross = (torch.empty((k, m), dtype=torch.float32,
                                   device=x.device) for _ in range(3))
    code = _build.lib().rt_swap_g(
        x.data_ptr(), y.data_ptr(), d1_b.data_ptr(), d2_b.data_ptr(),
        assign_b.data_ptr(), w.data_ptr(), lead_g.data_ptr(),
        sums.data_ptr(), sq.data_ptr(), cross.data_ptr(), m, b, d, k,
        METRIC_IDS[metric], torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    _build.check(code, "swap_g kernel")
    return sums, sq, cross
