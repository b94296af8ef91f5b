"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit; a card set below it runs slower, so
every result prints the card's limit beside it), and the least time a
piece of work can take on it (``chip_smoke.py``'s ``bound_ms``)."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The larger of the work's operations and its bytes over their
    peaks, in seconds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def distance_work_s(fresh_evals: float, cached_evals: float, d: int
                    ) -> float:
    """The least time of a fit's needed distance work: each fresh
    evaluation 2·d float32 operations, each cached one a float32 read."""
    return (bound_s(fresh_evals * 2.0 * d, 0.0)
            + bound_s(0.0, cached_evals * 4.0))
