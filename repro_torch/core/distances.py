"""Distance registry for k-medoids, in PyTorch.

Counterpart of ``repro.core.distances``.  Every function maps a target
block ``x: [m, d]`` and a reference block ``y: [r, d]`` to ``[m, r]``
float32 dissimilarities, with the JAX package's formulas and clamps:

* ``l2sq`` is ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)`` (one matrix product plus
  rank-1 norm terms), ``l2`` its square root;
* ``cosine`` is ``1 − x̂·ŷᵀ`` with ``x̂ = x · rsqrt(max(‖x‖², 1e-30))``;
* ``l1`` is the abs-sum, evaluated in reference chunks so the
  ``[m, chunk, d]`` intermediate stays under ``2**24`` elements.

These are the plain versions of the ``pairwise`` kernel and the metric
half of the ``"torch"`` stats backend.  On a CUDA tensor they run with
TF32 switched off, so the products stay in full float32.

``"precomputed"`` and callable metrics are not ported yet (ROADMAP A2).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Metric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Metric] = {}

# Keep the [m, chunk, d] L1 intermediate under ~2**24 elements.
_L1_CHUNK_ELEMS = 1 << 24


def full_fp32(t: torch.Tensor) -> None:
    """Switch TF32 off before a float32 product on the card: TF32 keeps
    about three decimal digits, below what the bandit's accept rule and
    elimination margins resolve."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def register_metric(name: str, fn: Metric) -> None:
    _REGISTRY[name] = fn


def get_metric(name: str) -> Metric:
    if name not in _REGISTRY:
        raise KeyError(f"unknown metric {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_metrics():
    return sorted(_REGISTRY)


def l2sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance via ||x||^2 + ||y||^2 - 2 x.y."""
    full_fp32(x)
    xx = torch.sum(x * x, dim=-1)[:, None]
    yy = torch.sum(y * y, dim=-1)[None, :]
    xy = x @ y.T
    return torch.clamp_min(xx + yy - 2.0 * xy, 0.0)


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(l2sq(x, y))


def cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine *distance* 1 - cos_sim, safe at zero vectors."""
    full_fp32(x)
    xn = x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, -1, keepdim=True),
                                         1e-30))
    yn = y * torch.rsqrt(torch.clamp_min(torch.sum(y * y, -1, keepdim=True),
                                         1e-30))
    return 1.0 - xn @ yn.T


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Manhattan distance, chunked over references to bound memory."""
    m, d = x.shape
    r = y.shape[0]
    chunk = max(1, min(r, _L1_CHUNK_ELEMS // max(1, m * d)))
    out = torch.empty((m, r), dtype=torch.float32, device=x.device)
    for lo in range(0, r, chunk):
        yc = y[lo:lo + chunk]
        out[:, lo:lo + chunk] = torch.sum(
            torch.abs(x[:, None, :] - yc[None, :, :]), dim=-1)
    return out


def resolve_metric(metric) -> str:
    """Normalise a user-facing ``metric`` argument to a registered name.
    ``"precomputed"`` and raw callables are later work (ROADMAP A2)."""
    if isinstance(metric, str):
        if metric == "precomputed":
            raise NotImplementedError(
                'metric="precomputed" is not ported yet (ROADMAP A2)')
        get_metric(metric)  # raises KeyError for unknown names
        return metric
    if callable(metric):
        raise NotImplementedError(
            "callable metrics are not ported yet (ROADMAP A2)")
    raise TypeError(f"metric must be a registered name; "
                    f"got {type(metric).__name__}")


register_metric("l2", l2)
register_metric("l2sq", l2sq)
register_metric("l1", l1)
register_metric("cosine", cosine)


def pairwise(x: torch.Tensor, y: torch.Tensor, *, metric: str = "l2"
             ) -> torch.Tensor:
    """Pairwise dissimilarity ``[m, d] x [r, d] -> [m, r]``."""
    return get_metric(metric)(x, y)
