"""Out-of-sample inference against fitted medoids (counterpart of
``repro.api.predict``).

* :func:`medoid_distances` — the ``[m, k]`` block through the backend's
  pairwise path (the ``pairwise`` kernel on the card), chunked over the
  query axis so the resident block stays ``chunk × k``.
* :func:`assign_medoids` — labels and nearest distances in one top-2
  pass (the ``top2`` kernel on the card); no ``[m, k]`` block.

Queries arrive as numpy or tensors and are moved to the device once.
PyTorch runs eagerly, so there is nothing to retrace and no row padding;
the serving layer (``repro_torch.serve``) answers each request eagerly
through :func:`assign_medoids`, one upload, one ``top2`` launch and one
read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.engine import (get_stats_backend, host_stage,
                           resolve_stats_backend)

DEFAULT_CHUNK = 8192


def resolve_backend(backend: Optional[str], metric: str,
                    device: torch.device) -> str:
    """A predict ``backend`` as a registered stats-backend name; unknown
    names raise ``ValueError`` as in the JAX package."""
    try:
        return resolve_stats_backend(backend, metric, device)
    except KeyError as e:
        raise ValueError(f"unknown predict backend {backend!r}; "
                         f"{e.args[0] if e.args else e}") from None


def _queries(x, device: torch.device) -> torch.Tensor:
    with host_stage("the queries"):
        q = torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
    if q.ndim != 2:
        raise ValueError(f"expected 2-D queries, got shape {tuple(q.shape)}")
    return q


def _medoid_points(points, device: torch.device) -> torch.Tensor:
    with host_stage("the medoid points"):
        return torch.as_tensor(points, dtype=torch.float32).to(
            device).contiguous()


def medoid_distances_t(x, medoid_points: torch.Tensor, metric: str, *,
                       backend: Optional[str] = None,
                       chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """``[m, d]`` queries × ``[k, d]`` medoid rows → ``[m, k]`` float32,
    a tensor on the medoid rows' device."""
    dev = medoid_points.device
    be = get_stats_backend(resolve_backend(backend, metric, dev))
    q = _queries(x, dev)
    chunk = max(1, int(chunk))
    out = torch.empty((q.shape[0], medoid_points.shape[0]),
                      dtype=torch.float32, device=dev)
    for lo in range(0, q.shape[0], chunk):
        out[lo:lo + chunk] = be.pairwise(q[lo:lo + chunk], medoid_points,
                                         metric=metric)
    return out


def medoid_distances(x, medoid_points, metric: str, *,
                     backend: Optional[str] = None,
                     chunk: int = DEFAULT_CHUNK,
                     device: DeviceLike = None) -> np.ndarray:
    """``[m, d]`` queries × ``[k, d]`` fitted medoids → ``[m, k]`` numpy
    float32.  ``device=None`` means the card."""
    med = _medoid_points(medoid_points, resolve_device(device))
    return medoid_distances_t(x, med, metric, backend=backend,
                              chunk=chunk).cpu().numpy()


def assign_medoids(x, medoid_points, metric: str, *,
                   backend: Optional[str] = None,
                   device: DeviceLike = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``[m, d]`` queries → ``(labels [m] int32, dmin [m] float32)`` in
    one top-2 pass and one read; ties go to the lowest medoid index."""
    dev = resolve_device(device)
    med = _medoid_points(medoid_points, dev)
    be = get_stats_backend(resolve_backend(backend, metric, dev))
    q = _queries(x, dev)
    if q.shape[0] == 0:
        return np.empty((0,), np.int32), np.empty((0,), np.float32)
    d1, _, labels = be.top2(q, med, metric=metric)
    # One copy of both, as int32 words (a bitwise copy of dmin).
    host = torch.stack([labels.to(torch.int32),
                        d1.view(torch.int32)]).cpu().numpy()
    return host[0], host[1].view(np.float32)
