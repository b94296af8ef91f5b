"""Plain oracles for every kernel of the port (counterpart of
``repro.kernels.ref``).  They share no code with the kernels or their
plain versions and mirror the math directly.

Difference from the JAX oracles: ``cosine`` normalises with the kernel
tile's clamp, ``x · rsqrt(max(‖x‖², 1e-30))`` (``dist_tile``), not
``ref.py``'s ``x / max(‖x‖, 1e-15)``; the two agree except at vectors of
norm below 1e-15.
"""

from __future__ import annotations

import torch


def pairwise_ref(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """[m, d] x [r, d] -> [m, r] dissimilarity."""
    if metric == "l2sq":
        return torch.clamp_min(
            torch.sum(x * x, -1)[:, None] + torch.sum(y * y, -1)[None, :]
            - 2.0 * x @ y.T, 0.0)
    if metric == "l2":
        return torch.sqrt(pairwise_ref(x, y, "l2sq"))
    if metric == "cosine":
        xn = x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, -1), 1e-30))[:, None]
        yn = y * torch.rsqrt(torch.clamp_min(torch.sum(y * y, -1), 1e-30))[:, None]
        return 1.0 - xn @ yn.T
    if metric == "l1":
        return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    raise ValueError(metric)


def build_g_ref(x, y, dnear_b, w, metric: str):
    """Fused BUILD statistics oracle: (sums[m], sqsums[m]) of
    g = (d − dnear) ∧ 0 (or d itself where dnear = +inf), weighted."""
    dxy = pairwise_ref(x, y, metric)
    dn = dnear_b[None, :]
    g = torch.where(torch.isinf(dn), dxy, torch.clamp_max(dxy - dn, 0.0))
    g = g * w[None, :]
    return torch.sum(g, -1), torch.sum(g * g, -1)


def swap_g_ref(x, y, d1_b, d2_b, assign_b, w, k: int, metric: str):
    """Fused SWAP (Eq. 12) statistics oracle via the dense [k, m, B]
    tensor: (sums[k, m], sqsums[k, m])."""
    dxy = pairwise_ref(x, y, metric)                         # [m, B]
    in_cm = (assign_b.long()[None, :]
             == torch.arange(k, device=dxy.device)[:, None])       # [k, B]
    g = torch.where(in_cm[:, None, :],
                    -d1_b[None, None, :] + torch.minimum(d2_b[None, None, :],
                                                         dxy[None]),
                    -d1_b[None, None, :] + torch.minimum(d1_b[None, None, :],
                                                         dxy[None]))
    g = g * w[None, None, :]
    return torch.sum(g, -1), torch.sum(g * g, -1)


def top2_ref(x, med, metric: str):
    """(d1, d2, assign) by a full sort of each row: d2 is the second
    sorted value, so duplicate medoid rows give d2 == d1."""
    dxy = pairwise_ref(x, med, metric)
    vals, _ = torch.sort(dxy, dim=1)
    d2 = vals[:, 1] if dxy.shape[1] > 1 else torch.full_like(vals[:, 0],
                                                            float("inf"))
    first = (dxy == vals[:, :1]).float().argmax(dim=1)  # first min index
    return vals[:, 0], d2, first.to(torch.int32)
