"""Algorithm 1 of the paper: Adaptive-Search, permutation sampling.

Counterpart of ``repro.core.adaptive.adaptive_search`` for its default
mode (``sampling="permutation"``, ``baseline="none"``, no cache): a
batched UCB / successive-elimination best-arm search whose batches are
consecutive slices of one random permutation of the reference set
(paper Appendix 2.2).  Carried over exactly:

* the cyclic tiling of the permutation to ``ceil(n/B)·B`` slots, with
  weight 0 on the slots past ``n`` (``perm_w``);
* σ from the first batch (Eq. 11) plus ``SIGMA_FLOOR``;
* the finite-population factor ``sqrt(max(1 − n_used/n, 0))``;
* the kill rule ``lcb > min(ucb)`` over the active arms;
* the evaluation count ``count_fn(active_before_round) · b_eff``;
* the final pick: the FIRST index minimising the running mean over the
  survivors (at full budget the running mean is the exact mean).

Every arm quantity stays in float32 on the data's device, and every
division is tensor by tensor, so the card's and the CPU's arithmetic is
the JAX package's.  The loop runs on the host with one device read per
round: the survivor count that decides whether to go on.  The batch
weights, and hence ``n_used``, are known on the host from the tiling.

``n_evals`` is tallied in int64 on the device.  The JAX package keeps it
in uint32, which would wrap past 2**32 evaluations in one search at
large n; the port's does not.  Replacement sampling, the leader baseline
and cache-seeded searches are ROADMAP A7/A9.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

# Per-arm sub-Gaussianity floor: keeps CIs finite for degenerate arms whose
# first-batch returns are constant (e.g. duplicated points).
SIGMA_FLOOR = 1e-8

StatsFn = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
CountFn = Callable[[torch.Tensor], torch.Tensor]


class SearchResult(NamedTuple):
    best: int            # index into the (flattened) arm set
    n_evals: int         # fresh algorithmic distance evaluations
    rounds: int          # bandit rounds executed
    n_survivors: int     # surviving arms at loop exit


def log_term_f32(delta: float, device) -> torch.Tensor:
    """``log(1/δ)`` as the JAX package folds it: the reciprocal in
    float64, then the cast and the log in float32."""
    return torch.log(torch.tensor(1.0 / delta, dtype=torch.float32)).to(device)


def default_count(active: torch.Tensor) -> torch.Tensor:
    return torch.sum(active, dtype=torch.int64)


def tile_perm(perm: torch.Tensor, n_ref: int, batch_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cyclic layout: ``perm`` tiled to ``ceil(n/B)·B`` slots, and
    the {0,1} weights that zero the slots past ``n_ref``."""
    total = -(-n_ref // batch_size) * batch_size
    reps = -(-total // n_ref)
    perm_idx = perm.repeat(reps)[:total]
    perm_w = (torch.arange(total, device=perm.device) < n_ref).to(
        torch.float32)
    return perm_idx, perm_w


def adaptive_search(*, stats_fn: StatsFn, perm: torch.Tensor, n_arms: int,
                    n_ref: int, batch_size: int, log_term: torch.Tensor,
                    active_init: torch.Tensor,
                    count_fn: CountFn = default_count) -> SearchResult:
    """Run one best-arm identification (one BUILD assignment or one SWAP
    pick) over the reference permutation ``perm`` ([n_ref] int64).

    ``stats_fn(ref_idx[B], w[B]) -> (sums, sqsums, cross)`` returns the
    per-arm weighted batch sums of g and g² (cross is unused here).
    ``count_fn`` gives the distance evaluations per reference point as a
    function of the survivor mask (BUILD: #active arms; SWAP: #distinct
    active candidates).
    """
    dev = active_init.device
    B = int(batch_size)
    perm_idx, perm_w = tile_perm(perm, n_ref, B)
    f32 = dict(dtype=torch.float32, device=dev)

    def scalar(v: float) -> torch.Tensor:
        return torch.full((), float(v), **f32)   # on-device fill, no copy

    n_eff_f = scalar(n_ref)
    active = active_init.clone()
    sums = torch.zeros((n_arms,), **f32)
    sigma = torch.full((n_arms,), float("inf"), **f32)
    n_evals = torch.zeros((), dtype=torch.int64, device=dev)
    n_used = 0
    rounds = 0
    n_active = int(torch.sum(active).item())
    while n_used < n_ref and n_active > 1:
        lo = rounds * B
        ref_idx = perm_idx[lo:lo + B]
        w = perm_w[lo:lo + B]
        b_eff = min(B, n_ref - lo)
        sums_b, sq_b, _ = stats_fn(ref_idx, w)

        sums = sums + sums_b
        n_new = n_used + b_eff
        n_new_f = scalar(n_new)
        b_eff_f = scalar(b_eff)
        mu_hat = sums / n_new_f
        if n_used == 0:                                           # Eq. 11
            batch_mean = sums_b / b_eff_f
            batch_var = torch.clamp_min(
                sq_b / b_eff_f - batch_mean * batch_mean, 0.0)
            sigma = torch.sqrt(batch_var) + SIGMA_FLOOR
        fpc = torch.sqrt(torch.clamp_min(1.0 - n_new_f / n_eff_f, 0.0))
        ci = sigma * torch.sqrt(log_term / n_new_f) * fpc
        ucb = torch.where(active, mu_hat + ci, float("inf"))
        lcb = mu_hat - ci
        kill = lcb > torch.min(ucb)

        n_evals = n_evals + count_fn(active) * b_eff
        active = torch.logical_and(active, torch.logical_not(kill))
        n_used = n_new
        rounds += 1
        n_active = int(torch.sum(active).item())   # the round's one sync

    mu_final = sums / scalar(max(n_used, 1))
    mu_sel = torch.where(active, mu_final, float("inf"))
    best = torch.argmin(mu_sel)
    best_h, n_evals_h = torch.stack([best, n_evals]).tolist()
    return SearchResult(best=int(best_h), n_evals=int(n_evals_h),
                        rounds=rounds, n_survivors=n_active)
