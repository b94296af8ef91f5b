"""Algorithm 1 of the paper: Adaptive-Search, in PyTorch.

Counterpart of ``repro.core.adaptive.adaptive_search`` for a search
without a distance cache: a batched UCB / successive-elimination
best-arm search.  Two sampling modes, chosen by the batch source:

* permutation sampling (``perm=``, paper Appendix 2.2): the batches are
  consecutive slices of one random permutation of the reference set,
  tiled cyclically to ``ceil(n/B)·B`` slots with weight 0 on the slots
  past ``n``; the CI carries the finite-population factor
  ``sqrt(max(1 − n_used/n, 0))``, so at full budget the running mean is
  the exact mean and the survivors resolve without an exact pass;
* replacement sampling (``draw=``, the paper's §3.2 as printed): each
  round's batch is B i.i.d. uniform draws (``draw(rnd)``), every weight
  1, no finite-population factor.  When the budget (n_used ≥ n) runs out
  with more than one survivor, the survivors are resolved exactly by
  ``exact_fn()`` (Algorithm 1, lines 13–15), which costs
  ``count_fn(survivors)·n`` evaluations and sets ``used_exact``.

Carried over exactly from the JAX package: σ from the first batch
(Eq. 11) plus ``SIGMA_FLOOR``; the kill rule ``lcb > min(ucb)`` over the
active arms; the evaluation count ``count_fn(active_before_round) · b``;
the final pick, the FIRST index minimising the mean over the survivors;
and two options beyond the paper:

* ``baseline="leader"``: after the pilot round fixes a leader (the
  argmin of the round-1 means over the arms active in round 1), every
  later round also tracks the differenced statistics ``g_x − g_lead``
  (CI without the finite-population factor) and kills on either rule.
  The differenced kill must clear ``LEAD_TIE_REL`` of the arm's raw
  confidence width, and the leader is never killed by its own
  (structurally zero) differenced margin.  ``stats_fn`` gets the leader
  from round 2 on, ``None`` before.
* ``stop_when_positive`` (SWAP): the search also stops once every
  surviving arm's lower bound ``mu − σ·sqrt(log(1/δ)/n_used)`` (no
  finite-population factor) is positive, since no arm can then be an
  improving swap.

Every arm quantity stays in float32 on the data's device, and every
division is tensor by tensor, so the card's and the CPU's arithmetic is
the JAX package's.  The loop runs on the host with one device read per
round, which carries the survivor count, the early-stop verdict and, in
round 1 of a leader search, the pilot leader.

``n_evals`` is tallied in int64 on the device.  The JAX package keeps it
in uint32, which wraps past 2**32 evaluations in one search at large n
(a SWAP fallback alone adds up to ``n·n`` at n = 60,000); the port's
does not.  Cache-seeded searches are ROADMAP A9.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

# Per-arm sub-Gaussianity floor: keeps CIs finite for degenerate arms whose
# first-batch returns are constant (e.g. duplicated points).
SIGMA_FLOOR = 1e-8

# Deterministic tie-break of the differenced (leader) kill: the margin must
# clear this fraction of the arm's RAW confidence width, so that last-bit
# differences between stats backends cannot decide kills.
LEAD_TIE_REL = 1e-2

StatsFn = Callable[[torch.Tensor, torch.Tensor, Optional[int]],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
CountFn = Callable[[torch.Tensor], torch.Tensor]
DrawFn = Callable[[int], torch.Tensor]
ExactFn = Callable[[], torch.Tensor]


class SearchResult(NamedTuple):
    best: int            # index into the (flattened) arm set
    n_evals: int         # fresh algorithmic distance evaluations
    rounds: int          # bandit rounds executed
    n_survivors: int     # surviving arms at loop exit
    used_exact: bool     # the survivors were resolved by exact_fn


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


def adaptive_search(*, stats_fn: StatsFn, n_arms: int, n_ref: int,
                    batch_size: int, log_term: torch.Tensor,
                    active_init: torch.Tensor,
                    perm: Optional[torch.Tensor] = None,
                    draw: Optional[DrawFn] = None,
                    exact_fn: Optional[ExactFn] = None,
                    count_fn: CountFn = default_count,
                    baseline: str = "none",
                    stop_when_positive: bool = False) -> SearchResult:
    """Run one best-arm identification (one BUILD assignment or one SWAP
    pick).

    Give ``perm`` ([n_ref] int64, permutation sampling) or ``draw``
    (``rnd -> [B]`` int64 indices, replacement sampling, with
    ``exact_fn() -> [n_arms]`` exact means for the fallback).
    ``stats_fn(ref_idx[B], w[B], lead) -> (sums, sqsums, cross)`` returns
    the per-arm weighted batch sums of g, g² and g·g_lead (``lead`` is
    the leader arm, or None when no cross-sum is needed).  ``count_fn``
    gives the distance evaluations per reference point as a function of
    the survivor mask (BUILD: #active arms; SWAP: #distinct active
    candidates).
    """
    if (perm is None) == (draw is None):
        raise ValueError("give exactly one of perm (permutation sampling) "
                         "and draw (replacement sampling)")
    if draw is not None and exact_fn is None:
        raise ValueError("replacement sampling needs exact_fn for the "
                         "exact fallback")
    if baseline not in ("none", "leader"):
        raise ValueError(f"unknown baseline mode {baseline!r}")
    use_perm = perm is not None
    use_lead = baseline == "leader"
    dev = active_init.device
    B = int(batch_size)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)

    def scalar(v: float) -> torch.Tensor:
        return torch.full((), float(v), **f32)   # on-device fill, no copy

    if use_perm:
        perm_idx, perm_w = tile_perm(perm, n_ref, B)
        n_eff_f = scalar(n_ref)
    else:
        ones = torch.ones((B,), **f32)
    active = active_init.clone()
    sums = torch.zeros((n_arms,), **f32)
    sigma = torch.full((n_arms,), float("inf"), **f32)
    n_evals = torch.zeros((), **i64)
    lead = None                       # host int once the pilot round ran
    if use_lead:
        arms = torch.arange(n_arms, device=dev)
        d_sums = torch.zeros((n_arms,), **f32)
        sigma_d = torch.full((n_arms,), float("inf"), **f32)
        n_post = 0
    n_used = 0
    rounds = 0
    n_active = int(torch.sum(active).item())
    go = True                          # the early stop's verdict
    while n_used < n_ref and n_active > 1 and go:
        if use_perm:
            lo = rounds * B
            ref_idx = perm_idx[lo:lo + B]
            w = perm_w[lo:lo + B]
            b_eff = min(B, n_ref - lo)
        else:
            ref_idx = draw(rounds)
            w = ones
            b_eff = B
        sums_b, sq_b, cross_b = stats_fn(ref_idx, w, lead)

        # ---- raw statistics (paper) ----
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
        ci = sigma * torch.sqrt(log_term / n_new_f)
        if use_perm:
            ci = ci * torch.sqrt(torch.clamp_min(1.0 - n_new_f / n_eff_f,
                                                 0.0))
        ucb = torch.where(active, mu_hat + ci, float("inf"))
        lcb = mu_hat - ci
        kill = lcb > torch.min(ucb)

        # ---- differenced statistics vs the pilot leader ----
        reads = []
        if use_lead and lead is None:
            reads.append(torch.argmin(torch.where(active, mu_hat,
                                                  float("inf"))))
        elif use_lead:
            d_b = sums_b - sums_b[lead]
            dsq_b = sq_b - 2.0 * cross_b + sq_b[lead]
            d_sums = d_sums + d_b
            if n_post == 0:
                d_mean = d_b / b_eff_f
                sigma_d = torch.sqrt(torch.clamp_min(
                    dsq_b / b_eff_f - d_mean * d_mean, 0.0)) + SIGMA_FLOOR
            n_post += b_eff
            n_post_f = scalar(n_post)
            mu_d = d_sums / n_post_f
            root = torch.sqrt(log_term / n_post_f)
            ci_d = sigma_d * root
            ucb_d = torch.where(active, mu_d + ci_d, float("inf"))
            eps_d = LEAD_TIE_REL * sigma * root
            kill_d = (mu_d - ci_d) > torch.min(ucb_d) + eps_d
            kill = kill | (kill_d & (arms != lead))

        n_evals = n_evals + count_fn(active) * b_eff
        active = active & ~kill
        n_used = n_new
        rounds += 1
        # The round's one device read: survivors, pilot leader, verdict.
        reads.insert(0, torch.sum(active, dtype=torch.int64))
        if stop_when_positive:
            n_used_f = scalar(max(n_used, 1))
            lcb_es = sums / n_used_f - sigma * torch.sqrt(log_term / n_used_f)
            lcb_min = torch.min(torch.where(active, lcb_es, float("inf")))
            reads.append((lcb_min <= 0.0).to(torch.int64))
        vals = torch.stack(reads).tolist()
        n_active = vals[0]
        if use_lead and lead is None:
            lead = vals[1]
        if stop_when_positive:
            go = bool(vals[-1])

    used_exact = not use_perm and n_active > 1
    if used_exact:
        mu_sel = torch.where(active, exact_fn(), float("inf"))
        n_evals = n_evals + count_fn(active) * n_ref
    else:
        mu_sel = torch.where(active, sums / scalar(max(n_used, 1)),
                             float("inf"))
    best = torch.argmin(mu_sel)
    best_h, n_evals_h = torch.stack([best, n_evals]).tolist()
    return SearchResult(best=int(best_h), n_evals=int(n_evals_h),
                        rounds=rounds, n_survivors=n_active,
                        used_exact=used_exact)
