"""Algorithm 1 of the paper: Adaptive-Search, in PyTorch.

Counterpart of ``repro.core.adaptive.adaptive_search``: a batched UCB /
successive-elimination best-arm search.  Two sampling modes, chosen by
the batch source:

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

Cache-seeded searches (BanditPAM++ and the paper's App 2.2 warm block),
permutation sampling over a FIXED permutation shared by every search:

* ``free_rounds`` / ``free_lo``: rounds in ``[free_lo, free_rounds)``
  are served from the caller's distance cache; their evaluations go to
  ``n_evals_cached`` instead of ``n_evals`` (at the same
  ``count_fn·b`` rate);
* ``init_sums`` / ``init_sqsums`` / ``init_rounds``: per-arm Σg / Σg²
  carried over the permutation's first ``init_rounds`` rounds by an
  earlier search (and repaired by the caller, ``banditpam._carry_delta``)
  seed this one, which resumes at round ``init_rounds`` with
  ``n_used`` = Σ ``perm_w`` over that prefix and σ from the carried
  moments;
* ``aux``: the caller's state (the fit's ``FitContext``, holding the PIC
  ring), handed to ``stats_fn`` with the round index; being host state,
  the ring is updated in place.

``SearchResult`` returns the final ``sums`` / ``sqsums`` for the next
search's carry.  ``n_evals`` and ``n_evals_cached`` are tallied in int64
on the device.  The JAX package keeps them in uint32, which wraps past
2**32 evaluations in one search at large n (a SWAP fallback alone adds
up to ``n·n``, a cache-served search up to ``n·n`` cached reads, at
n = 60,000); the port's do not.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

# Per-arm sub-Gaussianity floor: keeps CIs finite for degenerate arms whose
# first-batch returns are constant (e.g. duplicated points).
SIGMA_FLOOR = 1e-8

# Deterministic tie-break of the differenced (leader) kill: the margin must
# clear this fraction of the arm's RAW confidence width, so that last-bit
# differences between stats backends cannot decide kills.
LEAD_TIE_REL = 1e-2

StatsFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
CountFn = Callable[[torch.Tensor], torch.Tensor]
DrawFn = Callable[[int], torch.Tensor]
ExactFn = Callable[[], torch.Tensor]


class SearchResult(NamedTuple):
    best: int            # index into the (flattened) arm set
    n_evals: int         # fresh algorithmic distance evaluations
    rounds: int          # bandit rounds executed (absolute, incl. carried)
    n_survivors: int     # surviving arms at loop exit
    used_exact: bool     # the survivors were resolved by exact_fn
    n_evals_cached: int = 0                 # evaluations served by a cache
    sums: Optional[torch.Tensor] = None     # [arms] final Σg (prefix)
    sqsums: Optional[torch.Tensor] = None   # [arms] final Σg² (prefix)


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
                    stop_when_positive: bool = False,
                    free_rounds: int = 0, free_lo: int = 0,
                    init_sums: Optional[torch.Tensor] = None,
                    init_sqsums: Optional[torch.Tensor] = None,
                    init_rounds: int = 0, aux: Any = None) -> SearchResult:
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
    candidates).  With ``aux`` given, ``stats_fn`` is called as
    ``stats_fn(ref_idx, w, lead, rnd, aux)``, ``rnd`` the round index.
    The cache seeds (``free_*``, ``init_*``) are in the module docstring.
    """
    if (perm is None) == (draw is None):
        raise ValueError("give exactly one of perm (permutation sampling) "
                         "and draw (replacement sampling)")
    if draw is not None and exact_fn is None:
        raise ValueError("replacement sampling needs exact_fn for the "
                         "exact fallback")
    if baseline not in ("none", "leader"):
        raise ValueError(f"unknown baseline mode {baseline!r}")
    if (init_sums is None) != (init_sqsums is None):
        raise ValueError("init_sums and init_sqsums must be given together")
    if init_sums is not None and perm is None:
        raise ValueError("carried statistics require permutation sampling "
                         "over a fixed perm")
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
    n_evals = torch.zeros((), **i64)
    n_cached = torch.zeros((), **i64)
    lead = None                       # host int once the pilot round ran
    if use_lead:
        arms = torch.arange(n_arms, device=dev)
        d_sums = torch.zeros((n_arms,), **f32)
        sigma_d = torch.full((n_arms,), float("inf"), **f32)
        n_post = 0
    rounds = int(init_rounds) if init_sums is not None else 0
    # Σ perm_w over the carried prefix, for the cyclic tiling.
    n_used = min(rounds * B, n_ref)
    reads = [torch.sum(active, dtype=torch.int64)]
    if init_sums is None:
        sums = torch.zeros((n_arms,), **f32)
        sqsums = torch.zeros((n_arms,), **f32)
        sigma = torch.full((n_arms,), float("inf"), **f32)
    else:
        # σ from the carried moments (every arm has n_used samples).
        sums, sqsums = init_sums, init_sqsums
        n0_f = scalar(max(n_used, 1))
        mu0 = sums / n0_f
        sigma = torch.sqrt(torch.clamp_min(sqsums / n0_f - mu0 * mu0,
                                           0.0)) + SIGMA_FLOOR
        if stop_when_positive:
            reads.append(_may_improve(sums, sigma, active, log_term,
                                           scalar(max(n_used, 1))))
    vals = torch.stack(reads).tolist()
    n_active = vals[0]
    go = bool(vals[1]) if len(vals) > 1 else True    # early-stop verdict
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
        if aux is None:
            sums_b, sq_b, cross_b = stats_fn(ref_idx, w, lead)
        else:
            sums_b, sq_b, cross_b = stats_fn(ref_idx, w, lead, rounds, aux)

        # ---- raw statistics (paper) ----
        sums = sums + sums_b
        sqsums = sqsums + sq_b
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

        cost = count_fn(active) * b_eff
        if free_lo <= rounds < free_rounds:
            n_cached = n_cached + cost
        else:
            n_evals = n_evals + cost
        active = active & ~kill
        n_used = n_new
        rounds += 1
        # The round's one device read: survivors, pilot leader, verdict.
        reads.insert(0, torch.sum(active, dtype=torch.int64))
        if stop_when_positive:
            reads.append(_may_improve(sums, sigma, active, log_term,
                                           scalar(max(n_used, 1))))
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
    best_h, n_evals_h, n_cached_h = torch.stack(
        [best, n_evals, n_cached]).tolist()
    return SearchResult(best=int(best_h), n_evals=int(n_evals_h),
                        rounds=rounds, n_survivors=n_active,
                        used_exact=used_exact,
                        n_evals_cached=int(n_cached_h), sums=sums,
                        sqsums=sqsums)


def _may_improve(sums, sigma, active, log_term, n_used_f):
    """The early stop's verdict as an int64 0-d tensor: 1 while some
    surviving arm's lower bound ``mu − σ·sqrt(log(1/δ)/n_used)`` is not
    positive (the search goes on), 0 once none can be an improving
    swap."""
    lcb = sums / n_used_f - sigma * torch.sqrt(log_term / n_used_f)
    lcb_min = torch.min(torch.where(active, lcb, float("inf")))
    return (lcb_min <= 0.0).to(torch.int64)
