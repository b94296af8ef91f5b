"""Algorithm 1 of the paper: Adaptive-Search, in PyTorch.

Counterpart of ``repro.core.adaptive.adaptive_search``: a batched UCB /
successive-elimination best-arm search.  Two sampling modes, chosen by
the batch source:

* permutation sampling (``layout=``, paper Appendix 2.2): the batches
  are consecutive slices of a :class:`Layout`, reference indices and
  {0,1} weights (the JAX package's ``perm_idx`` / ``perm_w``).  The
  single fit's is :func:`cyclic_layout`, one random permutation of the
  reference set tiled cyclically to ``ceil(n/B)·B`` slots with weight 0
  on the slots past ``n``; the sharded fit's stratified walk
  (:func:`explicit_layout`) has weight-0 padding in early rounds, so a
  round counts its weights (``b_eff = Σw``) and ``n_used`` is their
  running sum.  The CI carries the finite-population factor
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
the JAX package's.

One round is one function (``_Search.round``) that two loops share:

* the stepped loop (``resident=False``) reads the round's verdict back
  after every round (one ``engine.host_read`` of the "still running"
  flag and the survivor count), as the JAX package's ``fused=False``
  driver does;
* the device-resident loop (``resident=True``, the counterpart of the
  JAX package's device-side while loop) enqueues rounds without a read.
  Every state update of a round is masked by a device flag
  ``running = (#survivors > 1) ∧ verdict`` (the tallies add
  ``cost·running``, the kills are ``kill ∧ running``, the moments and
  the leader are selected) and the stats kernels take the flag too, so
  a round enqueued after the stop changes nothing: not the moments, not
  the ledger, not the leader, not the round count.  The host reads
  ``running`` once every ``ROUNDS_PER_READ`` rounds and stops enqueueing
  once it reads 0; the result stays on the device (:class:`DeviceResult`)
  for the caller to read with its own.  The schedule is static, so each
  round's slice (or draw), its effective size and the σ round are host
  ints known when the round is enqueued.  Every sampling mode runs it:
  under replacement sampling a round past the stop takes its batch from
  the search's own draws (``draw(rnd)``, a slice already on the device
  under ``rng.from_seed``), and the exact fallback is decided on the
  device (``used_exact = #survivors > 1``, the JAX package's
  ``lax.cond``): the streaming pass runs with that flag as its run
  flag, ``torch.where`` picks the exact or the sampled means, and the
  fallback's ``count_fn·n`` is charged times the flag.  A caller whose
  state moves with the rounds a search ran (the PIC ring) asks for them
  on the host (``rounds_to_host``): the flag's reads carry the round
  count, and a search that ran to its budget with no read after its
  stop is read once more at its end.

In both loops the leader is a 0-d device index from the pilot round on.

Both loops run the same arithmetic on the same values, so they return
the same result bit for bit.  The caller keeps one source on the
stepped loop: draws from one generator in consumption order
(``rng.from_generator``), where a round enqueued past the stop would use
up draws of the searches after it (``BanditPAM._fit``).

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
  ring), handed to ``stats_fn`` with the round index; the ring is
  updated in place.

The lane axis (``lane_search``, ``fit_batch``): L independent
permutation searches, one per fit of a padded batch, advance one round
at a time in lockstep, each round ONE ``stats_fn`` call for every lane
(one ``build_g`` / ``swap_g`` launch on the card).  It is the
device-resident loop with a leading lane axis: the schedule tables are
``[L, R_max]`` (each lane's own n, δ and budget ``ceil(n_l/B)``), a lane
past its budget is masked exactly like a round past its stop, and the
host reads the ``[L]`` flags once every ``ROUNDS_PER_READ`` rounds and
stops once every lane reads 0.  Every per-lane quantity is the single
search's elementwise arithmetic on the lane's own values (min, argmin
and integer counts are exact over any arm set), and pad arms start
inactive, so each lane returns the single search's result bit for bit.
The PIC batch gives each lane the single search's cache seeds: its own
window of served rounds (``free``) and its own carried start (``r0_l``:
``n_used`` the lane's prefix, σ from its carried moments, its pilot at
``r0_l``, the early stop checked at the start); the lockstep runs from
the smallest start of a live lane, a lane before its own masked as a
lane past its budget is.  The single-fit ``_Search`` is left as it is.

``SearchResult`` (and :class:`DeviceResult`) return the final ``sums``
/ ``sqsums`` for the next search's carry.  ``n_evals`` and
``n_evals_cached`` are tallied in int64 on the device.  The JAX package
keeps them in uint32, which wraps past 2**32 evaluations in one search
at large n (a SWAP fallback alone adds up to ``n·n``, a cache-served
search up to ``n·n`` cached reads, at n = 60,000); the port's do not.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .engine import host_read
from .pic_cache import to_device

# Per-arm sub-Gaussianity floor: keeps CIs finite for degenerate arms whose
# first-batch returns are constant (e.g. duplicated points).
SIGMA_FLOOR = 1e-8

# Deterministic tie-break of the differenced (leader) kill: the margin must
# clear this fraction of the arm's RAW confidence width, so that last-bit
# differences between stats backends cannot decide kills.
LEAD_TIE_REL = 1e-2

# Rounds the device-resident loop enqueues between two reads of its
# "still running" flag.  A masked round costs a launch per kernel, a read
# a round trip to the host.
ROUNDS_PER_READ = 32

StatsFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
CountFn = Callable[[torch.Tensor], torch.Tensor]
DrawFn = Callable[[int], torch.Tensor]
ExactFn = Callable[..., torch.Tensor]


class SearchResult(NamedTuple):
    best: int            # index into the (flattened) arm set
    n_evals: int         # fresh algorithmic distance evaluations
    rounds: int          # bandit rounds executed (absolute, incl. carried)
    n_survivors: int     # surviving arms at loop exit
    used_exact: bool     # the survivors were resolved by exact_fn
    n_evals_cached: int = 0                 # evaluations served by a cache
    sums: Optional[torch.Tensor] = None     # [arms] final Σg (prefix)
    sqsums: Optional[torch.Tensor] = None   # [arms] final Σg² (prefix)


class DeviceResult(NamedTuple):
    """A search's result as it stands on the device: 0-d int64 tensors,
    and ``used_exact``, a host bool or (a replacement search of the
    device-resident loop) a 0-d device bool.  ``rounds_h`` is ``rounds``
    on the host where the search knows it (the stepped loop, or
    ``rounds_to_host``), else None."""
    best: torch.Tensor
    n_evals: torch.Tensor
    rounds: torch.Tensor
    n_survivors: torch.Tensor
    used_exact: Union[bool, torch.Tensor]
    n_evals_cached: torch.Tensor
    sums: torch.Tensor
    sqsums: torch.Tensor
    rounds_h: Optional[int] = None

    def read(self, report=None, phase: str = "search") -> SearchResult:
        """The result on the host, in one ``engine.host_read``."""
        used = self.used_exact
        on_device = [used] if torch.is_tensor(used) else []
        vals = host_read([self.best, self.n_evals, self.rounds,
                          self.n_survivors, self.n_evals_cached]
                         + on_device, report, phase)
        return SearchResult(best=vals[0], n_evals=vals[1], rounds=vals[2],
                            n_survivors=vals[3],
                            used_exact=bool(vals[5]) if on_device else used,
                            n_evals_cached=vals[4], sums=self.sums,
                            sqsums=self.sqsums)


def log_term_f32(delta: float, device) -> torch.Tensor:
    """``log(1/δ)`` as the JAX package folds it: the reciprocal in
    float64, then the cast and the log in float32."""
    log_t = torch.log(torch.tensor(1.0 / delta, dtype=torch.float32))
    return to_device(log_t, torch.float32, device)


def default_count(active: torch.Tensor) -> torch.Tensor:
    return torch.sum(active, dtype=torch.int64)


class Layout(NamedTuple):
    """A permutation-sampling schedule: round r reads slots
    ``[r·B, (r+1)·B)`` of ``idx`` (reference indices) and ``w`` ({0,1}
    weights), device tensors of ``R·B`` slots; ``sizes[r]`` is the
    round's Σw (host ints) and ``n_new[r]`` the samples after it, an
    ``[R]`` int64 device tensor.  The weights cover every reference point
    exactly once (Σ sizes == n_ref), so the budget ends at full
    coverage."""
    idx: torch.Tensor
    w: torch.Tensor
    sizes: Tuple[int, ...]
    n_new: torch.Tensor


def cyclic_layout(perm: torch.Tensor, n_ref: int, batch_size: int
                  ) -> Layout:
    """The single fit's layout: ``perm`` tiled cyclically
    (:func:`tile_perm`), every round B slots but the last; its tables are
    made on the device, with no copy from the host."""
    B = int(batch_size)
    idx, w = tile_perm(perm, n_ref, B)
    R = -(-n_ref // B)
    n_new = torch.clamp_max(torch.arange(1, R + 1, device=perm.device) * B,
                            n_ref)
    return Layout(idx, w, tuple(min(B, n_ref - r * B) for r in range(R)),
                  n_new)


def explicit_layout(idx: np.ndarray, w: np.ndarray, batch_size: int,
                    device) -> Layout:
    """A layout from host arrays (``[R·B]`` slot indices and {0,1}
    weights), e.g. the sharded fit's stratified one; copied to ``device``
    without waiting for it (``pic_cache.to_device``)."""
    B = int(batch_size)
    sizes = np.count_nonzero(np.asarray(w).reshape(-1, B), axis=1)
    return Layout(to_device(np.asarray(idx, np.int64), torch.int64, device),
                  to_device(np.asarray(w, np.float32), torch.float32, device),
                  tuple(int(v) for v in sizes),
                  to_device(np.cumsum(sizes), torch.int64, device))


def tile_perm(perm: torch.Tensor, n_ref: int, batch_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cyclic layout: ``perm`` (``[n_ref]``, or ``[G, n_ref]`` for G
    searches at once) tiled to ``ceil(n/B)·B`` slots, and the {0,1}
    weights that zero the slots past ``n_ref``."""
    total = -(-n_ref // batch_size) * batch_size
    reps = -(-total // n_ref)
    perm_idx = perm.repeat(*[1] * (perm.ndim - 1), reps)[..., :total]
    perm_w = (torch.arange(total, device=perm.device) < n_ref).to(
        torch.float32)
    return perm_idx, perm_w


class _Search:
    """One search's state on the device, and its round.

    The state is the per-arm moments (``sums``, ``sqsums``, ``sigma``), the
    survivor mask ``active``, the leader state, the int64 tallies,
    ``done`` (rounds run) and ``n_active`` (survivors, kept up to date by
    the stepped loop, which reads it), and the 0-d bool ``running``.
    ``n_used`` (the samples drawn once the rounds enqueued so far have
    run) is a host int that follows the static schedule.  So do the
    round's scalars: the
    samples after round r, ``n_new_f[r]``, and the confidence factors
    ``root[r] = sqrt(log(1/δ)/n_new_f[r])`` and ``fpc[r]`` (the
    finite-population factor) are tables made once per search, read by
    round index without a launch.
    """

    def __init__(self, *, n_arms, n_ref, batch_size, log_term, active_init,
                 layout, draw, count_fn, baseline, stop_when_positive,
                 free_rounds, free_lo, init_sums, init_sqsums, init_rounds,
                 resident):
        dev = active_init.device
        self.dev = dev
        self.n_ref = n_ref
        self.B = B = int(batch_size)
        self.log_term = log_term
        self.count_fn = count_fn
        self.draw = draw
        self.use_lead = baseline == "leader"
        self.stop_when_positive = stop_when_positive
        self.free = (free_lo, free_rounds)
        self.resident = resident
        self.layout = layout
        f32 = dict(dtype=torch.float32, device=dev)
        if layout is not None:
            n_new = layout.n_new
            # Samples after r rounds, r = 0..R, for the final pick.
            self.n_cum = torch.cat([torch.zeros_like(n_new[:1]), n_new])
        else:
            n_new = torch.arange(1, -(-n_ref // B) + 1, device=dev) * B
            self.ones = torch.ones((B,), **f32)
        self.n_new_f = n_new.to(torch.float32)
        self.root = torch.sqrt(log_term / self.n_new_f)
        if layout is not None:
            n_eff_f = self.scalar(n_ref)
            self.fpc = torch.sqrt(torch.clamp_min(
                1.0 - self.n_new_f / n_eff_f, 0.0))
        self.active = active_init.clone()
        self.n_evals = torch.zeros((), dtype=torch.int64, device=dev)
        self.n_cached = torch.zeros_like(self.n_evals)
        self.done = torch.zeros_like(self.n_evals)
        self.r0 = int(init_rounds) if init_sums is not None else 0
        # Σ w over the carried prefix (min(r0·B, n) for the cyclic tiling).
        self.n_used = sum(layout.sizes[:self.r0]) if layout is not None else 0
        if self.use_lead:
            self.arms = torch.arange(n_arms, device=dev)
            self.lead = torch.zeros((), dtype=torch.int64, device=dev)
            self.d_sums = torch.zeros((n_arms,), **f32)
            self.sigma_d = torch.full((n_arms,), float("inf"), **f32)
            # Samples since the pilot round r0, after each round, and the
            # differenced confidence factor.
            post = n_new - n_new[min(self.r0, n_new.numel() - 1)]
            self.post_f = post.to(torch.float32)
            self.root_d = torch.sqrt(log_term / self.post_f)
        if init_sums is None:
            self.sums = torch.zeros((n_arms,), **f32)
            self.sqsums = torch.zeros((n_arms,), **f32)
            self.sigma = torch.full((n_arms,), float("inf"), **f32)
        else:
            # σ from the carried moments (every arm has n_used samples).
            self.sums, self.sqsums = init_sums, init_sqsums
            n0_f = self.scalar(max(self.n_used, 1))
            mu0 = self.sums / n0_f
            self.sigma = torch.sqrt(torch.clamp_min(
                self.sqsums / n0_f - mu0 * mu0, 0.0)) + SIGMA_FLOOR
        self.n_active = torch.sum(self.active, dtype=torch.int64)
        self.running = self.n_active > 1
        if stop_when_positive and init_sums is not None:
            n0_f = self.scalar(max(self.n_used, 1))
            self.running = self.running & _may_improve(
                self.sums, self.sigma, self.active, n0_f,
                torch.sqrt(log_term / n0_f))

    def scalar(self, v: float) -> torch.Tensor:
        return torch.full((), float(v), dtype=torch.float32,
                          device=self.dev)   # on-device fill, no copy

    def round(self, rnd: int, stats_fn: StatsFn, aux: Any, lead) -> bool:
        """Round ``rnd``: its batch statistics from ``stats_fn`` (given
        the leader ``lead``, None before the pilot round), then the state
        update, selected by ``running`` in the device-resident loop.
        Returns whether this was a leader search's pilot round."""
        B = self.B
        if self.layout is not None:
            lo = rnd * B
            ref_idx = self.layout.idx[lo:lo + B]
            w = self.layout.w[lo:lo + B]
            b_eff = self.layout.sizes[rnd]
        else:
            ref_idx, w, b_eff = self.draw(rnd), self.ones, B
        kw = {}
        if self.resident:
            kw["run"] = self.running.to(torch.int32).reshape(1)
        if aux is None:
            sums_b, sq_b, cross_b = stats_fn(ref_idx, w, lead, **kw)
        else:
            sums_b, sq_b, cross_b = stats_fn(ref_idx, w, lead, rnd, aux,
                                             **kw)

        # ---- raw statistics (paper) ----
        new = {"sums": self.sums + sums_b, "sqsums": self.sqsums + sq_b}
        n_new_f = self.n_new_f[rnd]
        mu_hat = new["sums"] / n_new_f
        sigma = self.sigma
        if self.n_used == 0:                                      # Eq. 11
            b_eff_f = self.scalar(b_eff)
            batch_mean = sums_b / b_eff_f
            batch_var = torch.clamp_min(
                sq_b / b_eff_f - batch_mean * batch_mean, 0.0)
            new["sigma"] = sigma = torch.sqrt(batch_var) + SIGMA_FLOOR
        ci = sigma * self.root[rnd]
        if self.layout is not None:
            ci = ci * self.fpc[rnd]
        active = self.active
        ucb = torch.where(active, mu_hat + ci, float("inf"))
        lcb = mu_hat - ci
        kill = lcb > torch.min(ucb)

        # ---- differenced statistics vs the pilot leader ----
        pilot = self.use_lead and rnd == self.r0
        if pilot:
            new["lead"] = torch.argmin(torch.where(active, mu_hat,
                                                   float("inf")))
        elif self.use_lead:
            li = self.lead.reshape(1)
            d_b = sums_b - sums_b.index_select(0, li)
            dsq_b = sq_b - 2.0 * cross_b + sq_b.index_select(0, li)
            new["d_sums"] = d_sums = self.d_sums + d_b
            sigma_d = self.sigma_d
            if rnd == self.r0 + 1:
                b_eff_f = self.scalar(b_eff)
                d_mean = d_b / b_eff_f
                new["sigma_d"] = sigma_d = torch.sqrt(torch.clamp_min(
                    dsq_b / b_eff_f - d_mean * d_mean, 0.0)) + SIGMA_FLOOR
            mu_d = d_sums / self.post_f[rnd]
            root = self.root_d[rnd]
            ci_d = sigma_d * root
            ucb_d = torch.where(active, mu_d + ci_d, float("inf"))
            eps_d = LEAD_TIE_REL * sigma * root
            kill_d = (mu_d - ci_d) > torch.min(ucb_d) + eps_d
            kill = kill | (kill_d & (self.arms != self.lead))

        cost = self.count_fn(active) * b_eff
        if self.resident:
            # A round enqueued after the stop counts nothing, kills
            # nothing, and keeps the moments and the leader as they were.
            on = self.running
            cost, kill = cost * on, kill & on
            new = {k: torch.where(on, v, getattr(self, k))
                   for k, v in new.items()}
        lo_free, hi_free = self.free
        if lo_free <= rnd < hi_free:
            self.n_cached = self.n_cached + cost
        else:
            self.n_evals = self.n_evals + cost
        self.active = active & ~kill
        self.n_used += b_eff
        n_active = torch.sum(self.active, dtype=torch.int64)
        going = n_active > 1
        if self.stop_when_positive:
            going = going & _may_improve(new["sums"], sigma, self.active,
                                         n_new_f, self.root[rnd])
        if self.resident:
            self.done = self.done + on
            going = going & on
        else:
            self.done = self.done + 1
            self.n_active = n_active
        # tracecheck: ignore[TRC002] -- binds the round's fixed set of new
        # state tensors to attributes: a host loop that launches nothing
        for k, v in new.items():
            setattr(self, k, v)
        self.running = going
        return pilot

    def _sampled_means(self) -> torch.Tensor:
        rounds = self.done + self.r0
        n_used = (rounds * self.B if self.layout is None
                  else self.n_cum.index_select(0, rounds.view(1))[0])
        return self.sums / torch.clamp_min(n_used, 1).to(torch.float32)

    def result(self, exact_fn, used_exact) -> "DeviceResult":
        """The pick: the FIRST index minimising the survivors' means, the
        exact ones where ``used_exact`` holds: a host bool (the stepped
        loop), or a 0-d device bool (the resident loop), which is the
        exact pass's run flag and selects between the two means."""
        if torch.is_tensor(used_exact):
            exact = exact_fn(run=used_exact.to(torch.int32).reshape(1))
            mu = torch.where(used_exact, exact, self._sampled_means())
            mu_sel = torch.where(self.active, mu, float("inf"))
            self.n_evals = (self.n_evals + self.count_fn(self.active)
                            * self.n_ref * used_exact)
        elif used_exact:
            mu_sel = torch.where(self.active, exact_fn(), float("inf"))
            self.n_evals = (self.n_evals
                            + self.count_fn(self.active) * self.n_ref)
        else:
            mu_sel = torch.where(self.active, self._sampled_means(),
                                 float("inf"))
        return DeviceResult(best=torch.argmin(mu_sel), n_evals=self.n_evals,
                            rounds=self.done + self.r0,
                            n_survivors=torch.sum(self.active,
                                                  dtype=torch.int64),
                            used_exact=used_exact,
                            n_evals_cached=self.n_cached, sums=self.sums,
                            sqsums=self.sqsums)


def device_search(*, stats_fn: StatsFn, n_arms: int, n_ref: int,
                  batch_size: int, log_term: torch.Tensor,
                  active_init: torch.Tensor,
                  layout: Optional[Layout] = None,
                  draw: Optional[DrawFn] = None,
                  exact_fn: Optional[ExactFn] = None,
                  count_fn: CountFn = default_count,
                  baseline: str = "none",
                  stop_when_positive: bool = False,
                  free_rounds: int = 0, free_lo: int = 0,
                  init_sums: Optional[torch.Tensor] = None,
                  init_sqsums: Optional[torch.Tensor] = None,
                  init_rounds: int = 0, aux: Any = None,
                  resident: bool = False, rounds_to_host: bool = False,
                  report=None, phase: str = "search") -> "DeviceResult":
    """Run one best-arm identification (one BUILD assignment or one SWAP
    pick) and leave its result on the device.

    Give ``layout`` (a :class:`Layout`, permutation sampling) or ``draw``
    (``rnd -> [B]`` int64 indices, replacement sampling, with
    ``exact_fn(run=None) -> [n_arms]`` exact means for the fallback).
    ``stats_fn(ref_idx[B], w[B], lead) -> (sums, sqsums, cross)`` returns
    the per-arm weighted batch sums of g, g² and g·g_lead (``lead`` is
    the leader arm as a 0-d int64 device tensor, or None when no
    cross-sum is needed).  ``count_fn`` gives the distance evaluations per reference point
    as a function of the survivor mask (BUILD: #active arms; SWAP:
    #distinct active candidates).  With ``aux`` given, ``stats_fn`` is
    called as ``stats_fn(ref_idx, w, lead, rnd, aux)``, ``rnd`` the round
    index.  The cache seeds (``free_*``, ``init_*``) are in the module
    docstring.

    ``resident=True`` runs the device-resident loop under either
    sampling mode; it passes ``stats_fn`` the keyword ``run``, a ``[1]``
    int32 device flag that is 0 for a round enqueued after the stop (the
    round's result is discarded; a kernel may skip its work, and a PIC
    ``stats_fn`` leaves its ring as it was), and a replacement search's
    ``exact_fn`` the keyword ``run``, its fallback flag.  ``draw`` must
    then give every round up to the budget's without consuming another
    search's draws.  ``rounds_to_host=True`` fills ``rounds_h`` there
    too, at most one read more.  Every read goes through
    ``engine.host_read``, counted under ``phase`` in ``report``.
    """
    if (layout is None) == (draw is None):
        raise ValueError("give exactly one of layout (permutation sampling) "
                         "and draw (replacement sampling)")
    if layout is not None and sum(layout.sizes) != n_ref:
        raise ValueError(f"the layout's weights cover {sum(layout.sizes)} "
                         f"reference points, not n_ref={n_ref}")
    if draw is not None and exact_fn is None:
        raise ValueError("replacement sampling needs exact_fn for the "
                         "exact fallback")
    if baseline not in ("none", "leader"):
        raise ValueError(f"unknown baseline mode {baseline!r}")
    if (init_sums is None) != (init_sqsums is None):
        raise ValueError("init_sums and init_sqsums must be given together")
    if init_sums is not None and layout is None:
        raise ValueError("carried statistics require permutation sampling "
                         "over a fixed perm")
    s = _Search(n_arms=n_arms, n_ref=n_ref, batch_size=batch_size,
                log_term=log_term, active_init=active_init, layout=layout,
                draw=draw, count_fn=count_fn, baseline=baseline,
                stop_when_positive=stop_when_positive,
                free_rounds=free_rounds, free_lo=free_lo,
                init_sums=init_sums, init_sqsums=init_sqsums,
                init_rounds=init_rounds, resident=resident)
    every = ROUNDS_PER_READ if resident else 1
    lead = None          # the leader stats_fn gets, once the pilot ran
    going, n_active = True, None
    if not resident:
        going, n_active = host_read([s.running, s.n_active], report, phase)
    rnd = s.r0
    seen = []            # the round count, read with the flag
    while s.n_used < n_ref and going:
        if s.round(rnd, stats_fn, aux, lead):
            lead = s.lead
        rnd += 1
        if resident:
            if (rnd - s.r0) % every == 0 and s.n_used < n_ref:
                going, *seen = host_read(
                    [s.running] + [s.done] * rounds_to_host, report, phase)
        else:
            # The stepped round's one read: the verdict and the survivors.
            going, n_active = host_read([s.running, s.n_active], report,
                                        phase)
    done = None
    if not resident:
        done = rnd - s.r0                    # every enqueued round ran
    elif rounds_to_host:
        if rnd == s.r0:
            done = 0
        elif going:
            # Ran to its budget with no read after its stop: once more.
            (done,) = host_read([s.done], report, phase)
        else:
            (done,) = seen
    if draw is None:
        used_exact = False
    elif resident:
        # The JAX package's lax.cond, decided on the device.
        used_exact = torch.sum(s.active, dtype=torch.int64) > 1
    else:
        used_exact = n_active > 1
    return s.result(exact_fn, used_exact)._replace(
        rounds_h=None if done is None else done + s.r0)


def adaptive_search(*, report=None, phase: str = "search",
                    **kw) -> SearchResult:
    """:func:`device_search` (same arguments), its result read back in
    one more ``engine.host_read``."""
    return device_search(report=report, phase=phase, **kw).read(report,
                                                                phase)


class LaneResult(NamedTuple):
    """A lane search's result on the device: ``[L]`` int64 tensors (and
    the final ``[L, arms]`` moments); ``rounds`` counts each lane's
    carried rounds too, as :class:`SearchResult` does.  ``rounds_h`` is
    ``rounds`` on the host where the search was asked for it
    (``rounds_to_host``), else None."""
    best: torch.Tensor
    n_evals: torch.Tensor
    rounds: torch.Tensor
    n_evals_cached: Optional[torch.Tensor] = None
    sums: Optional[torch.Tensor] = None
    sqsums: Optional[torch.Tensor] = None
    rounds_h: Optional[list] = None


class _LaneSearch:
    """L permutation searches in lockstep (see the module docstring).

    ``perm_idx`` / ``perm_w`` are ``[L, R_max·B]``: each lane's cyclic
    tiling (``tile_perm``) padded with index 0 at weight 0; ``n_ref`` the
    lanes' reference counts (host ints) and ``n_dev`` the same ``[L]`` on
    the device; ``log_term`` ``[L]`` float32.  The cache seeds are the
    single search's, per lane: ``free`` ``[L, R_max]`` bool marks the
    rounds served from the caller's cache (charged to ``n_evals_cached``),
    and ``init_rounds[l]`` (a host int, or None for a cold lane) with the
    rows of ``init_sums`` / ``init_sqsums`` ``[L, arms]`` is lane l's
    carried start.  Lockstep runs from the smallest start of a ``live``
    lane (a host list; None: every lane), the lanes that are not live
    having no arm left; a lane before its start is masked, as a lane past
    its budget is.
    """

    def __init__(self, *, n_ref, n_dev, batch_size, log_term, active_init,
                 perm_idx, perm_w, count_fn, baseline, stop_when_positive,
                 free=None, init_sums=None, init_sqsums=None,
                 init_rounds=None, live=None):
        dev = active_init.device
        L, n_arms = active_init.shape
        self.B = B = int(batch_size)
        self.R = R = max(-(-n // B) for n in n_ref)
        # Round-major, so each round's [L, B] slice is contiguous.
        self.perm_idx = perm_idx.view(L, R, B).transpose(0, 1).contiguous()
        self.perm_w = perm_w.view(L, R, B).transpose(0, 1).contiguous()
        self.count_fn = count_fn
        self.use_lead = baseline == "leader"
        self.stop_when_positive = stop_when_positive
        self.free = free
        f32 = dict(dtype=torch.float32, device=dev)
        carried = ([False] * L if init_rounds is None
                   else [r is not None for r in init_rounds])
        self.r0 = [0 if not c else int(r)
                   for c, r in zip(carried, init_rounds or carried)]
        live = [True] * L if live is None else live
        self.r_start = min((r for r, on in zip(self.r0, live) if on),
                           default=R)
        self.r_last = max(self.r0)
        steps = torch.arange(self.R, device=dev)
        nd = n_dev.to(torch.int64)[:, None]
        if self.r_last == 0:
            r0 = torch.zeros((L, 1), dtype=torch.int64, device=dev)
        else:
            r0 = to_device(self.r0, torch.int64, dev)[:, None]
        self.r0_dev = r0[:, 0]
        # Samples after round r, clamped to each lane's n, as the single
        # search's table; a lane's rounds before its start and past its
        # budget are masked.
        n_new = torch.minimum((steps + 1)[None, :] * B, nd)       # [L, R]
        self.pre = steps[None, :] < r0                            # [L, R]
        self.budget = (steps[None, :] < (nd + B - 1) // B) & ~self.pre
        self.b_eff = torch.clamp(nd - steps[None, :] * B, 0, B)   # [L, R]
        self.b_eff_f = self.b_eff.to(torch.float32)
        self.n_new_f = n_new.to(torch.float32)
        lt = log_term[:, None]
        self.root = torch.sqrt(lt / self.n_new_f)
        self.fpc = torch.sqrt(torch.clamp_min(
            1.0 - self.n_new_f / n_dev.to(torch.float32)[:, None], 0.0))
        self.n_cap = nd[:, 0]
        self.active = active_init.clone()
        self.n_evals = torch.zeros((L,), dtype=torch.int64, device=dev)
        self.n_cached = torch.zeros_like(self.n_evals)
        self.done = torch.zeros_like(self.n_evals)
        if self.use_lead:
            self.arms = torch.arange(n_arms, device=dev)[None, :]
            self.lead = torch.zeros((L,), dtype=torch.int64, device=dev)
            self.d_sums = torch.zeros((L, n_arms), **f32)
            self.sigma_d = torch.full((L, n_arms), float("inf"), **f32)
            # Samples since each lane's pilot round (its start).
            post = n_new - n_new.gather(1, torch.clamp_max(r0, R - 1))
            self.post_f = post.to(torch.float32)
            self.root_d = torch.sqrt(lt / self.post_f)
        self.sums = torch.zeros((L, n_arms), **f32)
        self.sqsums = torch.zeros((L, n_arms), **f32)
        self.sigma = torch.full((L, n_arms), float("inf"), **f32)
        self.running = torch.sum(self.active, dim=1, dtype=torch.int64) > 1
        if any(carried):
            # σ from each carried lane's moments (every arm has the lane's
            # prefix of samples); a cold lane starts from zeros.
            c = to_device(carried, torch.bool, dev)[:, None]
            n0_f = torch.clamp_min(torch.minimum(r0 * B, nd), 1).to(
                torch.float32)
            mu0 = init_sums / n0_f
            sigma0 = torch.sqrt(torch.clamp_min(
                init_sqsums / n0_f - mu0 * mu0, 0.0)) + SIGMA_FLOOR
            self.sums = torch.where(c, init_sums, self.sums)
            self.sqsums = torch.where(c, init_sqsums, self.sqsums)
            self.sigma = torch.where(c, sigma0, self.sigma)
            if stop_when_positive:
                lcb = self.sums / n0_f - self.sigma * torch.sqrt(lt / n0_f)
                may = torch.min(torch.where(self.active, lcb, float("inf")),
                                dim=1).values <= 0.0
                self.running = self.running & (may | ~c[:, 0])

    def round(self, rnd: int, stats_fn, lead) -> None:
        """Round ``rnd`` of every lane: one ``stats_fn`` call, then each
        lane's state update, selected by its flag ``on`` (started, still
        running and within its budget)."""
        ref_idx, w = self.perm_idx[rnd], self.perm_w[rnd]
        on = self.running & self.budget[:, rnd]
        sums_b, sq_b, cross_b = stats_fn(rnd, ref_idx, w, lead,
                                         on.to(torch.int32))

        # ---- raw statistics (paper) ----
        new = {"sums": self.sums + sums_b, "sqsums": self.sqsums + sq_b}
        n_new_f = self.n_new_f[:, rnd:rnd + 1]
        mu_hat = new["sums"] / n_new_f
        sigma = self.sigma
        if rnd == 0:                                              # Eq. 11
            # Only the lanes that start at round 0 run it.
            b_eff_f = self.b_eff_f[:, :1]
            batch_mean = sums_b / b_eff_f
            batch_var = torch.clamp_min(
                sq_b / b_eff_f - batch_mean * batch_mean, 0.0)
            new["sigma"] = sigma = torch.sqrt(batch_var) + SIGMA_FLOOR
        ci = sigma * self.root[:, rnd:rnd + 1]
        ci = ci * self.fpc[:, rnd:rnd + 1]
        active = self.active
        ucb = torch.where(active, mu_hat + ci, float("inf"))
        lcb = mu_hat - ci
        kill = lcb > torch.min(ucb, dim=1, keepdim=True).values

        # ---- differenced statistics vs each lane's pilot leader ----
        # Where the lanes' starts differ, each lane's pilot, differenced
        # rounds and σ_d round are selected by masks; where every lane
        # is past its pilot (or all start at 0) no mask is needed.
        mixed = rnd <= self.r_last and self.r_last > 0
        if self.use_lead and self.r_start <= rnd <= self.r_last:
            lead = torch.argmin(torch.where(active, mu_hat, float("inf")),
                                dim=1)
            new["lead"] = (torch.where(self.r0_dev == rnd, lead, self.lead)
                           if mixed else lead)
        if self.use_lead and rnd > self.r_start:
            after = (self.r0_dev < rnd)[:, None] if mixed else None
            li = self.lead[:, None]
            d_b = sums_b - sums_b.gather(1, li)
            dsq_b = sq_b - 2.0 * cross_b + sq_b.gather(1, li)
            new["d_sums"] = d_sums = self.d_sums + d_b
            if after is not None:
                new["d_sums"] = torch.where(after, d_sums, self.d_sums)
            sigma_d = self.sigma_d
            if rnd <= self.r_last + 1:
                b_eff_f = self.b_eff_f[:, rnd:rnd + 1]
                d_mean = d_b / b_eff_f
                sigma_d = torch.sqrt(torch.clamp_min(
                    dsq_b / b_eff_f - d_mean * d_mean, 0.0)) + SIGMA_FLOOR
                if self.r_last > 0:
                    first = (self.r0_dev + 1 == rnd)[:, None]
                    sigma_d = torch.where(first, sigma_d, self.sigma_d)
                new["sigma_d"] = sigma_d
            mu_d = d_sums / self.post_f[:, rnd:rnd + 1]
            root = self.root_d[:, rnd:rnd + 1]
            ci_d = sigma_d * root
            ucb_d = torch.where(active, mu_d + ci_d, float("inf"))
            eps_d = LEAD_TIE_REL * sigma * root
            kill_d = ((mu_d - ci_d)
                      > torch.min(ucb_d, dim=1, keepdim=True).values + eps_d)
            kill_d = kill_d & (self.arms != li)
            kill = kill | (kill_d if after is None else kill_d & after)

        # A lane before its start, past its stop or past its budget counts
        # nothing, kills nothing, and keeps its moments and its leader.
        cost = self.count_fn(active) * self.b_eff[:, rnd] * on
        kill = kill & on[:, None]
        new = {k: torch.where(on if v.ndim == 1 else on[:, None], v,
                              getattr(self, k))
               for k, v in new.items()}
        if self.free is None:
            self.n_evals = self.n_evals + cost
        else:
            served = self.free[:, rnd]
            self.n_cached = self.n_cached + cost * served
            self.n_evals = self.n_evals + cost * ~served
        self.active = active & ~kill
        going = torch.sum(self.active, dim=1, dtype=torch.int64) > 1
        if self.stop_when_positive:
            lcb_p = new["sums"] / n_new_f - sigma * self.root[:, rnd:rnd + 1]
            lcb_min = torch.min(torch.where(self.active, lcb_p,
                                            float("inf")), dim=1).values
            going = going & (lcb_min <= 0.0)
        self.done = self.done + on
        # tracecheck: ignore[TRC002] -- binds the round's fixed set of new
        # state tensors to attributes: a host loop that launches nothing
        for k, v in new.items():
            setattr(self, k, v)
        going = going & on
        if rnd < self.r_last:
            # A lane that has not started keeps its flag.
            going = going | (self.running & self.pre[:, rnd])
        self.running = going

    def result(self, rounds_h=None) -> LaneResult:
        """Each lane's pick: the FIRST index minimising its survivors'
        means."""
        rounds = self.done + self.r0_dev
        n_used_f = torch.minimum(torch.clamp_min(rounds * self.B, 1),
                                 self.n_cap).to(torch.float32)
        mu_sel = torch.where(self.active, self.sums / n_used_f[:, None],
                             float("inf"))
        return LaneResult(best=torch.argmin(mu_sel, dim=1),
                          n_evals=self.n_evals, rounds=rounds,
                          n_evals_cached=self.n_cached, sums=self.sums,
                          sqsums=self.sqsums, rounds_h=rounds_h)


def lane_search(*, stats_fn, n_ref, n_dev, batch_size: int,
                log_term: torch.Tensor, active_init: torch.Tensor,
                perm_idx: torch.Tensor, perm_w: torch.Tensor,
                count_fn=None, baseline: str = "none",
                stop_when_positive: bool = False, free=None, init_sums=None,
                init_sqsums=None, init_rounds=None, live=None,
                rounds_to_host: bool = False, report=None,
                phase: str = "search", rounds_log=None) -> LaneResult:
    """Run L permutation searches in lockstep, the device-resident loop
    with a lane axis, and leave the ``[L]`` results on the device.

    ``stats_fn(rnd, ref_idx [L, B], w [L, B], lead, run) -> 3 × [L,
    arms]`` gives every lane's batch statistics of round ``rnd`` in one
    call (``lead`` ``[L]`` int64 or None before the first pilot round,
    ``run`` the lanes' ``[L]`` int32 flags: a lane at 0 is discarded).
    ``count_fn(active [L, arms]) -> [L]`` int64 (default: #active arms).
    The cache seeds (``free``, ``init_*``) and ``live`` are
    :class:`_LaneSearch`'s.
    The host reads the lanes' flags once every ``ROUNDS_PER_READ`` rounds
    through ``engine.host_read`` (counted under ``phase`` in ``report``)
    and stops once all read 0; ``rounds_to_host`` reads the lanes' round
    counts with the flags, and once more at the end when the last read
    did not see every lane stop (the single search's rule), into
    ``rounds_h``.  ``rounds_log`` (a dict) counts the rounds enqueued
    under ``phase``.
    """
    if baseline not in ("none", "leader"):
        raise ValueError(f"unknown baseline mode {baseline!r}")
    if count_fn is None:
        def count_fn(active):
            return torch.sum(active, dim=1, dtype=torch.int64)
    s = _LaneSearch(n_ref=n_ref, n_dev=n_dev, batch_size=batch_size,
                    log_term=log_term, active_init=active_init,
                    perm_idx=perm_idx, perm_w=perm_w, count_fn=count_fn,
                    baseline=baseline, stop_when_positive=stop_when_positive,
                    free=free, init_sums=init_sums, init_sqsums=init_sqsums,
                    init_rounds=init_rounds, live=live)
    lead = None
    going, rnd = True, s.r_start
    seen = []            # the round counts, read with the flags
    while rnd < s.R and going:
        s.round(rnd, stats_fn, lead)
        if s.use_lead:
            lead = s.lead
        rnd += 1
        if rounds_log is not None:
            rounds_log[phase] = rounds_log.get(phase, 0) + 1
        if (rnd - s.r_start) % ROUNDS_PER_READ == 0 and rnd < s.R:
            flags, *seen = host_read([s.running] + [s.done] * rounds_to_host,
                                     report, phase)
            going = any(flags)
    done = None
    if rounds_to_host:
        if rnd == s.r_start:
            done = [0] * len(n_ref)
        elif going:
            # Ran to the budget with no read after every lane's stop.
            (done,) = host_read([s.done], report, phase)
        else:
            (done,) = seen
    return s.result(None if done is None
                    else [d + r for d, r in zip(done, s.r0)])


def _may_improve(sums, sigma, active, n_used_f, root):
    """The early stop's verdict as a 0-d bool tensor: True while some
    surviving arm's lower bound ``mu − σ·sqrt(log(1/δ)/n_used)`` is not
    positive (the search goes on), False once none can be an improving
    swap.  ``root`` is ``sqrt(log(1/δ)/n_used)``."""
    lcb = sums / n_used_f - sigma * root
    lcb_min = torch.min(torch.where(active, lcb, float("inf")))
    return lcb_min <= 0.0
