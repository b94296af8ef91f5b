"""FitGuard: the port's runtime guard (counterpart of
``repro.analysis.guard``).

The JAX package runs its fused fits under ``jax.transfer_guard
("disallow")`` and holds each one to one dispatch a phase.  The port's
counterparts:

* :func:`guarded` runs a fit under ``torch.cuda.set_sync_debug_mode
  ("error")``: any operation that makes the host wait for the device (a
  ``.item()``, a ``bool`` of a device tensor, a copy from pageable
  memory, a read with ``.cpu()``) raises at the call that made it.  The
  drivers' sanctioned points lift the mode around themselves:
  ``engine.host_read`` (every device-to-host read of a fit, counted in
  ``FitReport.host_reads_by_phase``), ``engine.host_stage`` (an input
  upload before the first round, with its reason) and the phase walls'
  synchronisations.  Tables uploaded inside the rounds go through pinned
  memory without a wait (``pic_cache.to_device``) and need no span.
* :func:`expected_reads` is the read contract of the device-resident
  loop, the port's form of one dispatch a phase: a search reads its flag
  once every ``adaptive.ROUNDS_PER_READ`` rounds, a phase once more at
  its end.
* :func:`kernel_state` is what two identical fits must leave as they
  found it (the JAX ``jit_cache_sizes``): the kernel library is not
  built again, and the tile tuner's ledger gains no bucket and no
  config.

:class:`FitGuard` covers ``BanditPAM`` and ``DistributedBanditPAM``
(``fit``) and ``BanditPAM.fit_batch``.  The stepped driver
(``fused=False``) reads once a round by design and is exempt, as the JAX
package's stepped baseline is.  The sharded fit is guarded at world size
1 (``nccl`` on the card, ``gloo`` on the CPU, or no group); the ranks of
``distributed.spawn_fits`` are other processes, whose ``gloo``
collectives on the card stage through the host by design, and are
exempt.

On the CPU the guard checks everything but the syncs, which the CPU does
not have.  The pytest fixtures at the bottom (``torch_fit_guard``,
``sync_guard``) are defined only where pytest can be imported.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterable, Optional

import torch

from ..core import tuning
from ..core.adaptive import ROUNDS_PER_READ
from ..core.batch import lane_arrays
from ..core.device import resolve_device
from ..core.engine import host_read, host_stage  # noqa: F401  (re-export)
from ..kernels import build as _build
from ..kernels import ops

__all__ = ["FitGuard", "expected_reads", "guarded", "kernel_state",
           "host_read", "host_stage"]

# What a guarded fit must reproduce of its warm-up, besides the medoids
# and the loss (a batch's lanes have no reads of their own).
REPORT_FIELDS = ("evals_by_phase", "swap_history", "build_rounds",
                 "host_reads_by_phase")
LANE_FIELDS = REPORT_FIELDS[:-1]


@contextlib.contextmanager
def guarded(device=None):
    """``torch.cuda.set_sync_debug_mode("error")`` on a CUDA ``device``
    (None: the card where there is one), the previous mode put back on
    exit, on a raise too.  On the CPU it does nothing: the CPU has no
    device to wait for, so there is no sync to catch."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _round_budget(est, n: int) -> int:
    """The most rounds one search of ``est`` runs on n points: every round
    consumes B of the n-point budget, ``ceil(n / B)``; a sharded fit of S
    ranks walks ``ceil(ceil(n / S) / (B / S))`` rounds of its PIC layout
    (its replacement draws, ``ceil(n / B)``, are fewer)."""
    S = getattr(est, "n_shards", 1)
    return -(-(-(-n // S)) // (est.batch_size // S))


def expected_reads(report, est, n: int,
                   swap_rounds: Optional[Iterable[int]] = None
                   ) -> Dict[str, int]:
    """The most host reads a device-resident fit of ``est`` on n points
    may make, by phase (the port's counterpart of the JAX
    ``expected_dispatches``).

    A resident search enqueues its rounds and reads its flag after every
    ``P = ROUNDS_PER_READ`` rounds it enqueued while its budget lasts; a
    search that ends its budget with the flag still set, and must report
    its round count, reads once more.  So a search that ran r rounds read
    at most ``ceil(r / P)`` times, and once where it ran none (its flag
    was down from the start but the loop had enqueued rounds before the
    first read).  Hence:

    * BUILD (absent after a warm start): ``Σ ceil(r_i / P) + k + 1`` over
      its k searches' rounds ``report.build_rounds`` (the k for the
      searches that ran none, the 1 for the phase's end read of picks,
      rounds and ledger).
    * SWAP: each iteration reads its search's flag at most
      ``ceil(R / P)`` times (R = :func:`_round_budget`; a search that
      continues carried rounds enqueues fewer), then once for its pick,
      loss, accept bit and ledger, and the phase reads its first loss
      once: ``iterations · (ceil(R / P) + 2)``, iterations being
      ``n_swaps + converged``.  Given the rounds each SWAP search ran
      (``swap_rounds``), the tighter ``Σ ceil(r_t / P) + 2 · iterations``.
    """
    per = ROUNDS_PER_READ
    iters = report.n_swaps + int(report.converged)
    if swap_rounds is None:
        swap = iters * (-(-_round_budget(est, n) // per) + 2)
    else:
        rounds = list(swap_rounds)
        swap = sum(-(-r // per) for r in rounds) + 2 * len(rounds)
    out = {"swap": swap}
    if report.build_rounds:
        out["build"] = (sum(-(-r // per) for r in report.build_rounds)
                        + est.k + 1)
    return out


def kernel_state() -> Dict[str, object]:
    """What a second identical fit must not change: whether the kernel
    library is loaded and the build that made it in this process (a
    rebuild changes its times), and the tile tuner's measured ledger as
    buckets and the configs recorded in each (a fit that resolved a new
    config, or a new bucket, would show)."""
    info = _build.build_info
    return {
        "library": (_build._lib is not None, info.get("cached"),
                    info.get("compile_s"), info.get("link_s")),
        "tuner": {key: frozenset(configs) for key, configs
                  in tuning.ledger_snapshot().items()},
    }


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _launches(before: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches since ``before`` (``ops.launch_counts``)."""
    return {k: v - before[k] for k, v in ops.launch_counts().items()
            if v != before[k]}


def _same_fit(got, want, fields, what: str) -> None:
    _require(got.medoids.tolist() == want.medoids.tolist(),
             f"the guard changed {what} (medoids {got.medoids.tolist()} != "
             f"{want.medoids.tolist()})")
    _require(got.loss == want.loss,
             f"the guard changed {what} (loss {got.loss!r} != "
             f"{want.loss!r})")
    for f in fields:
        _require(getattr(got, f) == getattr(want, f),
                 f"the guard changed {what} ({f} {getattr(got, f)} != "
                 f"{getattr(want, f)})")


def _resident(est) -> None:
    if not getattr(est, "fused", True):
        raise ValueError(
            "FitGuard covers the device-resident driver (fused=True); the "
            "stepped driver reads once a round by design and is exempt")


class FitGuard:
    """Runs fits under :func:`guarded` and checks their reads.

    :meth:`fit` runs one unguarded warm-up fit (it builds and loads the
    kernels, resolves the tiles and starts a communicator, none of which
    a fit does twice), then the same fit under the guard, and requires
    that the guarded fit

    * reproduces the warm-up's report: medoids, loss, ``evals_by_phase``,
      ``swap_history``, ``build_rounds`` and ``host_reads_by_phase``;
    * launches every kernel as often as the warm-up did
      (``ops.launch_counts``);
    * leaves :func:`kernel_state` as the warm-up left it;
    * reads within :func:`expected_reads`.

    A failed requirement raises ``AssertionError``; a sync raises at the
    call that made it.  ``last_report`` holds the guarded report.
    """

    def __init__(self) -> None:
        self.last_report = None
        self.last_launches: Dict[str, int] = {}

    def fit(self, est, data, *, warm_start=None, warmup: bool = True,
            check_reads: bool = True, check_rebuild: bool = True):
        """Guard ``est.fit(data)`` (``warm_start`` passed where given) for
        a ``BanditPAM`` or ``DistributedBanditPAM``."""
        _resident(est)

        def call():
            if warm_start is None:
                return est.fit(data)
            return est.fit(data, warm_start=warm_start)

        baseline = launches = state = None
        if warmup:
            before = ops.launch_counts()
            baseline = call()
            launches = _launches(before)
            if check_rebuild:
                state = kernel_state()
        before = ops.launch_counts()
        with guarded(resolve_device(est.device)):
            report = call()
        self.last_launches = _launches(before)
        if state is not None:
            _require(kernel_state() == state,
                     f"the guarded fit rebuilt a kernel or moved the tuner: "
                     f"{state} -> {kernel_state()}")
        if baseline is not None:
            _same_fit(report, baseline, REPORT_FIELDS, "the fit")
            _require(self.last_launches == launches,
                     f"the guard changed the launches: {self.last_launches} "
                     f"!= {launches}")
        if check_reads:
            bound = expected_reads(report, est, len(data))
            reads = report.host_reads_by_phase
            _require(set(reads) <= set(bound) and all(
                v <= bound[ph] for ph, v in reads.items()),
                f"host reads {reads} past the resident loop's contract "
                f"{bound}")
        self.last_report = report
        return report

    def fit_batch(self, est, datasets, *, seeds=None, warmup: bool = True,
                  check_reads: bool = True, check_rebuild: bool = True):
        """The batched twin of :meth:`fit` for ``est.fit_batch(datasets,
        seeds)``: the warm-up batch, then the same batch guarded, every
        lane's report (medoids, loss, ledger, swaps, build rounds), the
        batch's ``host_reads_by_phase`` and ``dispatches_by_phase`` (its
        round launches) and the kernel launches equal to the warm-up's.
        ``check_reads`` fits the stepped twin (``fused=False``) of every
        lane with its seed and requires that the batch read fewer times
        in each phase than that loop: the port's form of the JAX
        contract of one dispatch a phase whatever the batch size."""
        _resident(est)
        baseline = launches = state = None
        if warmup:
            before = ops.launch_counts()
            baseline = est.fit_batch(datasets, seeds)
            launches = _launches(before)
            if check_rebuild:
                state = kernel_state()
        before = ops.launch_counts()
        with guarded(resolve_device(est.device)):
            batch = est.fit_batch(datasets, seeds)
        self.last_launches = _launches(before)
        if state is not None:
            _require(kernel_state() == state,
                     f"the guarded batch rebuilt a kernel or moved the "
                     f"tuner: {state} -> {kernel_state()}")
        if baseline is not None:
            for i, (rep, base) in enumerate(zip(batch, baseline)):
                _same_fit(rep, base, LANE_FIELDS, f"fit {i} of the batch")
            for f in ("host_reads_by_phase", "dispatches_by_phase"):
                _require(getattr(batch, f) == getattr(baseline, f),
                         f"the guard changed the batch's {f}: "
                         f"{getattr(batch, f)} != {getattr(baseline, f)}")
            _require(self.last_launches == launches,
                     f"the guard changed the launches: {self.last_launches} "
                     f"!= {launches}")
        if check_reads:
            stepped = copy.copy(est)
            stepped.fused = False
            arrs = lane_arrays(datasets)
            loop: Dict[str, int] = {}
            for i, x in enumerate(arrs):
                stepped.seed = est.seed if seeds is None else seeds[i]
                for ph, v in stepped.fit(x).host_reads_by_phase.items():
                    loop[ph] = loop.get(ph, 0) + v
            reads = batch.host_reads_by_phase
            _require(all(reads.get(ph, 0) < v for ph, v in loop.items()),
                     f"the batch's reads {reads} are not fewer than its "
                     f"stepped twin's {loop} in every phase")
        self.last_report = batch
        return batch


try:  # pragma: no cover - exercised via pytest, absent in production
    import pytest
except ImportError:  # pragma: no cover
    pytest = None

if pytest is not None:
    @pytest.fixture
    def torch_fit_guard() -> FitGuard:
        """Sync-guard and read-contract harness for resident fits."""
        return FitGuard()

    @pytest.fixture
    def sync_guard():
        """Bare ``set_sync_debug_mode("error")`` context factory."""
        return guarded
