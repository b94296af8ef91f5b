"""Solver registry for the ``KMedoids`` facade (counterpart of
``repro.api.registry``).

Solver contract::

    fn(data, k, *, metric: str, seed: int, device, layouts=None, **params)
        -> FitReport

A solver may also register a batched multi-fit entry point
(``batch_fn``, behind ``KMedoids.fit_batch``)::

    batch_fn(datasets, k, *, metric, seed, device, seeds=None, **params)
        -> BatchFitReport

``datasets`` a ``[B, n, d]`` array or a list of ragged ``[n_i, d]``
ones; each fit of the batch must equal ``fn`` on its dataset and seed
bit for bit (``tests/test_torch_multifit.py`` holds the bandit solvers
to it).

``data`` is a ``[n, d]`` float32 tensor on the fit's device (already
``attach_index``-augmented when ``metric == "precomputed"``); ``metric``
is a registered name (the facade resolves callables first).

Ported: ``banditpam`` (its knobs, the cache regimes ``reuse`` /
``cache_width`` / ``cache_cols`` included, reach the fit as solver
params), ``banditpam_pp`` (BanditPAM++: ``banditpam`` with
``reuse="pic"`` by default), the exact oracles ``pam`` (PAM's k·n² SWAP
accounting) and ``fastpam1`` (n² per SWAP step; the same medoids), the
baselines ``fasterpam``, ``voronoi``, ``clarans`` and ``clara``
(``core.baselines``) and ``onebatchpam`` (``core.onebatch``).  All of
them run through the stats backend and so take ``backend=``; only the
bandit solvers read ``layouts=``.  ``banditpam_dist`` is the sharded fit
(``core.distributed``) over the process group ``group=`` (default: the
WORLD group once ``torch.distributed`` is initialised, else one shard);
it draws its own stratified batches and refuses ``layouts=``, and
``fused=False`` puts it on the stepped loop (its other params, such as
``reuse`` and ``cache_width``, reach it the same way).
``mesh=`` a ``DeviceMesh`` instead of ``group=`` shards over its
``pod`` / ``data`` axes (``core.distributed.data_group``).
``banditpam`` and ``banditpam_pp`` have batched entry points; the
sharded fit has none, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.banditpam import BanditPAM
from ..core.baselines import clara, clarans, fasterpam, voronoi_iteration
from ..core.onebatch import onebatchpam
from ..core.pam import pam
from ..core.report import FitReport

Solver = Callable[..., FitReport]

_SOLVERS: Dict[str, Solver] = {}
_BATCH_SOLVERS: Dict[str, Callable] = {}
_ACCEPTS_BACKEND: set = set()

# Solvers that accept the adaptive-search knobs (baseline / sampling /
# cache_cols / ...).
BANDIT_SOLVERS = ("banditpam", "banditpam_pp")


def register_solver(name: str, fn: Solver, *,
                    accepts_backend: bool = False,
                    batch_fn: Optional[Callable] = None) -> None:
    """Register ``fn`` under ``name``; ``accepts_backend=True`` declares
    that it takes the ``backend=`` stats-backend kwarg, and ``batch_fn``
    is its batched multi-fit entry point (see the module docstring)."""
    _SOLVERS[name] = fn
    if batch_fn is not None:
        _BATCH_SOLVERS[name] = batch_fn
    else:
        _BATCH_SOLVERS.pop(name, None)
    if accepts_backend:
        _ACCEPTS_BACKEND.add(name)
    else:
        _ACCEPTS_BACKEND.discard(name)


def get_solver(name: str) -> Solver:
    if name not in _SOLVERS:
        raise KeyError(f"unknown solver {name!r}; have {sorted(_SOLVERS)}")
    return _SOLVERS[name]


def get_batch_solver(name: str) -> Callable:
    get_solver(name)                       # the unknown-name error first
    if name not in _BATCH_SOLVERS:
        raise ValueError(
            f"solver {name!r} has no batched entrypoint; fit_batch is "
            f"available for {sorted(_BATCH_SOLVERS)} (register one via "
            f"register_solver(..., batch_fn=...))")
    return _BATCH_SOLVERS[name]


def available_solvers():
    return sorted(_SOLVERS)


def available_batch_solvers():
    return sorted(_BATCH_SOLVERS)


def solver_accepts_backend(name: str) -> bool:
    return name in _ACCEPTS_BACKEND


def default_params(solver: str) -> dict:
    """Recommended ``solver_params`` for a solver, as the JAX package's
    registry gives them: the bandit solvers get the leader control
    variate, everything else runs stock."""
    return {"baseline": "leader"} if solver in BANDIT_SOLVERS else {}


def _banditpam(data, k, *, metric, seed, device, layouts=None, **params):
    return BanditPAM(k, metric=metric, seed=seed, device=device,
                     **params).fit(data, layouts=layouts)


def _banditpam_pp(data, k, *, metric, seed, device, layouts=None,
                  **params):
    # BanditPAM++: the SWAP-phase reuse engine over the PIC column ring.
    params.setdefault("reuse", "pic")
    return _banditpam(data, k, metric=metric, seed=seed, device=device,
                      layouts=layouts, **params)


def _banditpam_batch(datasets, k, *, metric, seed, device, seeds=None,
                     **params):
    return BanditPAM(k, metric=metric, seed=seed, device=device,
                     **params).fit_batch(datasets, seeds=seeds)


def _banditpam_pp_batch(datasets, k, *, metric, seed, device, seeds=None,
                        **params):
    params.setdefault("reuse", "pic")
    return _banditpam_batch(datasets, k, metric=metric, seed=seed,
                            device=device, seeds=seeds, **params)


def _banditpam_dist(data, k, *, metric, seed, device, layouts=None,
                    **params):
    # The sharded fit over a process group (stratified per-shard draws,
    # all-reduce-composed statistics); imported lazily, as in the JAX
    # package's registry.
    from ..core.distributed import DistributedBanditPAM
    if layouts is not None:
        raise ValueError("solver 'banditpam_dist' draws its own stratified "
                         "batches; it takes no layouts")
    return DistributedBanditPAM(k, params.pop("group", None), metric=metric,
                                seed=seed, device=device, **params).fit(data)


def _pam(data, k, *, metric, seed, device, layouts=None, **params):
    # Deterministic: seed and layouts intentionally unused.
    return pam(data, k, metric=metric, fastpam1=False, device=device,
               **params)


def _fastpam1(data, k, *, metric, seed, device, layouts=None, **params):
    # Identical medoids to PAM; n² (not k·n²) SWAP accounting.
    return pam(data, k, metric=metric, fastpam1=True, device=device,
               **params)


def _seeded(fn):
    """A solver of ``core.baselines`` / ``core.onebatch``: it takes the
    seed and ignores ``layouts`` (it draws no bandit batches)."""
    def solver(data, k, *, metric, seed, device, layouts=None, **params):
        return fn(data, k, metric=metric, seed=seed, device=device,
                  **params)
    return solver


for _name, _fn in (("pam", _pam), ("fastpam1", _fastpam1),
                   ("fasterpam", _seeded(fasterpam)),
                   ("clara", _seeded(clara)), ("clarans", _seeded(clarans)),
                   ("voronoi", _seeded(voronoi_iteration)),
                   ("onebatchpam", _seeded(onebatchpam))):
    register_solver(_name, _fn, accepts_backend=True)
register_solver("banditpam", _banditpam, accepts_backend=True,
                batch_fn=_banditpam_batch)
register_solver("banditpam_pp", _banditpam_pp, accepts_backend=True,
                batch_fn=_banditpam_pp_batch)
register_solver("banditpam_dist", _banditpam_dist, accepts_backend=True)
