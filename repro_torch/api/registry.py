"""Solver registry for the ``KMedoids`` facade (counterpart of
``repro.api.registry``).

Solver contract::

    fn(data, k, *, metric: str, seed: int, device, layouts=None, **params)
        -> FitReport

Ported: ``banditpam`` (its knobs, the cache regimes ``reuse`` /
``cache_width`` / ``cache_cols`` included, reach the fit as solver
params), ``banditpam_pp`` (BanditPAM++: ``banditpam`` with
``reuse="pic"`` by default), and the exact oracles ``pam`` (PAM's k·n² SWAP
accounting) and ``fastpam1`` (n² per SWAP step; the same medoids), which
run through the stats backend and so take ``backend=``.  The JAX
package's other solvers are known by name and raise
``NotImplementedError`` with their ROADMAP item, so a caller learns that
the solver exists but is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.banditpam import BanditPAM
from ..core.pam import pam
from ..core.report import FitReport

Solver = Callable[..., FitReport]

_SOLVERS: Dict[str, Solver] = {}
_ACCEPTS_BACKEND: set = set()

# Solvers of the JAX package that later slices port, by ROADMAP item.
NOT_PORTED = {"banditpam_dist": "A13",
              "fasterpam": "A8", "clara": "A8", "clarans": "A8",
              "voronoi": "A8", "onebatchpam": "A8"}


def register_solver(name: str, fn: Solver, *,
                    accepts_backend: bool = False) -> None:
    """Register ``fn`` under ``name``; ``accepts_backend=True`` declares
    that it takes the ``backend=`` stats-backend kwarg."""
    _SOLVERS[name] = fn
    if accepts_backend:
        _ACCEPTS_BACKEND.add(name)
    else:
        _ACCEPTS_BACKEND.discard(name)


def get_solver(name: str) -> Solver:
    if name not in _SOLVERS:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"solver {name!r} is not ported to repro_torch yet "
                f"(ROADMAP {NOT_PORTED[name]})")
        raise KeyError(f"unknown solver {name!r}; have {sorted(_SOLVERS)}")
    return _SOLVERS[name]


def available_solvers():
    return sorted(_SOLVERS)


def solver_accepts_backend(name: str) -> bool:
    return name in _ACCEPTS_BACKEND


def _banditpam(data, k, *, metric, seed, device, layouts=None, **params):
    return BanditPAM(k, metric=metric, seed=seed, device=device,
                     **params).fit(data, layouts=layouts)


def _banditpam_pp(data, k, *, metric, seed, device, layouts=None,
                  **params):
    # BanditPAM++: the SWAP-phase reuse engine over the PIC column ring.
    params.setdefault("reuse", "pic")
    return _banditpam(data, k, metric=metric, seed=seed, device=device,
                      layouts=layouts, **params)


def _pam(data, k, *, metric, seed, device, layouts=None, **params):
    # Deterministic: seed and layouts intentionally unused.
    return pam(data, k, metric=metric, fastpam1=False, device=device,
               **params)


def _fastpam1(data, k, *, metric, seed, device, layouts=None, **params):
    # Identical medoids to PAM; n² (not k·n²) SWAP accounting.
    return pam(data, k, metric=metric, fastpam1=True, device=device,
               **params)


register_solver("banditpam", _banditpam, accepts_backend=True)
register_solver("banditpam_pp", _banditpam_pp, accepts_backend=True)
register_solver("pam", _pam, accepts_backend=True)
register_solver("fastpam1", _fastpam1, accepts_backend=True)
