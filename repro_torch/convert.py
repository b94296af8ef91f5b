"""Carry draws and fitted state across to the port (numpy in, no JAX).

BanditPAM has no weights; what a fit depends on besides the data is its
random draws, and what predict depends on is the fitted medoids.  A seed
needs nothing from here: the port's default layout source replays the
JAX package's threefry chain for it (``repro_torch.core.rng.from_seed``),
so ``KMedoids(seed=s)`` walks the JAX fit's draws on its own.  This
module replays draws given as arrays:

* :func:`layouts_from_reference` wraps per-search reference
  permutations (``[k, n]`` BUILD, ``[T, n]`` SWAP — e.g. from
  ``repro.core.banditpam._batch_rng_chains`` and ``_batch_perms``) as a
  layout source, so ``BanditPAM.fit(X, layouts=...)`` walks exactly
  those batches;
* :func:`draws_from_reference` does the same for replacement sampling:
  per-round batches, ``[k, R, B]`` BUILD and ``[T, R, B]`` SWAP with
  ``R = ceil(n/B)``.  Search ``s`` of the JAX fit (its key is
  ``_batch_rng_chains``' ``subs[s]``: k BUILD keys, then T SWAP keys)
  draws round ``r`` as ``key, sub = split(key); randint(sub, (B,), 0,
  n)``;
* ``layouts_from_reference(fixed_perm=...)`` carries the one fixed
  permutation of a fit with a distance cache (``reuse="pic"``, or
  ``cache_cols > 0`` under permutation sampling):
  ``jax.random.permutation(ckey, n)`` with ``ckey`` the first output of
  ``_batch_rng_chains``;
* a fitted JAX estimator crosses as its medoid indices, through
  ``repro_torch.api.KMedoids.from_fitted(X, medoids, metric)``;
* a JAX ``MedoidService`` crosses as its state tree, config and refit
  records (:func:`service_from_reference`).
"""

from __future__ import annotations

import numpy as np

from .core import rng
from .core.device import DeviceLike
from .serve import MedoidService

# The JAX package's stats backends and the port's counterparts.
_BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def layouts_from_reference(build_perms=None, swap_perms=None, *,
                           fixed_perm=None) -> rng.ArrayLayouts:
    """The JAX fit's reference permutations as a layout source: per
    search (``[k, n]`` BUILD, ``[T, n]`` SWAP) and/or the fixed one
    (``[n]``)."""
    perms = {name: None if p is None else np.asarray(p)
             for name, p in (("build", build_perms), ("swap", swap_perms),
                             ("fixed", fixed_perm))}
    for name, p in perms.items():
        if p is None or p.ndim not in (1, 2):
            continue                       # rng.from_numpy rejects the rest
        rows = np.atleast_2d(p)
        if not np.all(np.sort(rows, axis=1) == np.arange(rows.shape[1])):
            raise ValueError(f"{name} rows are not permutations of "
                             f"range({rows.shape[1]})")
    return rng.from_numpy(perms["build"], perms["swap"],
                          fixed_perm=perms["fixed"])


def draws_from_reference(build_draws, swap_draws) -> rng.ArrayLayouts:
    """The JAX fit's replacement draws (``[k, R, B]`` BUILD, ``[T, R, B]``
    SWAP) as a layout source for ``sampling="replacement"``."""
    return rng.from_numpy(build_draws=build_draws, swap_draws=swap_draws)


def service_from_reference(state_tree, config, refits=(),
                           device: DeviceLike = None) -> MedoidService:
    """A port ``MedoidService`` in a JAX service's state: ``state_tree``
    is its ``_state_tree()`` as numpy (``jax.device_get``), ``config``
    its ``config()``, ``refits`` its ``ledger.refits``.  Fed the stream
    the JAX service would have seen next, it trips the same refits and
    lands on the same medoids.  The backends ``"jnp"`` and ``"pallas"``
    become ``"torch"`` and ``"cuda"``; ``device=None`` is the card."""
    cfg = dict(config)
    cfg["backend"] = _BACKENDS.get(cfg["backend"], cfg["backend"])
    return MedoidService.from_state(cfg, state_tree, refits, device)
