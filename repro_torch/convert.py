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
  records (:func:`service_from_reference`);
* the LM's parameters and AdamW state cross as their pytrees
  (``repro.models.model.init_params``, ``repro.train.init_opt_state``)
  given as numpy arrays (:func:`lm_params_from_reference`,
  :func:`opt_state_from_reference`).  ``params["groups"]`` holds one
  entry per pattern position, each leaf stacked ``[n_groups, ...]``, so
  layer ``i`` of a pattern of length P is ``groups[i % P][leaf][i // P]``;
  zamba2's ``params["shared_attn"]`` is one unstacked block.  A JAX
  ``x @ w`` weight ``[in, out]`` becomes the ``nn.Linear`` weight
  ``[out, in]``, its transpose: the attention, MLP and dense-MLP
  matrices and the SSM projections (``in_x``, ``in_z``, ``x_proj``,
  ``dt_proj``, ``in_xbc``, ``in_dt``, ``out_proj``), the head and
  ``vision_proj``.  Audio's ``embed`` [nc, V, d] and ``lm_head`` [nc,
  d, V] (the JAX einsum's operand), the MoE leaves (``router``, ``wi``,
  ``wg``, ``wo``, batched-product operands), the SSM ``conv_w`` [K, C]
  and every vector cross as they are;
* a JAX decode state (``repro.models.model.forward(...,
  collect_state=True)`` or ``decode_step``'s, numpy leaves) crosses
  unchanged in layout (:func:`lm_state_from_reference`): the tuple of
  pairs stacked over the groups, ``(k, v)`` ``[G, B, S_c, KVH, hd]`` for
  an attention cache and ``(conv, h)`` for an SSM state
  (``models.model``'s docstring).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .core import rng
from .core.device import DeviceLike, resolve_device
from .models.model import LAYER_LEAVES
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


_TOP_LEAVES = {"embed", "lm_head", "vision_proj", "final_norm", "groups",
               "shared_attn"}


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: through float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _paths(node, prefix=()):
    """The leaf paths of a nested mapping."""
    if isinstance(node, Mapping):
        for key, child in node.items():
            yield from _paths(child, prefix + (key,))
    else:
        yield prefix


def _block_leaves(block: Mapping[str, Any], index, prefix: str,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """``block``'s leaves (their entry ``index`` where stacked, all of
    them where ``index`` is None) under the port's names after
    ``prefix``; raising on a leaf the table lacks."""
    known = {path for path, _, _ in LAYER_LEAVES}
    extra = set(_paths(block)) - known
    if extra:
        raise ValueError(f"unknown LM layer leaves {sorted(extra)}")
    out = {}
    for path, name, matrix in LAYER_LEAVES:
        node = block
        for key in path:
            node = node.get(key) if isinstance(node, Mapping) else None
        if node is None:
            continue                    # another kind's leaf, or no qk-norm
        a = np.asarray(node)
        if index is not None:
            a = a[index]
        out[prefix + name] = _tensor(a.T if matrix else a, device)
    return out


def _lm_leaves(tree: Mapping[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The top leaves: ``embed`` as it is ([V, d], audio's [nc, V, d]);
    a 2-D ``lm_head`` [d, V] and ``vision_proj`` [d, d] transposed into
    ``nn.Linear`` weights (``x @ W`` is ``F.linear(x, W.T)``), audio's
    ``lm_head`` [nc, d, V] as it is (the einsum's operand)."""
    extra = set(tree) - _TOP_LEAVES
    if extra:
        raise ValueError(f"unknown LM parameters {sorted(extra)}")
    out = {"embed.weight": _tensor(tree["embed"], device)}
    if "lm_head" in tree:
        head = np.asarray(tree["lm_head"])
        out["lm_head.weight"] = _tensor(head.T if head.ndim == 2 else head,
                                        device)
    if "vision_proj" in tree:
        out["vision_proj.weight"] = _tensor(
            np.asarray(tree["vision_proj"]).T, device)
    groups = tree["groups"]
    per = len(groups)
    first = groups[0]
    for key in next(_paths(groups[0])):
        first = first[key]
    n_groups = len(np.asarray(first))
    for i in range(per * n_groups):
        out.update(_block_leaves(groups[i % per], i // per, f"layers.{i}.",
                                 device))
    if "shared_attn" in tree:
        out.update(_block_leaves(tree["shared_attn"], None, "shared_attn.",
                                 device))
    out["final_norm.weight"] = _tensor(tree["final_norm"], device)
    return out


def lm_params_from_reference(params: Mapping[str, Any],
                             device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """The JAX LM's ``params`` (numpy leaves) as the port's
    parameters by name (``models.model.params_of``), on ``device`` (the
    card by default): ``model.load_state_dict(...)`` or
    ``models.model.load_params`` takes them."""
    return _lm_leaves(params, resolve_device(device))


def lm_state_from_reference(state: Sequence[Tuple[Any, Any]],
                            device: DeviceLike = None
                            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """A JAX LM's decode state (numpy leaves: a tuple of pairs, each
    stacked over the groups, ``models.model``'s layout) as the port's, on
    ``device`` (the card by default): ``models.model.decode_step``
    continues from it."""
    dev = resolve_device(device)
    out = []
    for entry in state:
        if len(entry) != 2:
            raise ValueError(f"a decode-state entry is a pair, not "
                             f"{len(entry)} leaves")
        out.append(tuple(_tensor(a, dev) for a in entry))
    return tuple(out)


def opt_state_from_reference(state: Mapping[str, Any],
                             device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX AdamW state (``{"m", "v", "step"}``, numpy leaves) as the
    port's ``train.optimizer`` state, keyed as the parameters."""
    dev = resolve_device(device)
    return {"m": _lm_leaves(state["m"], dev), "v": _lm_leaves(state["v"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
