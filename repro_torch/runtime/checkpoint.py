"""Checkpoint save / restore of nested dicts of tensors and numpy leaves
(counterpart of ``repro.runtime.checkpoint``).

Layout, the JAX package's::

    <dir>/step_<N>/      N zero-padded to 8 digits
        manifest.json    step, leaf keys, shapes, dtypes, extras
        arr_<i>.npy      one file per leaf, in sorted-key order

published atomically: written under ``step_<N>.tmp`` and renamed.  The
manifest is JSON where the JAX package writes msgpack (Python's ``json``
round-trips floats exactly, and needs nothing installed); the leaves are
those of a nested dict flattened in sorted-key order, as
``jax.tree_util`` flattens a dict, under the same key strings
(``['a']/['b']``).

``restore`` puts a leaf whose template is a tensor on ``device`` (or the
template's device) in the template's dtype; a leaf whose template is a
numpy array or scalar comes back as numpy with the saved bits, so
float64 and int64 host state round-trips exactly.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["latest_step", "read_extra", "restore", "save"]

MANIFEST = "manifest.json"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/[{k!r}]" if prefix
                            else f"[{k!r}]")
        return out
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """The structure of ``tree`` with its leaves taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``; returns
    its folder."""
    path = _step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    meta = {"step": step, "keys": [k for k, _ in flat],
            "extra": extra or {}, "shapes": [], "dtypes": []}
    for i, (_, leaf) in enumerate(flat):
        arr = _host(leaf)
        meta["shapes"].append(list(arr.shape))
        meta["dtypes"].append(str(arr.dtype))
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)                      # atomic publish
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _manifest(ckpt_dir: str, step: Optional[int]) -> Tuple[str, Dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, MANIFEST)) as f:
        return path, json.load(f)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            device=None) -> Tuple[Any, Dict]:
    """Restore checkpoint ``step`` (default: the latest) into the
    structure of ``tree_like``; returns ``(tree, manifest)``."""
    path, meta = _manifest(ckpt_dir, step)
    flat = _flatten(tree_like)
    if [k for k, _ in flat] != meta["keys"]:
        raise ValueError(f"checkpoint/template structure mismatch: "
                         f"{meta['keys']} vs {[k for k, _ in flat]}")
    out = []
    for i, (_, ref) in enumerate(flat):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if isinstance(ref, torch.Tensor):
            out.append(torch.as_tensor(arr, dtype=ref.dtype).to(
                ref.device if device is None else device))
        else:
            out.append(arr.astype(np.asarray(ref).dtype, copy=False))
    return _unflatten(tree_like, iter(out)), meta


def read_extra(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    return _manifest(ckpt_dir, step)[1]["extra"]
