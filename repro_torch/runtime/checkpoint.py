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

On a mesh (the JAX package's sharded arrays are DTensors here) the
files still hold global arrays.  ``save`` gathers each DTensor leaf (a
collective: every rank of its mesh calls ``save``), the mesh's first
rank writes, and the mesh's ranks meet before returning (a sum over the
mesh, on the groups its DTensors use).
``restore(..., shardings=...)`` places a leaf that has a sharding
(``distributed.sharding.NamedSharding``) as a DTensor on that mesh, each
rank slicing its own shard from the file, so a checkpoint written on
one mesh restores onto another (``runtime/elastic.py``); a leaf whose
template is a DTensor and that has no sharding is placed as its
template is.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, distribute_tensor

__all__ = ["latest_step", "read_extra", "restore", "save", "sync"]

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


def _host(leaf) -> Tuple[np.ndarray, str]:
    """``(array, dtype name)``: a bfloat16 tensor, which numpy lacks, as
    its bits (uint16) under the name ``bfloat16``, the JAX manifest's."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A saved leaf as a tensor (bfloat16 from its bits)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.as_tensor(arr)


def _mesh_of(leaves):
    """The mesh of the first DTensor among ``leaves`` (None if none)."""
    for leaf in leaves:
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` meets here: a sum over each of its
    dimensions (the groups its DTensors already use)."""
    one = torch.zeros(1, device=mesh.device_type)
    DTensor.from_local(one, mesh, [Partial()] * mesh.ndim,
                       run_check=False).full_tensor()


def sync(tree: Any) -> None:
    """Every rank of the mesh of ``tree``'s DTensors meets here; nothing
    without one.  A rank that has looked at the directory waits here
    until every rank has, before any of them writes to it."""
    mesh = _mesh_of(leaf for _, leaf in _flatten(tree))
    if mesh is not None:
        _mesh_barrier(mesh)


def _leaf_shardings(tree, shardings) -> List[Any]:
    """``shardings`` (a tree like ``tree``, None below a key where it
    stops) as one entry a leaf of ``tree`` in ``_flatten``'s order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            sub = shardings.get(k) if isinstance(shardings, dict) else None
            out += _leaf_shardings(tree[k], sub)
        return out
    return [shardings]


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``; returns
    its folder."""
    path = _step_dir(ckpt_dir, step)
    flat = _flatten(tree)
    mesh = _mesh_of(leaf for _, leaf in flat)
    arrays = [_host(leaf) for _, leaf in flat]     # gathers on a mesh
    if mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0]):
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = {"step": step, "keys": [k for k, _ in flat],
                "extra": extra or {}, "shapes": [], "dtypes": []}
        for i, (arr, dtype_name) in enumerate(arrays):
            meta["shapes"].append(list(arr.shape))
            meta["dtypes"].append(dtype_name)
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)                      # atomic publish
    if mesh is not None:                           # published for every rank
        _mesh_barrier(mesh)
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
            device=None, shardings: Any = None) -> Tuple[Any, Dict]:
    """Restore checkpoint ``step`` (default: the latest) into the
    structure of ``tree_like``; returns ``(tree, manifest)``.
    ``shardings`` (optional) is a tree like ``tree_like`` of
    ``NamedSharding``s, None for a leaf restored as without one (module
    docstring)."""
    path, meta = _manifest(ckpt_dir, step)
    flat = _flatten(tree_like)
    if [k for k, _ in flat] != meta["keys"]:
        raise ValueError(f"checkpoint/template structure mismatch: "
                         f"{meta['keys']} vs {[k for k, _ in flat]}")
    out = []
    for i, ((_, ref), sh) in enumerate(zip(flat, _leaf_shardings(
            tree_like, shardings))):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        dtype_name = meta["dtypes"][i]
        if sh is None and isinstance(ref, DTensor):
            sh = (ref.device_mesh, ref.placements)
        elif sh is not None:
            sh = (sh.mesh, sh.placements)
        if sh is not None:
            x = _tensor(arr, dtype_name)
            if isinstance(ref, torch.Tensor):
                x = x.to(ref.dtype)
            out.append(distribute_tensor(x.to(sh[0].device_type), sh[0],
                                         sh[1], src_data_rank=None))
        elif isinstance(ref, torch.Tensor):
            out.append(_tensor(arr, dtype_name).to(
                device=ref.device if device is None else device,
                dtype=ref.dtype))
        else:
            out.append(arr.astype(np.asarray(ref).dtype, copy=False))
    return _unflatten(tree_like, iter(out)), meta


def read_extra(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    return _manifest(ckpt_dir, step)[1]["extra"]
