"""Logical-axis sharding rules onto a ``DeviceMesh`` (counterpart of
``repro.distributed.sharding``).

Models annotate activations with *logical* axis names; the mapping to
the mesh's named dimensions lives here, so the same model code runs on
one device (no mesh set: every call below is the identity), on a single
pod (16 x 16 ``data`` / ``model``) or on the multi-pod mesh (2 x 16 x 16
``pod`` / ``data`` / ``model``).  The torch counterpart of a
``jax.sharding.Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
with the same dimension names, and that of a sharded array a DTensor.

Physical conventions (the JAX module's):

* ``batch`` -> ``("pod", "data")``: data parallelism, hierarchical across
  pods;
* ``heads`` -> ``model``: tensor parallelism over the query heads;
* ``kv_heads`` replicated (GQA: fewer kv heads than the model extent);
* ``ff`` / ``d_inner`` / ``experts`` / ``vocab`` -> ``model``;
* ``seq`` unsharded by default; ``kv_seq`` (decode caches) -> ``model``,
  widened to every mesh axis by the long-context dry-run cell.

:func:`spec_for` returns the JAX ``PartitionSpec``'s tuple form (``None``
for an unsharded dim, a name, or a tuple of names, major first);
:func:`placements` turns it into DTensor placements, one for each mesh
dimension (a tensor dim mapped to ``("pod", "data")`` is ``Shard`` on
both, the pod dimension the major one, as DTensor orders them).
:func:`shard` is ``with_sharding_constraint``: it redistributes a
DTensor to the spec (a ``Partial`` sum is reduced there).  A dim that
its mesh axes do not divide stays whole (llama4's 40 heads over a model
axis of 16): XLA pads such a dim, DTensor cannot view an uneven shard
as heads; the values are the same, each rank holds more of them.
:func:`splittable` gathers a dim before a view splits it into blocks
that its shards would cut.

A forward pass makes plain tensors of its own (rope tables, masks,
position iotas, zero states); an op between one of those and a DTensor
raises.  :func:`like` puts such a tensor on the activation's mesh,
replicated, and leaves it alone when the activation is a plain tensor,
so a run without a mesh is unchanged bit for bit.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_state = threading.local()

Spec = Tuple[object, ...]

DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "d_model": None,
    "heads": ("model",),
    "kv_heads": None,
    "head_dim": None,
    "ff": ("model",),
    "d_inner": ("model",),
    "ssm_state": None,
    "experts": ("model",),
    "vocab": ("model",),
    "expert_cap": None,
    "codebooks": None,
    # Decode caches shard their sequence axis over "model" (sequence
    # parallelism for decode); the long-context cell widens this to every
    # mesh axis (launch/dryrun.py).
    "kv_seq": ("model",),
}


def set_mesh(mesh: Optional[DeviceMesh], rules: Optional[Dict] = None
             ) -> None:
    """Set this thread's mesh and rules (``DEFAULT_RULES`` overridden by
    ``rules``)."""
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


def clear() -> None:
    set_mesh(None)


def spec_for(*logical_axes: Optional[str]) -> Spec:
    """The spec of a tensor whose dims carry these logical names: ``()``
    without a mesh, else one entry a dim (the JAX ``PartitionSpec``'s
    tuple)."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    rules = getattr(_state, "rules", DEFAULT_RULES)
    axis_names = set(mesh.mesh_dim_names)
    parts = []
    for ax in logical_axes:
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            parts.append(None)
        else:
            got = tuple(p for p in phys if p in axis_names)
            parts.append(got if len(got) > 1 else (got[0] if got else None))
    return tuple(parts)


def placements(spec: Sequence, mesh: DeviceMesh) -> Tuple:
    """DTensor placements (one a mesh dimension) of ``spec``: ``Shard(i)``
    on every mesh dimension that tensor dim ``i`` names, ``Replicate()``
    on the rest."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        for name in (part if isinstance(part, tuple) else (part,)):
            j = names.index(name)
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {name!r} shards two dims of "
                                 f"{tuple(spec)}")
            out[j] = Shard(i)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and a spec (``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)


def sharding_for(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    mesh = get_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(*logical_axes))


def _extent(x: DTensor, dim: int) -> int:
    """How many ways the mesh splits tensor dim ``dim`` of ``x``."""
    return math.prod(x.device_mesh.size(j) for j, p in
                     enumerate(x.placements) if p.is_shard(dim))


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the spec of these logical names (a dim its
    axes do not divide kept whole); ``x`` itself without a mesh or when
    ``x`` is a plain tensor."""
    s = sharding_for(*logical_axes)
    if s is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = list(s.placements)
    for i, part in enumerate(s.spec):
        names = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)
        if x.shape[i] % n:
            want = [Replicate() if p.is_shard(i) else p for p in want]
    want = tuple(want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def splittable(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` ready for a view that splits tensor dim ``dim`` into
    ``parts`` blocks: that dim gathered whole where the mesh splits it
    in a number of ways that does not divide ``parts``."""
    if isinstance(x, DTensor) and parts % _extent(x, dim % x.ndim):
        return unsharded(x, dim)
    return x


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the forward made, on ``ref``'s mesh, replicated,
    where ``ref`` is a DTensor and ``t`` is not; else ``t`` itself."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def unsharded(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` gathered whole (every mesh dimension
    that shards it replicated); ``x`` itself when it is a plain tensor
    or that dim is not sharded."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if p.is_shard(dim % x.ndim) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def per_shard(fn, n_out: int, ref: torch.Tensor, *tensors: torch.Tensor):
    """``fn(*tensors)``, a tuple of ``n_out`` tensors, on each rank's own
    shards: every tensor placed as ``ref`` (a DTensor) first, every
    output placed so; ``fn(*tensors)`` itself when ``ref`` is a plain
    tensor.  For an ``fn`` that treats the sharded dims independently
    (attention's batch rows and heads, the MoE layer's data shards): the
    JAX partitioner's local computation, no collective inside."""
    if not isinstance(ref, DTensor):
        return fn(*tensors)
    pl = tuple(ref.placements)
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=(pl,) * len(tensors),
                     device_mesh=ref.device_mesh,
                     redistribute_inputs=True)(*tensors)


def to_local_full(x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` as a plain tensor (a DTensor gathered)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
