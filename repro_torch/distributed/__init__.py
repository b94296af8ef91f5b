"""Distribution substrate for the LM path (``repro.distributed``'
counterpart): ``sharding`` (logical axes onto a ``DeviceMesh``),
``compression`` (the int8 error-feedback gradient reduction over a
``torch.distributed`` group) and ``pipeline`` (the GPipe schedule over a
group or a mesh axis, imported explicitly as in the JAX package)."""

from . import compression, sharding
from .sharding import set_mesh, shard, sharding_for, spec_for

__all__ = ["compression", "sharding", "set_mesh", "shard", "sharding_for",
           "spec_for"]
