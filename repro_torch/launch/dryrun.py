"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): build and
run every (arch x shape x mesh) cell on the production meshes without
the hardware, and record what each device would hold, compute and send:
proof that the distribution config is coherent.

Usage (one process; it initialises a process-wide fake group)::

    python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both

Results append to ``--out`` (default ``results/dryrun.json``), one JSON
object a line, so a stopped batch resumes where it left off.

The JAX dry run forces 512 host devices; here the counterpart is a
``torch.distributed`` group on the ``fake`` backend (``FakeStore``) of
512 ranks, this process its rank 0: a ``DeviceMesh`` over it is real,
its collectives do nothing.  Every tensor is on the ``meta`` device
(shapes and dtypes, no storage), placed as DTensors by
``launch.specs``; the cell's step function then runs on them, and a
dispatch mode sees each rank-local op:

* ``flops``: each local op's FLOPs by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s table) on this rank's shards, summed:
  per device, as the JAX record's post-SPMD ``cost_analysis``;
* ``collective_counts`` / ``collective_bytes``: the functional
  collectives DTensor issues, by kind, each counted with its result's
  bytes (the JAX record's convention).  (``CommDebugMode`` counts the
  same ops, but its module tracker fails in the recomputed backward of a
  checkpointed group.)  On the fake CPU group an all-to-all is issued as
  an all-gather and counted so;
* ``arg_bytes``: the bytes of this rank's shards of the parameters,
  the optimizer state, the batch and the decode state.

The JAX record's ``bytes_accessed`` and its 1- and 2-group surrogate
correction have no counterpart: XLA's cost analysis counts a scanned
layer group once, while the port runs every layer and counts every op.
The long-context rules override is the JAX one (``batch`` unsharded,
``kv_seq`` over every mesh axis).  ``--reduced`` and ``--mesh-shape``
run reduced configs on a small fake group (the tests' cells).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_IDS, SHAPES, get_config, get_reduced,
                       supports_long_context)
from ..distributed import sharding as shrules
from . import specs
from .mesh import make_debug_mesh, make_production_mesh

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_MESHES = {"16x16": False, "2x16x16": True}       # name -> multi_pod


class DeviceCounts(TorchDispatchMode):
    """Counts one rank's work: an op on DTensors is handed to DTensor
    (``NotImplemented``), which runs it as local ops on the shards, and
    those come back through this mode, where they are counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.counts = {k: 0 for k in _COLLECTIVES.values()}
        self.bytes = {k: 0 for k in _COLLECTIVES.values()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(name)
        if kind is not None and "c10d_functional" in str(func):
            self.counts[kind] += 1
            self.bytes[kind] += out.numel() * out.element_size()
        return out


def init_fake_group(world: int) -> None:
    """A process-wide fake group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in ``tree``."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return _local_bytes(list(tree.parameters()))
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size()


def run_cell(arch: str, shape_name: str, mesh_name: str,
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]
             = None, reduced: bool = False) -> dict:
    """One cell on the mesh ``mesh_name`` (``_MESHES``, or ``mesh_shape``
    = (shape, axis names) for a small mesh) over the fake group."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if shape_name == "long_500k" and not supports_long_context(cfg):
        rec["status"] = "skipped (pure full attention)"
        return rec
    mesh = (make_debug_mesh(*mesh_shape) if mesh_shape else
            make_production_mesh(multi_pod=_MESHES[mesh_name],
                                 device_type="cpu"))
    rules = {}
    if shape_name == "long_500k":
        rules = {"batch": None, "kv_seq": tuple(mesh.mesh_dim_names)}
    shrules.set_mesh(mesh, rules)
    try:
        t0 = time.time()
        fn, args, shardings = specs.build_cell(cfg, shape, mesh)
        placed = specs.place_args(args, shardings)
        parts = dict(zip({"train": ("params", "opt", "batch"),
                          "prefill": ("params", "batch"),
                          "decode": ("params", "state", "batch")}[shape.kind],
                         placed))
        rec["arg_bytes"] = {k: _local_bytes(v) for k, v in parts.items()}
        with DeviceCounts() as dc:
            fn(*placed)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["flops"] = dc.flops
        rec["collective_counts"] = dc.counts
        rec["collective_bytes"] = dc.bytes
        pc = cfg.param_count()
        rec["params_total"] = pc["total"]
        rec["params_active"] = pc["active"]
        rec["status"] = "ok"
    except Exception as e:                   # one cell's failure is a record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    finally:
        shrules.clear()
    return rec


def load_done(path: str):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped (pure full attention)"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    return done


def _mesh_arg(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    dims = tuple(int(x) for x in text.split("x"))
    names = ("pod", "data", "model")[3 - len(dims):]
    return dims, names


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--mesh-shape", default=None,
                    help="a small mesh instead, e.g. 2x2 or 2x2x2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.mesh_shape:
        small = _mesh_arg(args.mesh_shape)
        meshes = [(args.mesh_shape, small)]
        world = math.prod(small[0])
    else:
        meshes = [(m, None) for m in {"single": ["16x16"], "multi": ["2x16x16"],
                                      "both": ["16x16", "2x16x16"]}[args.mesh]]
        world = 512 if any(_MESHES[m] for m, _ in meshes) else 256
    init_fake_group(world)
    done = set() if args.force else load_done(args.out)
    out = {}
    try:
        for arch in archs:
            for shape in shapes:
                for mesh_name, small in meshes:
                    if (arch, shape, mesh_name) in done:
                        print(f"[skip-done] {arch} {shape} {mesh_name}",
                              flush=True)
                        continue
                    print(f"[run] {arch} {shape} {mesh_name}", flush=True)
                    rec = run_cell(arch, shape, mesh_name, small,
                                   args.reduced)
                    out[(arch, shape, mesh_name)] = rec
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                    msg = rec["status"]
                    if rec["status"] == "ok":
                        msg += (f" flops={rec['flops']:.3e}"
                                f" run={rec['run_s']}s")
                    elif rec["status"] == "error":
                        msg += " :: " + rec["error"][:200]
                    print(f"  -> {msg}", flush=True)
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
