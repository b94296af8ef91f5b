"""The port's mesh layer held against the JAX package, in one process (or
a subprocess of its own where a process-wide fake group is needed):

* ``runtime.elastic.plan_remesh`` equals the JAX function, its
  ``ValueError``s included, over 1–1,024 chips, model-parallel extents
  1–16 and pod counts None / 1 / 2 / 4;
* ``distributed.sharding.spec_for`` equals the JAX function's tuple for
  every logical name, with the default rules and a rules override, on
  the ``("model",)``, ``("data", "model")`` and ``("pod", "data",
  "model")`` meshes (the port's meshes are ``DeviceMesh``es over a fake
  group in a subprocess; the JAX side reads only the axis names, of an
  ``AbstractMesh``);
* for every architecture at full width on both production meshes, each
  parameter's spec (``launch.specs.param_spec``) equals its JAX leaf's
  (``repro.launch.specs._param_spec`` on ``eval_shape`` leaves), the
  leaf's group axis dropped and transposed with the port's ``nn.Linear``
  weights; the batch's and the decode state's specs equal
  ``batch_shardings``' and ``decode_state_shardings``' at every shape,
  and at a decode shape of 256 cache positions, below the JAX rule's
  ``shape[2] >= 512`` line, where it takes a KV cache for a Mamba-2
  state (copied, misfire included); the port's state shapes equal the
  JAX ones;
* the dry run (``launch.dryrun``, a subprocess on a fake 2 x 2 group
  and a 2 x 2 x 2 one at reduced configs): each cell's status is the
  verdict of the JAX ``cells()``, and its per-device parameter bytes
  are the sum of the local shards of the JAX leaves' specs;
* ``launch.train.main`` at the reduced qwen3 on the CPU for 4 steps,
  saving every 2: a run of 2 steps, then a second call that resumes
  from step 2, gives the straight run's losses bit for bit.
"""

import json
import math
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.runtime import elastic as jelastic
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.runtime import elastic
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = tuple(jsharding.DEFAULT_RULES) + (None, "unknown")
OVERRIDE = {"batch": None, "kv_seq": ("pod", "data", "model"),
            "seq": ("data",)}


def _start(code: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=f"src{os.pathsep}.",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: int = 300) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return out


def _plan_or_error(fn, *args, **kw):
    try:
        p = fn(*args, **kw)
        return tuple(p.shape), tuple(p.axes), p.dropped_chips
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_plan_remesh_matches_jax(mp):
    for chips in range(1, 1025):
        for pods in (None, 1, 2, 4):
            assert _plan_or_error(elastic.plan_remesh, chips, mp, pods) == \
                _plan_or_error(jelastic.plan_remesh, chips, mp, pods), \
                (chips, mp, pods)


# ---------------------------------------------------------------------------
# spec_for on DeviceMeshes (a fake group in a subprocess)
# ---------------------------------------------------------------------------

_SPEC_FOR = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import sharding
    cases = json.loads(sys.argv[1])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    out = []
    for dims, names, rules in cases:
        mesh = init_device_mesh("cpu", tuple(dims), mesh_dim_names=tuple(names))
        sharding.set_mesh(mesh, {k: tuple(v) if v else v
                                 for k, v in (rules or {}).items()})
        out.append([sharding.spec_for(ax) for ax in json.loads(sys.argv[2])]
                   + [sharding.spec_for(*json.loads(sys.argv[2]))])
    sharding.clear()
    out.append(sharding.spec_for("batch", "heads"))
    dist.destroy_process_group()
    print(json.dumps(out))
""")
SPEC_MESHES = [((8,), ("model",)), ((2, 4), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]


def _jsonable(spec):
    return json.loads(json.dumps(spec))


@pytest.fixture(scope="module")
def port_spec_for():
    cases = [(d, n, r) for d, n in SPEC_MESHES for r in (None, OVERRIDE)]
    proc = _start(_SPEC_FOR, json.dumps(cases), json.dumps(LOGICAL))
    return json.loads(_finish(proc).splitlines()[-1])


@pytest.mark.parametrize("mesh", range(len(SPEC_MESHES)))
def test_spec_for_matches_jax(port_spec_for, mesh):
    dims, names = SPEC_MESHES[mesh]
    for j, rules in enumerate((None, OVERRIDE)):
        jsharding.set_mesh(AbstractMesh(dims, names), rules)
        try:
            want = [tuple(jsharding.spec_for(ax)) for ax in LOGICAL]
            want.append(tuple(jsharding.spec_for(*LOGICAL)))
        finally:
            jsharding.clear()
        assert port_spec_for[2 * mesh + j] == _jsonable(want), (names, rules)
    assert port_spec_for[-1] == [] == list(jsharding.spec_for("batch",
                                                              "heads"))


# ---------------------------------------------------------------------------
# parameter, batch and decode-state specs at full width
# ---------------------------------------------------------------------------

def _jax_param_specs(arch, names):
    """The JAX leaf specs by ``keystr`` on a mesh with ``names``."""
    cfg = jconfigs.get_config(arch)
    dp, mp = jspecs._axes(AbstractMesh((1,) * len(names), names))
    leaves = jax.tree_util.tree_flatten_with_path(jspecs.params_specs(cfg))[0]
    return {jax.tree_util.keystr(p): (tuple(jspecs._param_spec(
        jax.tree_util.keystr(p), leaf, dp, mp, cfg)), leaf.shape)
        for p, leaf in leaves}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_jax(arch):
    cfg = configs.get_config(arch)
    model = specs.params_specs(cfg)
    for mesh_name, (_, names) in MESHES.items():
        want = _jax_param_specs(arch, names)
        dp, mp = specs.axes_of(names)
        seen = set()
        for name, p in M.params_of(model).items():
            path, stacked, transposed = M.reference_path(cfg, name)
            jspec, jshape = want[path]
            jspec, jshape = (jspec[1:], jshape[1:]) if stacked else (
                jspec, jshape)
            if transposed:
                jspec, jshape = jspec[::-1], jshape[::-1]
            assert tuple(p.shape) == tuple(jshape), name
            assert specs.param_spec(cfg, name, p, dp, mp) == jspec, (
                mesh_name, name)
            seen.add(path)
        assert seen == set(want)


def _decode_shapes():
    out = dict(configs.SHAPES)
    out["decode_256"] = configs.ShapeConfig("decode_256", 256, 8, "decode")
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_and_state_specs_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for mesh_name, (dims, names) in MESHES.items():
        amesh = AbstractMesh(dims, names)
        dp, mp = specs.axes_of(names)
        for sname, shape in _decode_shapes().items():
            jshape = jconfigs.ShapeConfig(*(getattr(shape, f) for f in (
                "name", "seq_len", "global_batch", "kind", "microbatches")))
            jb = jspecs.batch_specs(jcfg, jshape)
            pb = specs.batch_specs(cfg, shape)
            assert sorted(jb) == sorted(pb)
            jsh = jspecs.batch_shardings(jcfg, jshape, jb, amesh)
            for k, x in pb.items():
                assert tuple(x.shape) == jb[k].shape, (sname, k)
                assert specs.batch_spec(shape, x.ndim, dp) == tuple(
                    jsh[k].spec), (mesh_name, sname, k)
            if shape.kind != "decode":
                continue
            jst = jspecs.state_specs(jcfg, jshape)
            jst_sh = jspecs.decode_state_shardings(jcfg, jshape, jst, amesh)
            pst = specs.state_specs(cfg, shape)
            assert len(pst) == len(jst)
            for pe, je, jse in zip(pst, jst, jst_sh):
                for leaf, jleaf, jsh_leaf in zip(pe, je, jse):
                    assert tuple(leaf.shape) == jleaf.shape
                    assert specs.state_spec(
                        tuple(leaf.shape), dp, mp, shape.global_batch == 1,
                        names) == tuple(jsh_leaf.spec), (mesh_name, sname)


# ---------------------------------------------------------------------------
# the dry run on a fake group (subprocesses)
# ---------------------------------------------------------------------------

DRY_MESHES = {"2x2": ((2, 2), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (mesh, arch, shape): every arch's long-context and decode cells on the
# 2 x 2 mesh, a train cell, and two cells with a pod axis.
DRY_CELLS = ([("2x2", a, s) for a in configs.ARCH_IDS
              for s in ("long_500k", "decode_32k")]
             + [("2x2", "qwen3_1_7b", "train_4k"),
                ("2x2x2", "falcon_mamba_7b", "decode_32k"),
                ("2x2x2", "zamba2_2_7b", "long_500k")])


_DRYRUN = textwrap.dedent("""
    import json, math, sys
    from repro_torch.launch import dryrun
    dims = tuple(int(x) for x in sys.argv[1].split("x"))
    names = ("pod", "data", "model")[3 - len(dims):]
    dryrun.init_fake_group(math.prod(dims))
    for arch, shape in json.loads(sys.argv[2]):
        print(json.dumps(dryrun.run_cell(arch, shape, sys.argv[1],
                                         (dims, names), reduced=True)))
""")


@pytest.fixture(scope="module")
def dryrun_records():
    procs = [_start(_DRYRUN, mesh, json.dumps(
        [(a, s) for m, a, s in DRY_CELLS if m == mesh]))
        for mesh in DRY_MESHES]          # one process a mesh, side by side
    recs = {}
    for proc in procs:
        for line in _finish(proc).splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                recs[(r["mesh"], r["arch"], r["shape"])] = r
    return recs


def _jax_param_bytes(arch, dims, names):
    """Rank 0's bytes of the JAX parameters' local shards (bfloat16) at
    ``arch``'s reduced config on a mesh ``dims`` named ``names``."""
    cfg = jconfigs.get_reduced(arch)
    dp, mp = jspecs._axes(AbstractMesh(dims, names))
    size = dict(zip(names, dims))
    total = 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(
            jspecs.params_specs(cfg))[0]:
        spec = jspecs._param_spec(jax.tree_util.keystr(p), leaf, dp, mp, cfg)
        local = 1
        for d, part in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            for ax in (() if part is None else
                       part if isinstance(part, tuple) else (part,)):
                d = -(-d // size[ax])
            local *= d
        total += local * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("cell", DRY_CELLS, ids=lambda c: "-".join(c))
def test_dryrun_cell(dryrun_records, cell):
    mesh, arch, shape = cell
    rec = dryrun_records[cell]
    verdict = dict(jconfigs.cells(arch))[shape]
    if verdict == "run":
        assert rec["status"] == "ok", rec.get("trace")
        dims, names = DRY_MESHES[mesh]
        assert rec["arg_bytes"]["params"] == _jax_param_bytes(arch, dims,
                                                              names)
        assert rec["flops"] > 0
        assert rec["params_total"] == \
            jconfigs.get_reduced(arch).param_count()["total"]
    else:
        assert rec["status"] == verdict


# ---------------------------------------------------------------------------
# the train driver, resumed
# ---------------------------------------------------------------------------

def test_train_main_resumes_bit_for_bit(tmp_path):
    from repro_torch.launch import train
    handler = signal.getsignal(signal.SIGTERM)
    try:
        base = ("--arch qwen3_1_7b --reduced --batch 4 --seq 32 "
                "--save-every 2 --device cpu").split()
        straight = train.main(base + ["--steps", "4", "--ckpt-dir",
                                      str(tmp_path / "a")])
        first = train.main(base + ["--steps", "2", "--ckpt-dir",
                                   str(tmp_path / "b")])
        resumed = train.main(base + ["--steps", "4", "--ckpt-dir",
                                     str(tmp_path / "b")])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert straight["start"] == 0 and resumed["start"] == 2
    assert len(straight["losses"]) == 4
    assert first["losses"] + resumed["losses"] == straight["losses"]
    assert all(math.isfinite(x) for x in straight["losses"])
    assert straight["mesh"] is None and straight["peak_bytes"] is None
