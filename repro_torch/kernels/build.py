"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface, so they are compiled
by ``nvcc`` alone (no PyTorch headers) into one shared library and
loaded with ``ctypes``:

* every ``*.cu`` compiles to an object file in its own ``nvcc`` process,
  all started together, for ``sm_90a`` with ``-Xptxas -v``;
* one more ``nvcc`` call links them into ``libreprotorch_<hash>.so``
  under ``build/repro_torch/`` at the repository root.

The file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the library already built.
The build happens at first use, never at import.  Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

# C signatures: pointers and the stream are c_void_p, sizes c_int64/c_int.
# Every entry but rt_top2 takes a run flag (``const int*``, NULL: run)
# before the stream; rt_pairwise also takes its output's row stride after
# the column count.  The swap_g kernel's entries (rt_swap_g, its lane form
# and rt_stream_swap_g) take their bin scratch (``float*``, NULL where
# rt_swap_g_scratch gives 0) and its size in floats after the run flag:
# no entry allocates device memory.
SIGNATURES = {
    "rt_pairwise": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _P, _P],
    "rt_build_g": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P,
                   _P],
    "rt_swap_g": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                  _I, _P, _P, _I64, _P],
    "rt_swap_g_from_cache": [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                             _I64, _I, _P, _P],
    "rt_top2": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P],
    "rt_stream_build_g": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                          _P, _P],
    "rt_stream_swap_g": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                         _I, _I, _I, _P, _P, _I64, _P],
    # The lane axis (fit_batch): (lanes, n_pad) after the outputs, the
    # per-lane row counts (``const int*``) and, for the round kernels, the
    # per-lane run flags before the stream.
    "rt_build_g_lanes": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I,
                         _I, _P, _P, _P],
    "rt_swap_g_lanes": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _I64, _I, _I, _I, _P, _P, _P, _I64, _P],
    "rt_top2_lanes": [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P, _P],
    # The PIC batch's two: per-lane extents, output or input column
    # offsets (``const int64_t*``) and run flags before the stream.
    "rt_pairwise_lanes": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I,
                          _P, _P, _P, _P, _P],
    "rt_swap_g_from_cache_lanes": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _I64, _I64, _I64, _I, _P, _P,
                                   _P],
}

# Every launching entry has a ``_tiled`` twin that takes the tile shape's
# index (``int``, ``repro_torch.core.tuning``'s tables) before the
# stream; an index the library was not built with returns
# cudaErrorInvalidValue.  The entries above keep the shapes they have
# always chosen.  The port calls the twins only.
SIGNATURES.update({f"{name}_tiled": args[:-1] + [_I, _P]
                   for name, args in list(SIGNATURES.items())})
# Shape queries, one a kernel: (shape, k, int info[4]) fills the shape's
# rows, columns, threads and blocks an SM (the occupancy calculator's, at
# the launch's shared memory for k clusters; l2).
SHAPE_KERNELS = ("pairwise", "build_g", "swap_g", "stream_build_g",
                 "stream_swap_g", "top2", "swap_g_from_cache")
SIGNATURES.update({f"rt_{name}_shape": [_I, _I, _P]
                   for name in SHAPE_KERNELS})
# The swap_g kernel's bin scratch in floats: (m, r, k, period, metric,
# lanes, shape, int64_t* floats).
SIGNATURES["rt_swap_g_scratch"] = [_I64, _I64, _I, _I64, _I, _I64, _I, _P]

_lib: Optional[ctypes.CDLL] = None
# What the last build did: seconds per step and nvcc's -Xptxas -v report.
build_info: Dict[str, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the kernels if the library for these sources is missing;
    return its path."""
    so = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if so.exists() and not force:
        build_info.setdefault("cached", True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{so.stem}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas = {}
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        ptxas[src.name] = out
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    t1 = time.perf_counter()
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp)]
        + [str(obj) for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    build_info.update(cached=False, compile_s=t1 - t0,
                      link_s=time.perf_counter() - t1, ptxas=ptxas)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
