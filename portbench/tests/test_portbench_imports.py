"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package: compared whole, since the port's
name begins with it), and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "out, run = harness.run_cell(harness.Bench(), 'scrna68k_l1_k5.fit',"
        " 3, 0.2, True, time.perf_counter(), device='cpu',"
        " overrides={'n': 600})\n"
        "print(json.dumps({'bad': harness.loaded_forbidden(),"
        " 'mods': sorted({m.split('.')[0] for m in sys.modules}),"
        " 'correct': out['correct']}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["correct"]
    assert "repro_torch" in got["mods"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["mods"])


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert harness.loaded_forbidden() == ["repro"]


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax",
                    "portbench"), (path.name, name)


def test_bare_checkout_gives_no_result(tmp_path):
    """A directory with only the manifest and the benchmark's files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mnist70k_l2_k10.fit", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
