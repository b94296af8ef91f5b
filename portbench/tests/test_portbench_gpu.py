"""On the card: one short run of each cell through the command the
benchmark's driver runs, its last line the contract's object with
``correct`` true.  ``python -m pytest -m gpu portbench/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
