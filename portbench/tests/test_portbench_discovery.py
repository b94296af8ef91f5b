"""A configuration, a traffic mix and a per-layer metric added as new
files, with their entries in the manifest, are found by name: the run
reports the new metric with no file of the harness edited."""

import json
import shutil
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "scrna68k_l1_k5.json").read_text())
    cfg.update(name="scrna_small_l1_k3", n=900, k=3)
    (pb / "configs" / "scrna_small_l1_k3.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "fit.json").read_text())
    mix["checked_fits"] = 1
    (pb / "traffic" / "fit_once.json").write_text(json.dumps(mix))
    (pb / "metrics" / "swaps_per_fit.py").write_text(
        "def read(run):\n"
        "    return sum(f.report.n_swaps for f in run.fits) / len(run.fits)\n")
    (pb / "limits" / "scrna_small_l1_k3.fit_once.json").write_text(
        (pb / "limits" / "scrna68k_l1_k5.fit.json").read_text())
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "scrna_small_l1_k3", "source": "a test",
                         "file": "portbench/configs/scrna_small_l1_k3.json",
                         "reduced": ["n", "k"]})
    m["workloads"].append({"name": "scrna_small_l1_k3.fit_once",
                           "config": "scrna_small_l1_k3",
                           "traffic": "fit_once", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "swaps_per_fit", "unit": "swaps",
                           "better": "lower", "source": "program_counter",
                           "layer": "driver", "moves": "fit_s",
                           "workloads": ["scrna_small_l1_k3.fit_once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    bench = harness.Bench(tmp_path)
    out, run = harness.run_cell(bench, "scrna_small_l1_k3.fit_once", 5, 0.2,
                                True, time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert run.config["n"] == 900 and run.mix["checked_fits"] == 1
    assert "swaps_per_fit" in out["metrics"]
    assert out["metrics"]["swaps_per_fit"]["unit"] == "swaps"
