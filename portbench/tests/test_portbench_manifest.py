"""``BENCHMARK.json`` against the benchmark's contract: its keys, every
name, unit and text against the allowed characters, and every file and
cell it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|"
                    r"expansion|_dim$|_rank$|per_tok)")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    assert all(_text(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for w in M["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"]), w
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"])
        assert _text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
        assert c["name"] in used


def test_workloads():
    cells = M["workloads"]
    assert 1 <= len(cells) <= 24
    configs = {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _text(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json"
                ).is_file()


def test_metrics():
    e2e, layer = M["end_to_end"], M["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in M["workloads"]}
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _text(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_enough(cell):
    def mine(ms):
        return [m for m in ms if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in mine(M["end_to_end"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mine(M["per_layer"])
    assert layer and all(m["moves"] in e2e for m in layer)
