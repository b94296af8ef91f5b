"""The port's static analyzer (``repro_torch.analysis``: tracecheck and the
import report) against the live JAX analyzer (``repro.analysis``).

* The rule catalogue: the port's ``RULE_DOCS`` has the JAX ids.
* The torch fixture corpus ``tests/fixtures/tracecheck_torch/`` mirrors
  ``tests/fixtures/tracecheck/`` file for file, each bug written in
  PyTorch: for each bad file the set of rules the port fires equals the
  set the JAX engine fires on its JAX twin, run live; the clean corpus
  has no findings in either engine; a bare suppression gives TRC000 and
  a justified one is silent, in both.
* The shipped tree: ``python -m repro_torch.analysis repro_torch`` and
  ``--imports --check-quarantine`` exit 0, every suppression carries a
  reason, and the static CLI loads neither torch, jax nor ``repro``.
* The import report: every module with a counterpart in both packages
  has the JAX twin's class, but the exceptions listed with their reasons.
* Seeded regressions, each on a copy under ``tmp_path`` (the package is
  never edited): a ``.item()`` in a round fires TRC001, a Python loop
  TRC002, a global-generator draw TRC003, an ``all_reduce`` inside a
  stats backend TRC004, TF32 turned on TRC005.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import config as jcfg_mod
from repro.analysis import engine as jengine
from repro.analysis import imports as jimports
from repro.analysis import rules as jrules
from repro_torch.analysis import config as cfg_mod
from repro_torch.analysis import engine, imports, rules

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "repro_torch"
CORPUS = Path(__file__).parent / "fixtures" / "tracecheck_torch"
JCORPUS = Path(__file__).parent / "fixtures" / "tracecheck"

ALL_RULES = ("TRC000", "TRC001", "TRC002", "TRC003", "TRC004", "TRC005")
BAD = sorted(str(p.relative_to(CORPUS / "bad"))
             for p in (CORPUS / "bad").rglob("*.py"))
CLEAN = sorted(str(p.relative_to(CORPUS / "clean"))
               for p in (CORPUS / "clean").rglob("*.py"))

# Modules whose class differs from the JAX twin's, with the reason.
IMPORT_EXCEPTIONS = {
    # serve.service restores a service onto a mesh through
    # distributed.sharding.to_local_full, which loads the package front
    # and distributed.compression (config.LIVE_IN_PORT).
    "distributed": ("test-only", "live"),
    "distributed.compression": ("test-only", "live"),
    "distributed.sharding": ("test-only", "live"),
    # The JAX wrappers import their references from kernels/ref.py; the
    # port keeps each plain version beside its kernel, and ref.py serves
    # the card's kernel tests only.
    "kernels.ref": ("live", "test-only"),
    # The JAX launchers are scripts nothing imports; the port's tests and
    # chip_smoke.py import or run them.
    "launch.dryrun": ("dead", "test-only"),
    "launch.serve": ("dead", "test-only"),
    "launch.train": ("dead", "test-only"),
}


def _run(path, config=None):
    return engine.run([str(path)], config or cfg_mod.default_config())


def _jrun(path):
    return jengine.run([str(path)], jcfg_mod.default_config())


# ---------------------------------------------------------------- static

def test_rule_catalogue_matches_jax():
    assert set(rules.RULE_DOCS) == set(jrules.RULE_DOCS) == set(ALL_RULES)
    assert [r.rule_id for r in rules.ALL_RULES] == \
        [r.rule_id for r in jrules.ALL_RULES]


def test_corpus_mirrors_the_jax_corpus():
    jbad = sorted(str(p.relative_to(JCORPUS / "bad"))
                  for p in (JCORPUS / "bad").rglob("*.py"))
    jclean = sorted(str(p.relative_to(JCORPUS / "clean"))
                    for p in (JCORPUS / "clean").rglob("*.py"))
    assert BAD == jbad and CLEAN == jclean


@pytest.mark.parametrize("rel", BAD)
def test_bad_file_fires_the_jax_twins_rules(rel):
    port = _run(CORPUS / "bad" / rel)
    jax = _jrun(JCORPUS / "bad" / rel)
    assert set(port.counts) == set(jax.counts), (rel, port.counts, jax.counts)
    assert port.findings and all(f.line > 0 for f in port.findings)
    assert port.suppressed == jax.suppressed


@pytest.mark.parametrize("rel", CLEAN)
def test_clean_file_has_no_findings_in_either_engine(rel):
    port = _run(CORPUS / "clean" / rel)
    jax = _jrun(JCORPUS / "clean" / rel)
    assert port.findings == [] and jax.findings == []
    assert port.suppressed == jax.suppressed


def test_bad_corpus_fires_every_rule():
    report = _run(CORPUS / "bad")
    assert set(report.counts) == set(ALL_RULES)


def test_host_orchestration_is_not_flagged():
    # hot_loop.host_driver reads and loops freely: it is not reachable.
    report = _run(CORPUS / "bad" / "core" / "hot_loop.py")
    assert not any(f.function == "host_driver" for f in report.findings)
    assert {f.function for f in report.findings} == {"_Search.round",
                                                     "loop_body"}


def test_bare_suppression_suppresses_but_raises_trc000():
    for rep in (_run(CORPUS / "bad" / "core" / "suppressed.py"),
                _jrun(JCORPUS / "bad" / "core" / "suppressed.py")):
        assert [f.rule for f in rep.findings] == ["TRC000"]
        assert rep.suppressed == 1


def test_justified_suppression_is_silent():
    for rep in (_run(CORPUS / "clean" / "core" / "engine.py"),
                _jrun(JCORPUS / "clean" / "core" / "engine.py")):
        assert rep.findings == []
        assert rep.suppressed == 1


def test_json_report_schema_is_the_jax_one():
    doc = engine.report_to_json(_run(CORPUS / "bad"))
    jdoc = jengine.report_to_json(_jrun(JCORPUS / "bad"))
    assert set(doc) == set(jdoc)
    assert doc["tool"] == "tracecheck" and doc["version"] == 1
    assert sum(doc["counts"].values()) == len(doc["findings"])
    for f in doc["findings"]:
        assert set(f) == set(jdoc["findings"][0])
        assert f["rule"] in ALL_RULES
    json.dumps(doc)


def test_shipped_tree_is_clean_and_every_suppression_has_a_reason():
    report = _run(PKG)
    assert report.findings == [], "\n" + engine.format_human(report)
    assert report.suppressed > 0
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            m = engine.SUPPRESS_RE.search(line)
            if m:
                assert m.group(2), (path, line)


# ------------------------------------------------------------------ CLI

def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env={"PATH": "/usr/bin:/bin"})


def test_cli_zero_on_shipped_tree():
    proc = _cli("repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_quarantine_check_passes():
    proc = _cli("--imports", "--check-quarantine")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("import graph:")


def test_cli_nonzero_on_violations_and_json(tmp_path):
    out = tmp_path / "report.json"
    proc = _cli(str(CORPUS / "bad"), "--format", "json", "--output",
                str(out))
    assert proc.returncode == 1, proc.stderr
    doc = json.loads(proc.stdout)
    assert set(doc["counts"]) == set(ALL_RULES)
    assert json.loads(out.read_text()) == doc


def test_cli_rule_filter_list_and_usage_errors():
    proc = _cli(str(CORPUS / "bad"), "--rules", "TRC004")
    assert proc.returncode == 1
    assert "TRC004" in proc.stdout and "TRC001" not in proc.stdout
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in ALL_RULES:
        assert rid in proc.stdout
    assert _cli("--rules", "TRC999").returncode == 2
    assert _cli("no/such/path").returncode == 2


def test_static_cli_loads_no_torch_jax_or_reference_package():
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['repro_torch'])\n"
            "rc2 = main(['--imports', '--check-quarantine'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print('LOADED', bad, rc, rc2)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED [] 0 0"


# --------------------------------------------------------- import graph

@pytest.fixture(scope="module")
def import_reports():
    return (imports.build_report(str(REPO), cfg_mod.default_config()),
            jimports.build_report(str(REPO), jcfg_mod.default_config()))


def test_import_classes_match_the_jax_twins(import_reports):
    port, jax = import_reports
    shared = 0
    for jname, info in jax.items():
        pname = "repro_torch" + jname[len("repro"):]
        if pname not in port:
            continue
        shared += 1
        rel = pname[len("repro_torch."):]
        want = info["status"]
        if rel in IMPORT_EXCEPTIONS:
            assert IMPORT_EXCEPTIONS[rel] == (want, port[pname]["status"]), \
                rel
        else:
            assert port[pname]["status"] == want, (pname, want,
                                                   port[pname]["status"])
    assert shared > 60


def test_quarantine_contract_holds(import_reports):
    port, _ = import_reports
    cfg = cfg_mod.default_config()
    assert imports.check_quarantine(port, cfg) == ([], [])
    for mod in ("repro_torch.api.estimator", "repro_torch.core.banditpam",
                "repro_torch.runtime.checkpoint", "repro_torch.analysis.guard",
                "repro_torch.analysis.budgets",
                "repro_torch.analysis.graph.survey"):
        assert port[mod]["status"] == "live", mod
    for mod in ("repro_torch.models.model", "repro_torch.train.train_step",
                "repro_torch.serve.lm", "repro_torch.runtime.fault",
                "repro_torch.train.curated"):
        assert port[mod]["status"] != "live" and mod in cfg.quarantine, mod


def test_import_walk_skips_build_copies(import_reports):
    port, _ = import_reports
    assert all(not info["path"].startswith("build/")
               for info in port.values())
    assert all(m == "repro_torch" or m.startswith("repro_torch.")
               for m in port)


# ---------------------------------------------------- seeded regressions

def _copy(tmp_path, rel, old, new):
    """``repro_torch/<rel>`` copied to ``tmp_path/<rel>`` with ``old``
    replaced by ``new`` (once)."""
    src = (PKG / rel).read_text()
    assert src.count(old) == 1, (rel, old)
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(src.replace(old, new))
    return dst


def test_seeded_item_in_a_round_fires_trc001(tmp_path):
    old = "        self.running = going\n        return pilot\n"
    path = _copy(tmp_path, "core/adaptive.py", old,
                 "        self.running = going\n"
                 "        _ = self.done.item()\n        return pilot\n")
    hits = [f for f in _run(path).findings if f.rule == "TRC001"]
    assert [f.function for f in hits] == ["_Search.round"]
    assert _run(PKG / "core" / "adaptive.py").findings == []


def test_seeded_loop_in_a_backend_fires_trc002(tmp_path):
    old = ("    def build_stats_from_d(self, dxy, dnear_b, w, lead):\n"
           "        self._ops(dxy)\n")
    path = _copy(tmp_path, "core/engine.py", old,
                 old + "        for _ in range(3):\n"
                 "            dxy = dxy + 0.0\n")
    hits = [f for f in _run(path).findings if f.rule == "TRC002"]
    assert [f.function for f in hits] == \
        ["CudaStatsBackend.build_stats_from_d"]


def test_seeded_global_draw_fires_trc003(tmp_path):
    path = tmp_path / "core" / "draws.py"
    path.parent.mkdir(parents=True)
    path.write_text("import torch\n\n\ndef resample(n, gen):\n"
                    "    keep = torch.randperm(n, generator=gen)\n"
                    "    return keep[torch.randperm(n)]\n")
    hits = _run(path).findings
    assert [(f.rule, f.line) for f in hits] == [("TRC003", 6)]


def test_seeded_collective_in_a_backend_fires_trc004(tmp_path):
    old = ("        return torch.sum(g, dim=1), torch.sum(g * g, dim=1), "
           "cross\n")
    path = _copy(tmp_path, "core/engine.py", old,
                 "        s = torch.sum(g, dim=1)\n"
                 "        torch.distributed.all_reduce(s)\n"
                 "        return s, torch.sum(g * g, dim=1), cross\n")
    hits = [f for f in _run(path).findings if f.rule == "TRC004"]
    assert len(hits) == 1 and hits[0].function == "TorchStatsBackend"


def test_seeded_tf32_fires_trc005(tmp_path):
    path = tmp_path / "launch" / "fast.py"
    path.parent.mkdir(parents=True)
    path.write_text(
        "import torch\n\n\ndef fast():\n"
        "    torch.backends.cuda.matmul.allow_tf32 = True\n"
        "    torch.set_float32_matmul_precision('high')\n"
        "    torch.backends.cudnn.allow_tf32 = False\n"
        "    torch.set_float32_matmul_precision('highest')\n")
    hits = _run(path).findings
    assert [(f.rule, f.line) for f in hits] == [("TRC005", 5),
                                                ("TRC005", 6)]
