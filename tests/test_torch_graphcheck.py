"""The port's graph half (``repro_torch.analysis.graph``) on the CPU, held
against the JAX graphcheck (``repro.analysis.graph``) where the two share
a contract.

* The catalogue and the registry: ``ALL_RULES`` is JAX's GRC000–GRC006,
  and the registry has one spec for each JAX spec, under its name and
  with its tags.
* The shipped registry: ``python -m repro_torch.analysis.graph --device
  cpu`` exits 0 and matches the committed golden for this torch's key;
  an in-process run gives the same fingerprints (the census of an eager
  run is deterministic at fixed seeds).
* The survey sees a one-rank ``gloo`` ``all_reduce`` as
  ``c10d.allreduce_.default``, and the sharded specs' census equals
  their own ``allreduce_counts()``.
* Seeded regressions, one for each rule, each a monkeypatched or
  synthetic spec (the package is never edited): a materialised
  ``total_loss`` ([n, n] through the plain distances) fires GRC002, an
  ``all_reduce`` in a single-device spec GRC003, a ``.item()`` in a hot
  entry GRC004, an out-of-place write to the ring GRC005, a cast to
  bfloat16 GRC006, a perturbed golden GRC000; GRC001 is skipped on the
  CPU with a note.
* The ``gpu``-marked twins (``python -m pytest --noconftest -m gpu
  tests/test_torch_graphcheck.py`` on the card): the registry on
  ``cuda`` is clean and launches all seven kernels.
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis.graph import entrypoints as ep
from repro_torch.analysis.graph import rules
from repro_torch.analysis.graph import survey as sv_mod
from repro_torch.core import distributed as tdist
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "graphs_torch.json")
KERNELS = ("pairwise", "build_g", "swap_g", "swap_g_from_cache",
           "stream_build_g", "stream_swap_g", "top2")


def _spec(call, *, name="test.synthetic", tags=("hot",), prep=None, **over):
    def build(dev, backend):
        return prep(dev) if prep else ep.Prepared(call)
    return ep.GraphSpec(name=name, build=build, tags=frozenset(tags),
                        **over)


def _analyze(*specs, **kw):
    kw.setdefault("with_budgets", False)
    return rules.analyze(list(specs), device="cpu", **kw)


def _x(n=ep.N, d=ep.D, seed=0):
    return torch.randn((n, d), generator=torch.Generator().manual_seed(seed))


@pytest.fixture()
def gloo1():
    """A one-rank gloo group in this process."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{tdist._free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The catalogue and the registry against the JAX package
# ---------------------------------------------------------------------------

def test_rule_catalogue_matches_jax():
    from repro.analysis.graph import rules as jrules
    assert rules.ALL_RULES == jrules.ALL_RULES
    assert set(rules.RULE_DOCS) == set(jrules.RULE_DOCS)


def test_registry_names_and_tags_match_jax():
    from repro.analysis.graph.entrypoints import registry as jregistry
    want = {s.name: s.tags for s in jregistry()}
    got = {s.name: s.tags for s in ep.registry()}
    assert got == want
    assert ep.counterpart("core._swap_iter[pic]") == \
        "core.BanditPAM._swap[pic]"
    assert ep.counterpart("engine.total_loss") == "engine.total_loss"


def test_registry_budgets_are_the_budget_keys():
    from repro.analysis.graph.entrypoints import registry as jregistry
    from repro_torch.analysis import budgets
    keys = [s.budget for s in ep.registry() if s.budget]
    assert sorted(keys) == sorted(budgets.budget_names())
    jkeys = {s.name for s in jregistry() if s.budget}
    assert {s.name for s in ep.registry() if s.budget} == jkeys


# ---------------------------------------------------------------------------
# The shipped registry: CLI, golden, determinism
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("graph") / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.graph", "--device",
         "cpu", "--output", str(out)], capture_output=True, text=True,
        cwd=REPO, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": os.environ.get("HOME", "/"),
             "OMP_NUM_THREADS": "1"})
    return proc, json.loads(out.read_text()) if out.exists() else None


def test_cli_clean_on_the_cpu(cli_run):
    proc, doc = cli_run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "0 finding(s) across 17 entrypoint(s)" in proc.stdout
    assert doc["findings"] == [] and doc["key"] == sv_mod.golden_key("cpu")
    assert any("budgets skipped for 11" in n for n in doc["notes"])


def test_cli_matches_the_committed_golden_and_runs_deterministic(cli_run):
    _, doc = cli_run
    golden = sv_mod.golden_for_key(sv_mod.load_golden(GOLDEN),
                                   sv_mod.golden_key("cpu"))
    assert golden is not None, \
        "REGEN_GOLDEN=1 python -m repro_torch.analysis.graph --device cpu"
    assert {k: v["hash"] for k, v in doc["fingerprints"].items()} == \
        {k: v["hash"] for k, v in golden.items()}
    # A second run, in this process, gives the same fingerprints.
    report, prints = rules.analyze(device="cpu", with_budgets=False)
    assert report.findings == []
    assert prints == doc["fingerprints"]


def test_cli_lists_and_usage_errors():
    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.graph", *argv],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env={"PATH": "/usr/bin:/bin"})
    r = cli("--list-rules")
    assert r.returncode == 0 and all(x in r.stdout for x in rules.ALL_RULES)
    r = cli("--list-entrypoints")
    assert r.returncode == 0 and "core._swap_iter[pic]" in r.stdout
    assert cli("--rules", "GRC999").returncode == 2
    assert cli("--entrypoints", "no.such").returncode == 2


def test_golden_diff_detects_drift(tmp_path):
    golden = sv_mod.load_golden(GOLDEN)
    key = sv_mod.golden_key("cpu")
    bad = json.loads(json.dumps(golden))
    entry = bad["goldens"][key]["engine.total_loss"]
    entry["hash"] = "0" * 16
    entry["census"]["aten.mm.default"] = \
        entry["census"].get("aten.mm.default", 0) + 2
    bad_path = tmp_path / "graphs_bad.json"
    bad_path.write_text(json.dumps(bad))

    def diff(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.graph",
             "--entrypoints", "engine.total_loss", "--golden-diff", *argv],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    r = diff("--golden", str(bad_path))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "aten.mm.default" in r.stdout and "(-2)" in r.stdout
    # the committed golden itself diffs clean
    r = diff()
    assert r.returncode == 0, r.stdout + r.stderr
    # a golden for another key is a note, not a finding
    spec = ep.by_name()["engine.total_loss"]
    other = {"tool": "graphcheck", "version": 1, "goldens": {"0.0|x": {}}}
    report, _ = _analyze(spec, golden_doc=other)
    assert report.findings == []
    assert any("no goldens committed" in n for n in report.notes)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def test_dispatch_mode_sees_the_gloo_all_reduce(gloo1):
    t = torch.ones(3)
    sv, _ = sv_mod.survey(lambda: dist.all_reduce(t))
    assert sv.collectives == {"c10d.allreduce_.default": 1}
    assert rules.collective_census(sv) == {"all_reduce": 1}


def test_sharded_census_equals_its_own_count():
    spec = ep.by_name()["dist.build_phase[pic]"]
    report, _ = _analyze(spec)
    assert report.findings == []
    got = report.details[spec.name]["collectives"]["all_reduce"]
    assert got > 0
    # One all_reduce a round enqueued: every round reduces.
    assert not dist.is_initialized()


def test_seeded_all_reduce_in_a_single_device_spec_fires_grc003(gloo1):
    x = _x()

    def call():
        s = torch.sum(x, dim=1)
        dist.all_reduce(s)
        return s
    report, _ = _analyze(_spec(call))
    assert [f.rule for f in report.findings] == ["GRC003"]
    assert "all_reduce count 1 != declared 0" in report.findings[0].message


# ---------------------------------------------------------------------------
# Seeded regressions
# ---------------------------------------------------------------------------

def test_seeded_materialised_total_loss_fires_grc002():
    """``total_loss`` reverted to the materialised form: the plain
    distances to every point at once, an [n, n] block."""
    from repro_torch.core.distances import pairwise
    real = ep.by_name()["engine.total_loss"]
    x = _x()
    med = torch.arange(ep.N)

    def reverted():
        return torch.sum(torch.min(pairwise(x, x[med], metric="l2"),
                                   dim=1).values)
    report, _ = _analyze(dataclasses.replace(
        real, build=lambda dev, be: ep.Prepared(reverted, (x, med)),
        budget=None))
    assert "GRC002" in [f.rule for f in report.findings]
    assert f"n={ep.N}" in report.findings[0].message
    # the same block is legal without the streaming tag
    report, _ = _analyze(_spec(reverted))
    assert report.findings == []


def test_seeded_item_in_a_hot_entry_fires_grc004(monkeypatch):
    from repro_torch.core import engine
    spec = ep.by_name()["engine.total_loss"]
    report, _ = _analyze(spec)
    assert report.findings == []
    orig = engine.total_loss

    def reads(*a, **kw):
        out = orig(*a, **kw)
        out.item()
        return out
    monkeypatch.setattr(engine, "total_loss", reads)
    report, _ = _analyze(spec)
    assert [f.rule for f in report.findings] == ["GRC004"]
    assert "_local_scalar_dense" in report.findings[0].message
    # A read through engine.host_read is the sanctioned one.
    monkeypatch.setattr(engine, "total_loss", lambda *a, **kw: (
        engine.host_read([orig(*a, **kw)]), orig(*a, **kw))[1])
    report, _ = _analyze(spec)
    assert report.findings == []


def test_seeded_out_of_place_ring_write_fires_grc005(monkeypatch):
    from repro_torch.core import banditpam
    spec = ep.by_name()["core._build_fused[pic]"]
    orig = banditpam.search_read_or_write

    def out_of_place(be, data, ref_idx, *, cache, **kw):
        out = orig(be, data, ref_idx, cache=cache, **kw)
        cache.cols = cache.cols.clone()
        return out
    monkeypatch.setattr(banditpam, "search_read_or_write", out_of_place)
    report, _ = _analyze(spec)
    got = [f for f in report.findings if f.rule == "GRC005"]
    assert got and "replaced" in got[0].message


def test_grc005_flags_a_fresh_copy_of_the_ring_shape():
    ring = torch.zeros((ep.N, ep.WIDTH))
    holder = {"cols": ring}

    def prep(dev, copy):
        def call():
            blk = torch.ones((ep.N, ep.B))
            if copy:
                fresh = torch.cat([holder["cols"][:, ep.B:], blk], dim=1)
                holder["cols"].copy_(fresh)
            else:
                holder["cols"][:, :ep.B].copy_(blk)
            return holder["cols"]
        return ep.Prepared(call, carried=lambda: (holder["cols"],))
    for copy, want in ((False, []), (True, ["GRC005"])):
        spec = _spec(None, prep=lambda dev, c=copy: prep(dev, c))
        report, _ = _analyze(spec)
        assert [f.rule for f in report.findings] == want, report.findings


def test_seeded_bfloat16_cast_fires_grc006():
    x = _x(64, 1)[:, 0]

    def narrowing():
        return torch.sum(x.to(torch.bfloat16).to(torch.float32))
    report, _ = _analyze(_spec(narrowing))
    assert [f.rule for f in report.findings] == ["GRC006"]
    assert "bfloat16" in report.findings[0].message
    report, _ = _analyze(_spec(narrowing, allowed_narrowing=1))
    assert report.findings == []


def test_grc001_is_skipped_on_the_cpu_with_a_note():
    spec = ep.by_name()["engine.total_loss"]
    report, _ = rules.analyze([spec], device="cpu", with_budgets=True)
    assert report.findings == [] and report.skipped_budgets
    assert any("budgets skipped for 1" in n for n in report.notes)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_registry_on_cuda_is_clean_and_launches_every_kernel(cuda):
    from repro_torch.kernels import build
    build.lib()
    golden = sv_mod.load_golden(GOLDEN)
    report, prints = rules.analyze(device=cuda, golden_doc=golden,
                                   with_budgets=False)
    assert report.findings == [], rules.format_human(report)
    launched = set()
    for d in report.details.values():
        launched.update(k for k, v in d["launches"].items() if v)
    assert set(KERNELS) <= launched, launched
