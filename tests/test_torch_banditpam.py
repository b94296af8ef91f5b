"""The port's BanditPAM fit and KMedoids facade held against the JAX
package on the CPU, with the JAX chain's reference permutations injected
through the layout seam (``repro_torch.convert``).

Medoids, swap history, ledger, build rounds, swap count and convergence
must be equal; losses agree to rtol 1e-5 (float32 summation order of the
final loss sum).  Inputs are ``mnist_like`` data made with numpy.
"""

import ast
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KMedoids as JKMedoids
from repro.api import predict as jpredict
from repro.core import BanditPAM as JBanditPAM
from repro.core import datasets as jdatasets
from repro.core.banditpam import _batch_perms, _batch_rng_chains
from repro_torch import convert
from repro_torch.api import KMedoids, assign_medoids, predict
from repro_torch.core import BanditPAM, datasets, rng
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = [(300, 3, "l2"), (650, 5, "l2"), (650, 4, "l1")]


@functools.lru_cache(maxsize=None)
def _chain(seed: int, k: int, T: int):
    """The JAX fit's key chain (``_batch_rng_chains`` for one seed), split
    by split as the single-fit driver walks it: the search subkeys
    ``subs`` [k + T, 2] and their perm-keys ``split(sub)[1]``.  The jitted
    ``_batch_rng_chains`` unrolls the k + T splits, a compile of ~25 s at
    k = 65; these are the same bits
    (``test_chain_equals_the_batch_chain``), computed op by op and kept
    for the process."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    subs = []
    for _ in range(k + T):
        key, sub = jax.random.split(key)
        subs.append(sub)
    subs = jnp.stack(subs)
    pkeys = jax.vmap(lambda s: jax.random.split(s)[1])(subs)
    return subs, pkeys


def jax_layouts(seed: int, n: int, k: int):
    """The JAX fit's per-search permutations: k BUILD, 4k+10 SWAP."""
    _, pkeys = _chain(seed, k, 4 * k + 10)
    return (np.asarray(_batch_perms(pkeys[:k], n=n)),
            np.asarray(_batch_perms(pkeys[k:], n=n)))


@functools.partial(jax.jit, static_argnames=("n", "batch_size", "n_rounds"))
def _draw_rounds(keys, *, n: int, batch_size: int, n_rounds: int):
    def one(key):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (batch_size,), 0, n)
        return jax.lax.scan(body, key, None, length=n_rounds)[1]
    return jax.vmap(one)(keys)


def jax_draws(seed: int, n: int, k: int, batch_size: int = 100):
    """The JAX fit's replacement draws, [k, R, B] BUILD and [T, R, B]
    SWAP with R = ceil(n/B): search s (key ``subs[s]`` of the chain)
    draws round r as ``key, sub = split(key); randint(sub, (B,), 0, n)``.
    """
    subs, _ = _chain(seed, k, 4 * k + 10)
    kw = dict(n=n, batch_size=batch_size, n_rounds=-(-n // batch_size))
    return (np.asarray(_draw_rounds(subs[:k], **kw)),
            np.asarray(_draw_rounds(subs[k:], **kw)))


@pytest.mark.parametrize("seed,k", [(0, 3), (7, 5)])
def test_chain_equals_the_batch_chain(seed, k):
    """``_chain`` gives ``_batch_rng_chains``' subkeys and perm-keys bit
    for bit (the layouts and draws the parity tests replay)."""
    T = 4 * k + 10
    _, bsub, ssub, bpk, spk = _batch_rng_chains(jnp.asarray([seed]), k=k,
                                                T=T)
    subs, pkeys = _chain(seed, k, T)
    np.testing.assert_array_equal(np.asarray(subs),
                                  np.concatenate([bsub[0], ssub[0]]))
    np.testing.assert_array_equal(np.asarray(pkeys),
                                  np.concatenate([bpk[0], spk[0]]))


def _same_fit(got, want):
    assert got.medoids.tolist() == np.asarray(want.medoids).tolist()
    assert ([h[:2] for h in got.swap_history]
            == [tuple(h[:2]) for h in want.swap_history])
    assert got.evals_by_phase == want.evals_by_phase
    assert got.build_rounds == want.build_rounds
    assert got.n_swaps == want.n_swaps
    assert got.converged == want.converged
    assert got.distance_evals == want.distance_evals
    assert abs(got.loss - want.loss) <= 1e-5 * abs(want.loss)
    for (_, _, lg), (_, _, lw) in zip(got.swap_history, want.swap_history):
        assert abs(lg - lw) <= 1e-5 * abs(lw)


@pytest.mark.parametrize("n,k,metric", FIXTURES)
def test_fit_matches_jax_reference(n, k, metric):
    X = jdatasets.mnist_like(n, seed=1)
    want = JBanditPAM(k, metric=metric, seed=0, backend="jnp").fit(X)
    layouts = convert.layouts_from_reference(*jax_layouts(0, n, k))
    got = BanditPAM(k, metric=metric, device="cpu").fit(X, layouts=layouts)
    _same_fit(got, want)
    assert got.wall_by_phase.keys() == {"build", "swap"}


def test_kmedoids_labels_predict_transform_match_jax():
    n, k = 300, 3
    X = jdatasets.mnist_like(n, seed=1)
    Q = jdatasets.mnist_like(120, seed=9)
    jest = JKMedoids(k=k, solver="banditpam", metric="l2", seed=0,
                     backend="jnp", predict_backend="jnp").fit(X)
    est = KMedoids(k=k, solver="banditpam", metric="l2", device="cpu").fit(
        X, layouts=convert.layouts_from_reference(*jax_layouts(0, n, k)))
    assert est.medoids_.tolist() == jest.medoids_.tolist()
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    assert est.report_.labels is est.labels_
    assert abs(est.loss_ - jest.loss_) <= 1e-5 * abs(jest.loss_)
    # predict/transform on medoids carried over from the JAX fit
    ref = KMedoids.from_fitted(X, jest.medoids_, "l2", device="cpu")
    t = ref.transform(Q)
    jt = jest.transform(Q)
    np.testing.assert_allclose(t, jt, rtol=1e-5, atol=1e-5 * np.abs(jt).max())
    np.testing.assert_array_equal(ref.predict(Q), jest.predict(Q))
    np.testing.assert_array_equal(ref.labels_, jest.labels_)
    assert abs(ref.loss_ - jest.loss_) <= 1e-5 * abs(jest.loss_)


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "l2sq"])
def test_assign_and_distances_match_jax(metric):
    X = jdatasets.mnist_like(200, seed=4)
    med = X[[3, 50, 77, 120]]
    jl, jd = jpredict.assign_medoids(X, jnp.asarray(med), metric,
                                     backend="jnp")
    tl, td = assign_medoids(X, med, metric, device="cpu")
    np.testing.assert_array_equal(tl, jl)
    jm = jpredict.medoid_distances(X, jnp.asarray(med), metric,
                                   backend="jnp", chunk=64)
    tm = predict.medoid_distances(X, med, metric, device="cpu", chunk=64)
    # rtol 1e-5 plus atol 1e-5·max|d|; for l2 the medoid rows' own
    # distance is the square root of l2sq summation noise (worst case
    # d·2^-24 relative over d features), hence the extra term.
    dmax = float(np.abs(jm).max())
    atol = 1e-5 * dmax
    if metric == "l2":
        atol += np.sqrt(X.shape[1] * 2.0 ** -24) * dmax
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=atol)


def test_datasets_copy_is_bit_identical():
    np.testing.assert_array_equal(datasets.mnist_like(257, seed=3, d=40),
                                  jdatasets.mnist_like(257, seed=3, d=40))


def test_default_device_is_the_card():
    """device=None means CUDA; without a card every entry point raises."""
    X = datasets.mnist_like(50, seed=0, d=16)
    if torch.cuda.is_available():
        est = KMedoids(k=2).fit(X)
        assert est._medoid_points.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BanditPAM(2).fit(X)
    with pytest.raises(RuntimeError, match="CUDA"):
        KMedoids(k=2).fit(X)
    with pytest.raises(RuntimeError, match="CUDA"):
        assign_medoids(X, X[:2], "l2")
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.medoid_distances(X, X[:2], "l2")
    with pytest.raises(RuntimeError, match="CUDA"):
        KMedoids.from_fitted(X, [0, 1])


def test_cuda_backend_refuses_cpu_tensors():
    X = datasets.mnist_like(50, seed=0, d=16)
    with pytest.raises(ValueError, match="CUDA device"):
        BanditPAM(2, backend="cuda", device="cpu").fit(X)
    with pytest.raises(KeyError):
        BanditPAM(2, backend="nope", device="cpu").fit(X)


@pytest.mark.parametrize("kw", [
    {"warm_start": [0, 1, 2]}, {"solver": "banditpam_dist"},
])
def test_unported_knobs_raise(kw):
    """The facade's knobs raise as the JAX package's do, and the sharded
    solver, the last one ported, fits (the metrics "precomputed" and
    callables are ported: ``tests/test_torch_metrics.py``).
    ``warm_start`` is no facade knob in the JAX package either: its
    registry hands it to the ``BanditPAM`` constructor, which raises
    ``TypeError``, and the port raises the same (a warm start goes
    through ``BanditPAM.fit`` and the serving layer)."""
    X = datasets.mnist_like(40, seed=0, d=16)
    if "warm_start" in kw:
        with pytest.raises(TypeError) as want:
            JKMedoids(3, **kw).fit(X)
        with pytest.raises(TypeError) as got:
            KMedoids(3, device="cpu", **kw).fit(X)
        assert str(got.value) == str(want.value)
        assert "unexpected keyword argument 'warm_start'" in str(got.value)
        return
    est = KMedoids(3, device="cpu", **kw).fit(X)
    assert est.report_.solver == "banditpam_dist"
    assert est.labels_.shape == (40,) and len(set(est.medoids_)) == 3


@pytest.mark.parametrize("solver", ["banditpam_dist"])
def test_unported_solvers_raise(solver):
    """No solver of the JAX registry raises any more: the sharded fit on
    one shard (no process group) gives the JAX facade's medoids on a
    one-device mesh (``tests/test_torch_distributed.py`` holds it at 1, 2
    and 4 shards)."""
    X = datasets.mnist_like(40, seed=0, d=16)
    got = KMedoids(k=2, solver=solver, device="cpu").fit(X)
    want = JKMedoids(k=2, solver=solver, backend="jnp").fit(X)
    assert got.medoids_.tolist() == np.asarray(want.medoids_).tolist()
    np.testing.assert_array_equal(got.labels_, np.asarray(want.labels_))


def test_unported_entry_points_raise():
    """``fit_batch`` on the sharded solver raises the JAX package's
    ``ValueError`` (neither package has a batched sharded fit), and
    unknown names raise ``KeyError`` through both entry points."""
    X = datasets.mnist_like(40, seed=0, d=16)
    with pytest.raises(ValueError) as want:
        JKMedoids(k=2, solver="banditpam_dist").fit_batch([X, X])
    with pytest.raises(ValueError) as got:
        KMedoids(k=2, solver="banditpam_dist", device="cpu").fit_batch([X, X])
    assert str(got.value) == str(want.value)
    assert "has no batched entrypoint" in str(got.value)
    with pytest.raises(KeyError):
        KMedoids(k=2, solver="nope", device="cpu").fit(X)
    with pytest.raises(KeyError):
        KMedoids(k=2, solver="nope", device="cpu").fit_batch([X, X])


def test_seed_layouts_are_seeded_permutations_in_any_order():
    X = datasets.mnist_like(220, seed=0, d=16)
    a = BanditPAM(3, seed=5, device="cpu").fit(X)
    b = BanditPAM(3, seed=5, device="cpu").fit(X)
    assert a.medoids.tolist() == b.medoids.tolist()
    assert a.evals_by_phase == b.evals_by_phase
    # Every search owns its key: a permutation of [0, n), the same
    # whichever search asks first.
    src = rng.from_seed(0, "cpu", 3)
    late = src.build_perm(2, 10).tolist()
    assert sorted(late) == list(range(10))
    again = rng.from_seed(0, "cpu", 3)
    firsts = [again.build_perm(i, 10).tolist() for i in range(3)]
    assert firsts[2] == late
    assert all(sorted(p) == list(range(10)) for p in firsts)
    assert src.swap_perm(0, 10).tolist() == again.swap_perm(0, 10).tolist()
    with pytest.raises(ValueError, match="3 BUILD searches"):
        src.build_perm(3, 10)


def test_array_layouts_validate():
    with pytest.raises(ValueError, match="permutations"):
        convert.layouts_from_reference(np.zeros((2, 5), int),
                                       np.zeros((2, 5), int))
    src = rng.from_numpy(np.tile(np.arange(5), (2, 1)),
                         np.tile(np.arange(5), (1, 1)))
    with pytest.raises(ValueError, match="only 1"):
        src.swap_perm(1, 5)
    with pytest.raises(ValueError, match="has 6"):
        src.build_perm(0, 6)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference_package():
    """Nor ``msgpack``, which the card's machine does not have (the
    port's checkpoint manifest is JSON)."""
    files = (sorted((ROOT / "repro_torch").rglob("*.py"))
             + sorted(ROOT.glob("chip_*.py")))
    assert len(files) > 15
    for script in ("chip_smoke.py", "chip_ab.py", "chip_sync_probe.py",
                   "chip_lm_spread.py", "chip_fit_ab.py", "chip_logdiff.py"):
        assert ROOT / script in files
    assert ROOT / "repro_torch" / "core" / "batch.py" in files
    assert ROOT / "repro_torch" / "core" / "distributed.py" in files
    assert ROOT / "repro_torch" / "core" / "tuning.py" in files
    assert ROOT / "repro_torch" / "analysis" / "guard.py" in files
    assert ROOT / "repro_torch" / "analysis" / "budgets.py" in files
    assert ROOT / "repro_torch" / "analysis" / "graph" / "survey.py" in files
    for lm in ("configs/base.py", "configs/qwen3_1_7b.py", "models/layers.py",
               "models/model.py", "models/moe.py", "models/ssm.py",
               "train/data.py", "train/optimizer.py",
               "train/train_step.py", "train/curated.py", "runtime/fault.py",
               "serve/lm.py", "launch/serve.py", "core/datasets.py",
               "distributed/compression.py", "train/compressed.py"):
        assert ROOT / "repro_torch" / lm in files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "msgpack"), (f, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.analysis, repro_torch.api, "
            "repro_torch.convert, repro_torch.kernels.ops, repro_torch.serve, "
            "repro_torch.configs, repro_torch.models, repro_torch.train, "
            "repro_torch.train.curated, repro_torch.runtime.fault, "
            "repro_torch.serve.lm, repro_torch.launch.serve, "
            "repro_torch.core.datasets, repro_torch.distributed.compression, "
            "repro_torch.train.compressed; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')]; print(bad); "
            "sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# Names of the JAX package's ``__all__`` lists that have no counterpart in
# the port, each with its reason.
JIT_ONLY = {
    # The metrics with a Pallas kernel; the port's are
    # ``repro_torch.kernels.ops.KERNEL_METRICS``.
    "PALLAS_METRICS",
}


@pytest.mark.parametrize("module", ["api", "core", "configs", "train"])
def test_public_names_match_the_jax_package(module):
    """Every public name of ``repro.api`` / ``repro.core`` (and of the LM
    substrate's ``repro.configs`` / ``repro.train``) is public in the
    port too, but the jit-only ones (``JIT_ONLY``)."""
    import importlib
    want = set(importlib.import_module(f"repro.{module}").__all__)
    port = importlib.import_module(f"repro_torch.{module}")
    got = set(port.__all__)
    assert want - JIT_ONLY <= got, sorted(want - JIT_ONLY - got)
    assert all(hasattr(port, name) for name in got)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_fit_predict_matches_jax(metric):
    X = datasets.mnist_like(300, seed=4, d=16)
    got = BanditPAM(3, metric=metric, seed=2, device="cpu").fit_predict(X)
    want = JBanditPAM(3, metric=metric, seed=2,
                      backend="jnp").fit_predict(X)
    assert got.dtype == np.int32 and got.shape == (300,)
    np.testing.assert_array_equal(got, np.asarray(want))
