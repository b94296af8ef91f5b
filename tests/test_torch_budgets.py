"""The port's peak-memory budgets (``repro_torch.analysis.budgets``)
against the JAX package's declarations (``repro.analysis.graph.budgets``)
on the CPU; the measures themselves run on the card
(``tests/test_torch_cuda_guard.py``, ``chip_smoke.py`` phase 11).

* every key has a doc and a canonical shape;
* every key carried over from the JAX package (``counterpart``) has the
  JAX bound at the canonical shape and at two other shape points, plus
  the bytes of the buffer the port names (``card_buffer_bytes``: the
  swap_g kernel's bin scratch) where it holds one;
* every key's materialised form, computed from the shapes, overshoots
  its bound, at the canonical shape and at the other points;
* the scratch formula is the kernel's (swap_g.cu), and the measure
  refuses to run without a card.
"""

import pytest

from repro.analysis.graph import budgets as jbudgets
from repro.core.engine import _EXACT_CHUNK
from repro_torch.analysis import budgets
from repro_torch.core import tuning

KEYS = budgets.budget_names()
SHARED = [k for k in KEYS if budgets.counterpart(k) is not None]
# Two shape points besides the canonical one, each over the keys' own
# dims (a smaller and a larger n or rows, another k where the key has
# one).
OTHER_POINTS = [{"n": 50_000, "rows": 1024, "k": 16, "m": 128},
                {"n": 1_000_003, "rows": 300_000, "k": 1000, "m": 4096}]


def _point(name, pt):
    dims = budgets.shape_for(name)
    return {k: v for k, v in pt.items() if k in dims}


@pytest.mark.parametrize("name", KEYS)
def test_every_key_has_a_doc_and_a_shape(name):
    assert budgets.budget_doc(name)
    assert budgets.materialised_doc(name)
    shape = budgets.shape_for(name)
    assert shape and all(isinstance(v, int) and v > 0
                         for v in shape.values())
    assert budgets.budget_bytes(name) > 0
    if budgets.card_buffer_bytes(name):
        assert "scratch" in budgets.budget_doc(name)


@pytest.mark.parametrize("name", SHARED)
def test_shared_bounds_are_the_jax_bounds(name):
    jkey = budgets.counterpart(name)
    assert jkey in jbudgets.budget_names()
    assert budgets.shape_for(name).items() >= jbudgets.shape_for(jkey).items()
    for pt in [{}] + OTHER_POINTS:
        pt = _point(name, pt)
        want = jbudgets.budget_bytes(jkey, **pt)
        assert budgets.budget_bytes(name, **pt) == (
            want + budgets.card_buffer_bytes(name, **pt)), (pt, want)


def test_the_port_names_every_buffer_it_adds():
    """Only the exact SWAP pass and its kernel hold a buffer the JAX
    graphs do not: the bin scratch, about 415 MB at the canonical k."""
    added = {k for k in KEYS if budgets.card_buffer_bytes(k)}
    assert added == {"engine.exact_swap_means", "ops.stream_swap_g_stats"}
    assert budgets.card_buffer_bytes("engine.exact_swap_means") == (
        264 * 128 * 4 * 3 * 256 * 4)
    own = {k for k in KEYS if budgets.counterpart(k) is None}
    assert own == {"ops.stream_build_g_stats", "ops.stream_swap_g_stats",
                   "ops.stream_top2"}


@pytest.mark.parametrize("name", KEYS)
def test_materialised_forms_overshoot(name):
    for pt in [{}] + OTHER_POINTS:
        pt = _point(name, pt)
        assert (budgets.materialised_bytes(name, **pt)
                > budgets.budget_bytes(name, **pt)), pt


def test_scratch_formula_is_the_kernels():
    """lanes x min(ceil(rows / bm), slots // lanes) x bm x 4 x 3 x k
    floats, at the declared slots (132 SMs x 2 blocks) and tile."""
    assert budgets.CARD_SLOTS == 264 and budgets.ROW_TILE == 128
    assert budgets.swap_scratch_bytes(256, 256) == 2 * 128 * 12 * 256 * 4
    assert budgets.swap_scratch_bytes(60_000, 10) == 264 * 128 * 12 * 10 * 4
    assert budgets.swap_scratch_bytes(30_000, 10, slots=528, bm=64) == (
        469 * 64 * 12 * 10 * 4)
    assert budgets.swap_scratch_bytes(5_000, 10, lanes=8) == (
        8 * 33 * 128 * 12 * 10 * 4)
    assert budgets.REF_TILE == tuning.REF_TILE == _EXACT_CHUNK


def test_canonical_shapes_are_the_jax_ones():
    for name in ("N_BIG", "D_BIG", "K_BIG", "ROWS_PREDICT", "ROWS_ASSIGN",
                 "N_DRIVER", "D_DRIVER", "K_DRIVER", "WIDTH_DRIVER"):
        assert getattr(budgets, name) == getattr(jbudgets, name), name


def test_measure_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        budgets.measure_temp_bytes(lambda: None, device="cpu")
