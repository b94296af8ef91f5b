"""The replacement, leader and early-stop fits of
``tests/test_torch_sampling.py`` at the l1 fixture (650, 4, l1),
held against the JAX package on the CPU with the same rules (see that
module's docstring).  A file of its own, so that the parity matrix is
spread over the test workers."""

import pytest
import torch

from test_torch_banditpam import FIXTURES
from test_torch_sampling import MODES, check_mode_against_jax
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("mode", [m for m in MODES
                                  if m != "replacement+early_stop"])
@pytest.mark.parametrize("n,k,metric", [f for f in FIXTURES
                                        if f[2] == "l1"])
def test_fit_modes_match_jax_reference(n, k, metric, mode, monkeypatch):
    check_mode_against_jax(n, k, metric, mode, monkeypatch)
