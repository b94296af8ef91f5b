"""The benchmark's own tests: run with ``python -m pytest portbench/tests``
from the repository root.  Tests marked ``gpu`` need a CUDA device and
skip without one."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _threads():
    """Few intra-op threads: the CPU runs share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
