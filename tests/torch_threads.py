"""The port's test files' shared fixture: ``from torch_threads import
one_intra_op_thread`` makes it autouse in the importing module."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread: the port's tests run many small ops, and with
    several pytest workers sharing the cores, OpenMP's idle threads
    multiply their time many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
