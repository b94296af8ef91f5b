"""The frozen generators and draw source against the port's: the same
arrays and the same permutations bit for bit."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import threefry as frozen
from repro_torch.core import datasets, threefry


@pytest.mark.parametrize("name,n,seed", [("mnist_like", 500, 0),
                                         ("mnist_like", 1234, 2 ** 31 + 7),
                                         ("scrna_like", 700, 3),
                                         ("scrna_like", 999, 2 ** 33 + 1)])
def test_generators_equal_the_ports(name, n, seed):
    x, lab = data.GENERATORS[name](n, seed=seed)
    want = datasets.make(name, n, seed=seed)
    assert x.dtype == want.dtype and np.array_equal(x, want)
    assert lab.shape == (n,) and lab.min() >= 0


def test_scrna_labels_are_the_cell_types():
    x, z = data.scrna_like(400, seed=5)
    rng = np.random.default_rng(5)
    rng.gamma(0.3, 1.0, size=(8, 1000))
    assert np.array_equal(z, rng.integers(0, 8, size=400))


@pytest.mark.parametrize("seed,n", [(0, 100), (2 ** 31 + 5, 7919),
                                    (123456789, 70000)])
def test_permutations_equal_the_ports(seed, n):
    k = 3
    d = frozen.Draws(seed, k, "cpu")
    key, ckey = threefry.split(threefry.PRNGKey(seed))
    assert torch.equal(d.fixed(n), threefry.permutation(ckey, n))
    subs = []
    for _ in range(k + 2):
        key, sub = threefry.split(key)
        subs.append(sub)
    assert torch.equal(d.perm("build", 1, n),
                       threefry.permutation(threefry.split(subs[1])[1], n))
    assert torch.equal(d.perm("swap", 1, n),
                       threefry.permutation(threefry.split(subs[k + 1])[1],
                                            n))
