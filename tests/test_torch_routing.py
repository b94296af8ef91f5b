"""The stats-backend routing rule of the port, held to the reference's.

Under ``"auto"`` (or None) the kernels serve a kernel metric on a CUDA
device; every other case runs the plain PyTorch versions (``"torch"``)
on the data's device.  That includes a metric added with
``register_metric`` on a CUDA device, which the reference's ``"auto"``
sends to ``"jnp"`` (``src/repro/core/engine.py:575-578``).  An explicit
``"cuda"`` with such a metric, or off a CUDA device, is an error.  The
rule needs no card: it reads only the device's type.
"""

import numpy as np
import pytest
import torch

from repro.core import BanditPAM as JBanditPAM
from repro.core import datasets as jdatasets
from repro.core import register_metric as jregister_metric
from repro_torch import convert
from repro_torch.core import BanditPAM, engine
from repro_torch.core.distances import register_metric
from repro_torch.kernels.ops import KERNEL_METRICS
from test_torch_banditpam import _same_fit, jax_layouts

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
CUSTOM = "chebyshev_routing_test"


def _chebyshev(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def _jchebyshev(x, y):
    import jax.numpy as jnp
    return jnp.max(jnp.abs(x[:, None, :] - y[None, :, :]), axis=-1)


register_metric(CUSTOM, _chebyshev)


@pytest.mark.parametrize("backend", [None, "auto"])
@pytest.mark.parametrize("metric", list(KERNEL_METRICS) + [CUSTOM])
def test_auto_routes_by_metric_and_device(backend, metric):
    want = "cuda" if metric in KERNEL_METRICS else "torch"
    assert engine.resolve_stats_backend(backend, metric, CUDA) == want
    assert engine.resolve_stats_backend(backend, metric, CPU) == "torch"


def test_explicit_cuda_refuses_a_metric_without_kernel():
    with pytest.raises(ValueError, match="has no kernel"):
        engine.resolve_stats_backend("cuda", CUSTOM, CUDA)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        engine.resolve_stats_backend("cuda", "l2", CPU)
    assert engine.resolve_stats_backend("torch", CUSTOM, CUDA) == "torch"
    assert engine.resolve_stats_backend("cuda", "l2", CUDA) == "cuda"


def test_registered_metric_fit_matches_jax_reference():
    """A registered metric fits through the plain versions and
    reproduces the JAX package's fit under the same metric."""
    n, k = 300, 3
    jregister_metric(CUSTOM, _jchebyshev)
    X = jdatasets.mnist_like(n, seed=2, d=24)
    want = JBanditPAM(k, metric=CUSTOM, seed=0, backend="jnp").fit(X)
    layouts = convert.layouts_from_reference(*jax_layouts(0, n, k))
    got = BanditPAM(k, metric=CUSTOM, backend="auto", device="cpu").fit(
        X, layouts=layouts)
    _same_fit(got, want)
    assert np.isfinite(got.loss)
