"""Cross-pod compressed train step (``repro.train.compressed``'
counterpart): the gradient reduction over the pod ranks of a
``torch.distributed`` group goes through
``distributed.compression``'s int8 error-feedback sum.

Each rank of the group is one pod.  Every rank holds the same
parameters and the whole batch; it takes its slice of the batch's
leading axis (rank r of P the r-th of P equal slices: the JAX step's
``P("pod")`` sharding), computes its gradient in full precision, and
the pod sum of the gradients is compressed, one scale a leaf of the JAX
tree (``models.model.reference_leaves``: a layer's tensor shares its
scale with the same tensor of the other layers at its pattern
position), then divided by P.  The loss is the mean over the pods.
Each rank carries its own residuals (the JAX state's ``[n_pods, ...]``
leaf, one row a rank), rewritten in place as ``apply_updates`` rewrites
the parameters and moments, and every rank applies the same update, so
the parameters stay equal across ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..distributed.compression import init_residuals, tree_psum_int8_ef
from ..models.model import Decoder, params_of, reference_leaves
from .optimizer import OptConfig, apply_updates
from .train_step import value_and_grad


# This rank's residuals (the JAX function's row of its ``[n_pods, ...]``
# leaves): zero float32 tensors shaped as the parameters.
init_pod_residuals = init_residuals


def make_compressed_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                               group: Optional[dist.ProcessGroup] = None):
    """``(model, opt_state, residuals, batch) -> (model, opt_state,
    residuals, metrics)`` over the pod ranks of ``group`` (the WORLD
    group when None); the batch's leading axis must divide by their
    count."""

    def train_step(model: Decoder, opt_state, residuals, batch):
        n_pods = dist.get_world_size(group)
        pod = dist.get_rank(group)
        b = next(iter(batch.values())).shape[0]
        if b % n_pods:
            raise ValueError(f"batch {b} does not divide by {n_pods} pods")
        m = b // n_pods
        local = {k: v[pod * m:(pod + 1) * m] for k, v in batch.items()}
        (loss, _), grads = value_and_grad(cfg, model, local)
        pods = torch.full((), float(n_pods), dtype=torch.float32,
                          device=loss.device)
        names = list(grads)          # the parameters' order, for the norm
        gsum, residuals = tree_psum_int8_ef(
            grads, residuals, group, reference_leaves(cfg, names))
        gavg = {name: gsum[name].div_(pods) for name in names}
        dist.all_reduce(loss, group=group)
        loss = loss / pods
        _, opt_state, om = apply_updates(params_of(model), gavg, opt_state,
                                         opt_cfg)
        return model, opt_state, residuals, {"loss": loss, **om}

    return train_step
