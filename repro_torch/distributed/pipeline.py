"""GPipe-style pipeline parallelism over a process group or a mesh axis
(counterpart of ``repro.distributed.pipeline``).

A composable schedule, not a model rewrite: hand it a per-stage function
and this rank's stage parameters (the layers split across the stages),
and it runs the ``M + S - 1``-tick bubble schedule with a ring send
between stages every tick.  As in the JAX schedule, every stage runs
``stage_fn`` on every tick (a stage before its first microbatch or after
its last computes on what the ring holds), so every rank makes the same
collectives in the same order.  The last stage's outputs reach every
rank through an all-reduce of the outputs masked to that stage.

Autograd runs through the schedule: the ring send's backward sends the
gradient back the other way (:class:`_RingShift`; ``torch.distributed``
has no differentiable ``ppermute``), and the final all-reduce's backward
passes each rank's gradient through unchanged (:class:`_SumReplicated`:
its output is replicated, so every rank already holds the cotangent of
the one loss, the transpose of the JAX ``psum`` of a replicated value).
So ``torch.autograd.grad`` of a loss of the outputs gives each rank the
gradient of its own stage's parameters, the standard GPipe backward.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor


def _ring_send(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent ``step`` stages along the ring of ``group`` (rank ``i``
    to ``i + step``); returns what this rank received."""
    s = dist.get_world_size(group)
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group,
                                                         (i + step) % s),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group,
                                                           (i - step) % s),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """The JAX ``ppermute`` with ``perm = [(i, i + 1 mod S)]``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_send(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_send(g, ctx.group, -1), None


class _SumReplicated(torch.autograd.Function):
    """The sum over ``group`` of ``x``; the result is replicated, so the
    gradient of each rank's ``x`` is the cotangent it holds."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          n_stages: int, group=None):
    """Build the pipeline runner over ``group`` (its rank is the stage).

    stage_fn: (stage_params, x [mb, ...]) -> y [mb, ...], one stage's
      compute (e.g. a loop over that stage's layer slice).
    Returns runner(stage_params_local, mbs [M, mb, ...]) -> [M, mb, ...],
      the LAST stage's outputs, the same on every rank.
    """
    if group is None:
        group = dist.group.WORLD
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages on a group of "
                         f"{dist.get_world_size(group)} ranks")

    def runner(stage_params, mbs: torch.Tensor) -> torch.Tensor:
        s = n_stages
        sid = dist.get_rank(group)
        m = mbs.shape[0]
        buf = torch.zeros_like(mbs[0])
        first = torch.full((), sid == 0, device=mbs.device)
        ys = []
        for t in range(m + s - 1):
            # stage 0 injects microbatch t (while in range), others take
            # what the ring brought.  A select, not a branch: every
            # rank's input depends on the ring, so every rank's backward
            # makes the same ring sends.
            x = torch.where(first, mbs[min(t, m - 1)], buf)
            y = stage_fn(stage_params, x)
            buf = _RingShift.apply(y, group)
            ys.append(y)
        # the last stage's outputs appear at ticks [s-1, s-1+m); this
        # rank's are masked unless it is that stage, and the sum over the
        # ranks gives every rank the last stage's.
        out = torch.stack(ys[s - 1:s - 1 + m])
        mask = 1.0 if sid == s - 1 else 0.0
        return _SumReplicated.apply(out * mask, group)

    return runner


def pipeline_map(stage_fn, mesh: DeviceMesh, n_stages: int,
                 axis: str = "pod"):
    """:func:`gpipe` over the mesh dimension ``axis``: runner(params,
    mbs) takes the parameters of every stage stacked on their leading
    axis (a DTensor sharded over ``axis`` on it, or the whole tensor,
    which each rank slices) and the microbatches replicated, and returns
    the last stage's outputs, replicated (the JAX ``params_spec =
    P(axis)``, ``x_spec = P(None)``)."""
    group = mesh.get_group(axis)
    runner = gpipe(stage_fn, n_stages, group)

    def run(params, mbs):
        if isinstance(params, DTensor):
            params = params.to_local()
        else:
            params = torch.chunk(params, n_stages)[dist.get_rank(group)]
        if isinstance(mbs, DTensor):
            mbs = mbs.full_tensor()
        return runner(params, mbs)

    return run
