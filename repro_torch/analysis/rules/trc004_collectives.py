"""TRC004 — collectives inside a stats backend.

The backend contract (``core/engine.py``) is collective-free: a backend
computes this rank's partial sums, and the sharded fit owns the one
composition point (``DistributedBanditPAM._reduce``: one ``all_reduce``
of the three stacked moments a round).  A collective inside a backend
would reduce twice on the sharded fit, move its ledger off the local
one, and break single-device fits outside a group.  The rule fires on
any ``torch.distributed`` collective (or a functional collective)
lexically inside a class whose name, or a base's, ends in
``StatsBackend``.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import BACKEND_SUFFIX, Finding, ModuleContext

_COLLECTIVES = frozenset({
    "torch.distributed.all_reduce", "torch.distributed.all_gather",
    "torch.distributed.all_gather_into_tensor",
    "torch.distributed.all_gather_object",
    "torch.distributed.reduce_scatter",
    "torch.distributed.reduce_scatter_tensor",
    "torch.distributed.broadcast", "torch.distributed.broadcast_object_list",
    "torch.distributed.all_to_all", "torch.distributed.all_to_all_single",
    "torch.distributed.reduce", "torch.distributed.gather",
    "torch.distributed.scatter", "torch.distributed.barrier",
})
_FUNCTIONAL = "torch.distributed._functional_collectives."


class TRC004:
    rule_id = "TRC004"
    title = ("collective (all_reduce/all_gather/broadcast/...) inside a "
             "StatsBackend")

    @staticmethod
    def _is_backend_class(node: ast.ClassDef, ctx: ModuleContext) -> bool:
        if node.name.endswith(BACKEND_SUFFIX):
            return True
        for base in node.bases:
            r = ctx.resolve(base)
            if r and r.rsplit(".", 1)[-1].endswith(BACKEND_SUFFIX):
                return True
        return False

    def check(self, ctx: ModuleContext, config) -> List[Finding]:
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and self._is_backend_class(cls, ctx)):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call):
                    continue
                r = ctx.resolve(node.func)
                if r and (r in _COLLECTIVES or r.startswith(_FUNCTIONAL)):
                    out.append(ctx.finding(
                        self.rule_id, node,
                        f"{r}() inside StatsBackend `{cls.name}`: backends "
                        "are collective-free by contract; the sharded fit "
                        "owns the one all_reduce a round", cls.name))
        return out
