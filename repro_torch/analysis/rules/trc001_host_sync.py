"""TRC001 — host syncs in round-reachable code.

In eager PyTorch every operation of a device-resident round is enqueued
without a wait; a host sync there (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.synchronize()``, ``np.asarray`` of a tensor, ``float()``
/ ``int()`` / ``bool()`` of a tensor, or ``if`` on one) makes the host
wait for the device every round, and a CUDA-graph capture fails at the
first one.  The sanctioned points are ``engine.host_read`` (the drivers'
one read), ``engine.host_stage`` (an input upload), ``engine.phase_sync``
(a phase's wall) and ``engine.syncs_allowed``: calling one is the
sanctioned read, and code inside their ``with`` blocks is exempt.

``float()`` / ``int()`` / ``bool()`` fire only on a tensor expression:
a ``torch.*`` call, a reduction or cast method (``.sum()``, ``.max()``,
``.to()``, ...), a name assigned from one or annotated ``torch.Tensor``,
or arithmetic, a comparison or a subscript of one.  Shape arithmetic on
Python values (``int(n)``, ``int(x.shape[0])``) does not fire.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..engine import Finding, ModuleContext

_BUILTIN_SYNCS = ("float", "int", "bool", "complex")
_NUMPY_SYNCS = ("numpy.asarray", "numpy.array", "numpy.copy")
_METHOD_SYNCS = {
    "item": "reads one element to the host",
    "tolist": "copies the tensor to a host list",
    "cpu": "copies the tensor to the host",
    "numpy": "needs the tensor on the host",
    "synchronize": "waits for the device",
}
# Tensor methods whose result is a tensor (a reduction, a cast, a view).
_TENSOR_METHODS = frozenset({
    "sum", "mean", "max", "min", "amax", "amin", "prod", "norm", "any",
    "all", "std", "var", "argmax", "argmin", "count_nonzero", "abs",
    "sqrt", "float", "double", "long", "int", "to", "clone", "reshape",
    "view", "squeeze", "flatten", "masked_fill", "index_select", "gather",
    "logical_not", "logical_and", "logical_or", "dot", "matmul", "eq",
    "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "nansum",
})
# torch.* callables that return no tensor.
_NON_TENSOR_TORCH = frozenset({
    "finfo", "iinfo", "device", "Size", "dtype", "is_tensor",
    "get_default_dtype", "is_floating_point", "numel",
    "is_grad_enabled", "Generator", "Stream", "Event",
})
_NON_TENSOR_TORCH_MODULES = ("torch.cuda.", "torch.backends.",
                             "torch.distributed.", "torch.version.",
                             "torch.utils.", "torch.testing.")


class _Tensors:
    """Which expressions of one function are tensors (module docstring)."""

    def __init__(self, ctx: ModuleContext, func: ast.AST) -> None:
        self.ctx = ctx
        self.names: Set[str] = set()
        args = getattr(func, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if self._tensor_annotation(a.annotation):
                    self.names.add(a.arg)
        assigns = sorted(
            (n for n in ctx.walk_own(func)
             if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))),
            key=lambda n: (n.lineno, n.col_offset))
        changed = True
        while changed:
            changed = False
            for node in assigns:
                if node.value is None or not self.of(node.value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name) and \
                                name.id not in self.names:
                            self.names.add(name.id)
                            changed = True

    def _tensor_annotation(self, ann) -> bool:
        """``torch.Tensor`` or ``Optional[torch.Tensor]``."""
        if isinstance(ann, ast.Subscript) and self.ctx.resolve(
                ann.value) in ("typing.Optional", "Optional"):
            ann = ann.slice
        return ann is not None and self.ctx.resolve(ann) == "torch.Tensor"

    def of(self, node: ast.AST) -> bool:
        ctx = self.ctx
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.of(node.value)
        if isinstance(node, ast.BinOp):
            return self.of(node.left) or self.of(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.of(node.operand)
        if isinstance(node, ast.Compare):
            # ``t is None`` reads nothing.
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self.of(v) for v in [node.left] + node.comparators)
        if isinstance(node, ast.Call):
            r = ctx.resolve(node.func)
            if r and r.startswith("torch.") and not r.startswith(
                    _NON_TENSOR_TORCH_MODULES):
                return r.rsplit(".", 1)[-1] not in _NON_TENSOR_TORCH
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS:
                # A reduction or cast: a tensor method, whatever the
                # receiver (round code holds no other such objects).
                return True
        return False


class TRC001:
    rule_id = "TRC001"
    title = ("host sync (.item()/.tolist()/.cpu()/float()/bool()/"
             "np.asarray/synchronize) inside a round-reachable function")

    def check(self, ctx: ModuleContext, config) -> List[Finding]:
        out: List[Finding] = []
        for info in ctx.reachable_functions():
            if ctx.is_sanctioned_sync(info.qualname):
                continue
            tensors = _Tensors(ctx, info.node)
            for node in ctx.walk_own(info.node):
                if ctx.in_sanctioned_span(node):
                    continue
                msg = self._sync(ctx, node, tensors)
                if msg:
                    out.append(ctx.finding(self.rule_id, node, msg,
                                           info.qualname))
        return out

    @staticmethod
    def _sync(ctx: ModuleContext, node: ast.AST, tensors: _Tensors):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if tensors.of(node.test):
                return ("a branch on a tensor reads it to the host every "
                        "round; keep the choice on the device "
                        "(torch.where, a run flag)")
            return None
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        if isinstance(f, ast.Attribute):
            why = _METHOD_SYNCS.get(f.attr)
            if why and not node.args and not node.keywords:
                return (f".{f.attr}() {why}: the host waits for the device "
                        "every round; keep the value on the device or read "
                        "it through engine.host_read at the phase's end")
            if f.attr == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(node.args)
                    + [kw.value for kw in node.keywords]):
                return (".to('cpu') copies the tensor to the host every "
                        "round; read it through engine.host_read")
        r = ctx.resolve(f)
        if r in _NUMPY_SYNCS:
            if node.args and not isinstance(
                    node.args[0], (ast.Constant, ast.List, ast.Tuple)):
                return (f"{r}() of a tensor copies it to the host; use "
                        "torch inside the rounds and engine.host_read at "
                        "the boundary")
            return None
        if (isinstance(f, ast.Name) and f.id in _BUILTIN_SYNCS
                and r == f.id and node.args and tensors.of(node.args[0])):
            return (f"{f.id}() of a tensor reads it to the host; keep "
                    "scalars as 0-d tensors on the device")
        return None
