"""TRC005 — bit-parity breakers, four sub-checks with their own scopes.

* ``torch.vmap`` / ``torch.func.vmap`` in the batch drivers
  (``core/banditpam.py``, ``core/batch.py``): the multi-fit contract is
  lockstep lanes, each bit for bit the single fit (the lane kernels, or
  the plain backend's loop over its single forms); ``vmap`` batches the
  reductions and changes their order.
* Filling with ``inf`` on the streaming paths (``core/engine.py``,
  ``kernels/``): ``masked_fill(.., inf)``, ``index_put_(.., inf)``,
  ``index_fill(.., inf)`` or ``x[...] = inf``.  The top-2 pass keeps an
  online (min, min2) or a ``torch.where`` mask inside its tile walk; a
  masked copy brings back the O(n·b) block the budgets forbid.
* float32 in the float64 host accounting (``serve/drift.py``,
  ``runtime/checkpoint.py``): ``np.float32(...)``, a cast or a
  ``dtype=`` to float32, ``.float()``, or a dtype-less ``torch.tensor``
  / ``torch.as_tensor`` of Python numbers (which PyTorch makes float32)
  rounds drift statistics or checkpoint leaves, which are float64 and
  bit-exact by contract.
* Reduced float32 matmul precision anywhere: ``allow_tf32 = True``,
  ``fp32_precision`` set to anything but ``"ieee"``, or
  ``torch.set_float32_matmul_precision`` to anything but ``"highest"``.
  The plain distances run through matmuls, and a TF32 or bf16 pass
  rounds them (ROADMAP C3).

All four report as TRC005 and share the suppression token.
"""

from __future__ import annotations

import ast
from typing import List

from ..config import path_in_scope
from ..engine import Finding, ModuleContext

_VMAPS = ("torch.vmap", "torch.func.vmap")
_INF_NAMES = ("math.inf", "numpy.inf", "torch.inf")
_INF_WRAPPERS = ("torch.tensor", "torch.as_tensor", "torch.full",
                 "torch.full_like", "torch.scalar_tensor")
_FILL_METHODS = ("masked_fill", "masked_fill_", "index_put", "index_put_",
                 "index_fill", "index_fill_", "fill_")
_F32_NAMES = ("numpy.float32", "torch.float32", "torch.float", "float32")
_CONVERTERS = ("torch.tensor", "torch.as_tensor", "torch.asarray")


def _is_inf(node: ast.AST, ctx: ModuleContext) -> bool:
    if isinstance(node, (ast.Name, ast.Attribute)):
        return ctx.resolve(node) in _INF_NAMES
    if isinstance(node, ast.UnaryOp):
        return _is_inf(node.operand, ctx)
    if isinstance(node, ast.Call):
        r = ctx.resolve(node.func)
        if (r == "float" and node.args
                and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).lstrip("+-") in ("inf", "Inf")):
            return True
        if r in _INF_WRAPPERS:
            return any(_is_inf(a, ctx) for a in node.args)
    return False


def _is_f32(node: ast.AST, ctx: ModuleContext) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "float32"
    if isinstance(node, (ast.Name, ast.Attribute)):
        return ctx.resolve(node) in _F32_NAMES
    return False


def _python_numbers(node: ast.AST, ctx: ModuleContext) -> bool:
    """An argument PyTorch converts from Python numbers: a list, tuple or
    number literal, a ``.tolist()`` or a ``float()``."""
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "tolist":
            return True
        return ctx.resolve(f) == "float"
    return False


class TRC005:
    rule_id = "TRC005"
    title = ("bit-parity breaker (vmap batch lane / inf fill / float32 "
             "cast / reduced matmul precision)")

    def check(self, ctx: ModuleContext, config) -> List[Finding]:
        out: List[Finding] = []
        if path_in_scope(ctx.path, config.trc005_vmap):
            out.extend(self._check_vmap(ctx))
        if path_in_scope(ctx.path, config.trc005_setinf):
            out.extend(self._check_setinf(ctx))
        if path_in_scope(ctx.path, config.trc005_f32):
            out.extend(self._check_f32(ctx))
        if path_in_scope(ctx.path, config.trc005_tf32):
            out.extend(self._check_tf32(ctx))
        return out

    def _check_vmap(self, ctx: ModuleContext) -> List[Finding]:
        out = []
        for node, scope in ctx.walk_scoped():
            if isinstance(node, ast.Call) and ctx.resolve(
                    node.func) in _VMAPS:
                out.append(ctx.finding(
                    self.rule_id, node,
                    "vmap in a batch driver: the multi-fit contract is "
                    "lockstep lanes, each the single fit bit for bit; vmap "
                    "changes the reductions' order", scope))
        return out

    def _check_setinf(self, ctx: ModuleContext) -> List[Finding]:
        out = []
        msg = ("filling with inf materialises a masked copy on a streaming "
               "path; keep an online (min, min2) or a torch.where mask "
               "inside the tile walk")
        for node, scope in ctx.walk_scoped():
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _FILL_METHODS
                    and any(_is_inf(a, ctx) for a in list(node.args)
                            + [kw.value for kw in node.keywords])):
                out.append(ctx.finding(self.rule_id, node,
                                       f".{node.func.attr}(inf): " + msg,
                                       scope))
            elif (isinstance(node, ast.Assign)
                  and any(isinstance(t, ast.Subscript)
                          for t in node.targets)
                  and _is_inf(node.value, ctx)):
                out.append(ctx.finding(self.rule_id, node,
                                       "x[...] = inf: " + msg, scope))
        return out

    def _check_f32(self, ctx: ModuleContext) -> List[Finding]:
        out = []
        for node, scope in ctx.walk_scoped():
            if not isinstance(node, ast.Call):
                continue
            r = ctx.resolve(node.func)
            f = node.func
            why = None
            if r == "numpy.float32":
                why = f"{r}()"
            elif isinstance(f, ast.Attribute) and f.attr in (
                    "astype", "to", "type") and any(
                        _is_f32(a, ctx) for a in node.args):
                why = f".{f.attr}(float32)"
            elif (isinstance(f, ast.Attribute) and f.attr == "float"
                  and not node.args and not node.keywords):
                why = ".float()"
            elif any(kw.arg == "dtype" and _is_f32(kw.value, ctx)
                     for kw in node.keywords):
                why = "dtype=float32"
            elif (r in _CONVERTERS and node.args
                  and not any(kw.arg == "dtype" for kw in node.keywords)
                  and len(node.args) < 2
                  and _python_numbers(node.args[0], ctx)):
                why = (f"dtype-less {r}() of Python numbers (PyTorch makes "
                       "them float32)")
            if why:
                out.append(ctx.finding(
                    self.rule_id, node,
                    f"{why} in a float64 host-accounting module silently "
                    "rounds drift or checkpoint state to float32; pass "
                    "an explicit float64 dtype", scope))
        return out

    def _check_tf32(self, ctx: ModuleContext) -> List[Finding]:
        out = []
        for node, scope in ctx.walk_scoped():
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Attribute):
                        continue
                    v = node.value
                    if t.attr == "allow_tf32" and not (
                            isinstance(v, ast.Constant) and v.value is False):
                        out.append(ctx.finding(
                            self.rule_id, node,
                            "allow_tf32 on rounds float32 matmuls to TF32 "
                            "(the plain distances lose bits); keep it "
                            "False", scope))
                    elif t.attr == "fp32_precision" and not (
                            isinstance(v, ast.Constant)
                            and v.value == "ieee"):
                        out.append(ctx.finding(
                            self.rule_id, node,
                            "fp32_precision other than 'ieee' reduces "
                            "float32 matmul precision", scope))
            elif (isinstance(node, ast.Call) and ctx.resolve(node.func)
                  == "torch.set_float32_matmul_precision"):
                a = node.args[0] if node.args else None
                if not (isinstance(a, ast.Constant)
                        and a.value == "highest"):
                    out.append(ctx.finding(
                        self.rule_id, node,
                        "set_float32_matmul_precision other than "
                        "'highest' rounds float32 matmuls (TF32 or bf16)",
                        scope))
        return out
