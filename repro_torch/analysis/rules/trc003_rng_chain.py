"""TRC003 — draws outside the sanctioned heads of the threefry chain.

Every draw of the engine comes from the JAX package's threefry chain
(``rng.from_seed``, ``core/threefry.py``), keyed on (seed, phase,
selection, round, shard), which is what makes a seed reproduce the JAX
fit bit for bit.  A ``torch.Generator`` made anywhere else, a
``torch.manual_seed``, or a ``torch.rand*`` / ``randn`` / ``randint`` /
``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial`` without
``generator=`` (the global generator) is the shape of the JAX package's
round-collision bug: a draw keyed on local state that ignores the
chain.  The heads are ``Config.sanctioned_chain_heads`` and the files
of ``Config.sanctioned_chain_paths``.
"""

from __future__ import annotations

import ast
from typing import List

from ..config import path_in_scope
from ..engine import Finding, ModuleContext, qual_matches

_CHAIN_HEADS = ("torch.Generator", "torch.manual_seed",
                "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                "torch.seed", "torch.random.manual_seed")
_DRAWS = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson",
})
# In-place draws of a tensor method.
_DRAW_METHODS = frozenset({"uniform_", "normal_", "random_", "bernoulli_",
                           "exponential_", "geometric_", "cauchy_",
                           "log_normal_"})


class TRC003:
    rule_id = "TRC003"
    title = ("draw or generator outside the sanctioned threefry chain "
             "heads")

    @staticmethod
    def _sanctioned(ctx: ModuleContext, qualname: str, config) -> bool:
        if path_in_scope(ctx.path, config.sanctioned_chain_paths):
            return True
        return any(qual_matches(qualname, s)
                   for s in config.sanctioned_chain_heads)

    def check(self, ctx: ModuleContext, config) -> List[Finding]:
        out: List[Finding] = []
        for node, scope in ctx.walk_scoped():
            if not isinstance(node, ast.Call):
                continue
            r = ctx.resolve(node.func)
            has_gen = any(kw.arg == "generator" for kw in node.keywords)
            where = scope or "<module>"
            if r in _CHAIN_HEADS:
                if not self._sanctioned(ctx, scope, config):
                    out.append(ctx.finding(
                        self.rule_id, node,
                        f"{r}() in `{where}`, which is not a sanctioned "
                        "chain head: draw from the threefry chain "
                        "(rng.from_seed) keyed on (seed, phase, selection, "
                        "round, shard)", scope))
            elif (r in _DRAWS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DRAW_METHODS)) and not has_gen:
                if not self._sanctioned(ctx, scope, config):
                    name = r if r in _DRAWS else f".{node.func.attr}()"
                    out.append(ctx.finding(
                        self.rule_id, node,
                        f"{name} without generator= draws from the global "
                        "generator, outside the chain: rounds and call "
                        "sites can collide silently", scope))
        return out
