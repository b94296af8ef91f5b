"""TRC002 — Python ``for`` / ``while`` in round-reachable code.

In eager PyTorch a Python loop inside a device-resident round (or a
stats backend, or a kernel wrapper) enqueues its body's launches once a
trip: the host paces the device, and a CUDA-graph capture of the round
grows with the trip count.  The contract is one launch (or a fixed
handful) a round.  Loops whose trip count is fixed by the shapes (a
walk over a fixed number of reference tiles, the lanes of the plain
backend) are the legitimate exception, suppressed with a reason.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ModuleContext


class TRC002:
    rule_id = "TRC002"
    title = "Python for/while loop inside a round-reachable function"

    def check(self, ctx: ModuleContext, config) -> List[Finding]:
        out: List[Finding] = []
        for info in ctx.reachable_functions():
            for node in ctx.walk_own(info.node):
                if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    kind = "while" if isinstance(node, ast.While) else "for"
                    out.append(ctx.finding(
                        self.rule_id, node,
                        f"Python `{kind}` enqueues its body once a trip "
                        "inside the rounds; the contract is one launch a "
                        "round (suppress only a loop fixed by the shapes, "
                        "with a reason)", info.qualname))
        return out
