"""tracecheck rule pack for the port: one module per TRC rule, with the
JAX package's ids (``repro.analysis.rules``).

Rule objects expose ``rule_id``, ``title`` and
``check(ctx, config) -> list[Finding]``.  The engine handles path scopes
(TRC005's sub-checks carry their own) and suppressions; rules only emit.
"""

from .trc001_host_sync import TRC001
from .trc002_python_loops import TRC002
from .trc003_rng_chain import TRC003
from .trc004_collectives import TRC004
from .trc005_parity import TRC005

ALL_RULES = (TRC001(), TRC002(), TRC003(), TRC004(), TRC005())

RULE_DOCS = {r.rule_id: r.title for r in ALL_RULES}
RULE_DOCS["TRC000"] = "suppression comment without a `-- reason` justification"

__all__ = ["ALL_RULES", "RULE_DOCS",
           "TRC001", "TRC002", "TRC003", "TRC004", "TRC005"]
