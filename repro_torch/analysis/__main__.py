"""``python -m repro_torch.analysis`` — the port's tracecheck CLI
(counterpart of ``python -m repro.analysis``).

Examples::

    python -m repro_torch.analysis repro_torch
    python -m repro_torch.analysis repro_torch --format json --output t.json
    python -m repro_torch.analysis --imports --check-quarantine
    python -m repro_torch.analysis --list-rules

Exit codes: 0 clean, 1 findings (or quarantine drift), 2 usage error.
The CLI is stdlib only: it imports neither torch nor jax, so it runs in
a lint image without either.  Run it from the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import config as config_mod
from . import engine
from .rules import ALL_RULES, RULE_DOCS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracecheck: AST contract linter for the port")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to scan (default: "
                             "repro_torch)")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human")
    parser.add_argument("--output", metavar="FILE",
                        help="also write the JSON report to FILE")
    parser.add_argument("--rules", metavar="CSV",
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--imports", action="store_true",
                        help="print the import-graph/dead-module report")
    parser.add_argument("--check-quarantine", action="store_true",
                        help="with --imports: fail on undocumented dormant "
                             "modules or stale quarantine entries")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULE_DOCS):
            print(f"{rid}: {RULE_DOCS[rid]}")
        return 0

    cfg = config_mod.default_config()
    rc = 0

    if args.imports:
        from . import imports as imports_mod
        report = imports_mod.build_report(os.getcwd(), cfg)
        print(imports_mod.format_report(report, cfg))
        if args.check_quarantine:
            undocumented, stale = imports_mod.check_quarantine(report, cfg)
            if undocumented or stale:
                rc = 1
        if not args.paths:
            return rc

    paths = args.paths or ["repro_torch"]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    rules = ALL_RULES
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.rule_id for r in ALL_RULES}
        if unknown:
            print(f"error: unknown rules: {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        rules = tuple(r for r in ALL_RULES if r.rule_id in wanted)

    report = engine.run(paths, cfg, rules=rules)
    if args.output:
        engine.dump_json(report, args.output)
    if args.format == "json":
        json.dump(engine.report_to_json(report), sys.stdout, indent=2,
                  sort_keys=True)
        print()
    else:
        print(engine.format_human(report))
    return 1 if report.findings else rc


if __name__ == "__main__":
    sys.exit(main())
