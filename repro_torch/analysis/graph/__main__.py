"""``python -m repro_torch.analysis.graph`` — the port's graphcheck CLI
(counterpart of ``python -m repro.analysis.graph``).

Examples::

    python -m repro_torch.analysis.graph --device cpu
    python -m repro_torch.analysis.graph --device cuda --format json
    python -m repro_torch.analysis.graph --entrypoints engine.total_loss
    python -m repro_torch.analysis.graph --rules GRC003,GRC004 --skip-budgets
    REGEN_GOLDEN=1 python -m repro_torch.analysis.graph --device cpu
    python -m repro_torch.analysis.graph --golden-diff

Exit codes: 0 clean, 1 findings, 2 usage error.  Unlike tracecheck this
CLI imports torch: it runs every registered entry point once, on the
CPU's plain versions (``--device cpu``, the default backend ``"torch"``)
or on the card's kernels (``--device cuda``, backend ``"cuda"``, where
GRC001 measures each budget unless ``--skip-budgets``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.graph",
        description="graphcheck: graph contract analyzer of the port's hot "
                    "entry points, with golden op-census fingerprints")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human")
    parser.add_argument("--output", metavar="FILE",
                        help="also write the JSON report to FILE")
    parser.add_argument("--rules", metavar="CSV",
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--entrypoints", metavar="CSV",
                        help="comma-separated registry names to analyze "
                             "(default: all)")
    parser.add_argument("--skip-budgets", action="store_true",
                        help="skip GRC001's measures on the card")
    parser.add_argument("--golden", metavar="FILE",
                        help="golden fingerprint file (default: "
                             "tests/fixtures/graphs_torch.json)")
    parser.add_argument("--golden-diff", action="store_true",
                        help="print the op-level diff vs the golden and "
                             "exit (0 = no drift)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--list-entrypoints", action="store_true")
    args = parser.parse_args(argv)

    # Rule and registry imports come after argparse, so that a usage
    # error stays fast.
    from . import rules as rules_mod
    from . import survey as sv_mod
    from .entrypoints import by_name, registry

    if args.list_rules:
        for rid in sorted(rules_mod.RULE_DOCS):
            print(f"{rid}: {rules_mod.RULE_DOCS[rid]}")
        return 0
    if args.list_entrypoints:
        for spec in registry():
            tags = ",".join(sorted(spec.tags))
            port = f"  -> {spec.port}" if spec.port else ""
            print(f"{spec.name}  [{tags}]{port}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = tuple(r.strip() for r in args.rules.split(",")
                         if r.strip())
        unknown = [r for r in rule_ids if r not in rules_mod.ALL_RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2

    specs = None
    if args.entrypoints:
        table = by_name()
        names = [s.strip() for s in args.entrypoints.split(",")
                 if s.strip()]
        unknown = [s for s in names if s not in table]
        if unknown:
            print(f"unknown entrypoint(s): {', '.join(unknown)} "
                  f"(see --list-entrypoints)", file=sys.stderr)
            return 2
        specs = [table[s] for s in names]

    golden_path = args.golden or sv_mod.default_golden_path()
    golden_doc = None
    golden_note = None
    if golden_path and os.path.isfile(golden_path):
        golden_doc = sv_mod.load_golden(golden_path)
    elif golden_path:
        golden_note = (f"no golden file at {golden_path}; GRC000 drift "
                       f"not evaluated (regenerate with "
                       f"{sv_mod.GOLDEN_ENV}=1)")
    else:
        golden_note = ("golden path unresolvable (no tests tree beside the "
                       "package); GRC000 drift not evaluated")

    regen = os.environ.get(sv_mod.GOLDEN_ENV, "") not in ("", "0")
    if regen and specs is not None:
        print("cannot regenerate from a partial --entrypoints run",
              file=sys.stderr)
        return 2
    if regen and not golden_path:
        print("cannot regenerate: golden path unresolvable",
              file=sys.stderr)
        return 2

    report, prints = rules_mod.analyze(
        specs, device=args.device,
        golden_doc=None if regen else golden_doc, rules=rule_ids,
        with_budgets=not args.skip_budgets)
    if golden_note and not regen and \
            (rule_ids is None or "GRC000" in rule_ids):
        report.notes.append(golden_note)

    if regen:
        key = sv_mod.golden_key(args.device)
        merged = sv_mod.merge_golden(golden_doc, prints, key)
        sv_mod.dump_golden(merged, golden_path)
        print(f"wrote {len(prints)} fingerprint(s) for {key} to "
              f"{golden_path}")

    if args.golden_diff:
        drift = [f for f in report.findings if f.rule == "GRC000"]
        for f in drift:
            print(f"{f.entrypoint}:\n{f.message}")
        for n in report.notes:
            print(f"note: {n}")
        print(f"{len(drift)} drifted entrypoint(s)")
        return 1 if drift else 0

    doc = rules_mod.report_to_json(report, prints, args.device)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
    if args.format == "json":
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print(rules_mod.format_human(report))
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
