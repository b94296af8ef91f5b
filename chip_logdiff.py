"""Compare the results of two ``chip_smoke.py`` logs, times left out.

    python3 chip_logdiff.py BEFORE.log AFTER.log

A log's result lines are those of its checks, fits and launch counts
(medoids, losses, ledgers, rounds, host reads, launches, max errors,
parity verdicts); walls, kernel times, rates, bounds, peak memory and
profiles are dropped, and a time left inside a kept line becomes
``<t>``.  Prints how many result lines each log has and every line that
only one of them holds (a line of a phase that only one log runs
included).  Exits 1 when a line of BEFORE is missing from AFTER, else 0.
"""

import re
import sys

RESULT = re.compile(r"^\[(parity|parity6|driver|main|exact|pic|solvers|serve|"
                    r"batch|claim|launches|metrics|threefry|check|dist|guard)\]")
TIMED = re.compile(r"kernel .* plain|bound|busy|idle|launch.*ms|took|wall")
TIME = re.compile(r"wall_by_phase \{[^}]*\}|peak device memory \d+ bytes|"
                  r"\(?[0-9.]+ m?s\)?|[0-9.e+-]+ ms|\d+\.\d+ (ms|s)\b|"
                  r"[0-9.]+ rows/s")


def results(path):
    with open(path, errors="replace") as f:
        return [TIME.sub("<t>", ln.rstrip()) for ln in f
                if RESULT.match(ln) and not TIMED.search(ln)]


def main(before, after) -> int:
    a, b = results(before), results(after)
    print(f"{len(a)} result lines in {before}, {len(b)} in {after}")
    lost = [ln for ln in a if ln not in set(b)]
    new = [ln for ln in b if ln not in set(a)]
    for tag, path, lines in (("-", before, lost), ("+", after, new)):
        print(f"{len(lines)} only in {path}")
        for ln in lines:
            print(f"  {tag} {ln}")
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
