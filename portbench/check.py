"""The comparison that decides ``correct``: a fit of the program, judged
by what its report says, against the plain reference
(``reference/bandit.py``) in float64 on the same points and the same
fit seed.  The reference follows the program's decisions search by
search (``walk(follow=...)``).

For each fit checked, two numbers, each held to its cell's limit where
the cell compares it (``limits/<workload>.json``, which says why it
leaves one out), and one count held to 0:

* ``loss_gap`` — the largest relative gap between a loss the program
  states or reaches and the reference's: a loss it reported (the final
  one, and after each accepted swap) against the exact loss of its
  medoids; the exact loss its decision reached (a BUILD pick, an
  accepted swap) against the loss the reference's own decision reaches
  from the same state, a swap that raised the loss, and the share of the
  loss a refused last swap would have saved; and the loss its labels
  imply against the loss of each row at its nearest medoid.
* ``ledger_gap`` — the largest relative gap between the program's and
  the reference's evaluation ledger, phase by phase, fresh and cached.
* ``malformed`` — a report whose medoids, history, rounds or labels are
  not a fit of k distinct medoids of the rows (limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.bandit import Space, decisions, walk

NUMBERS = ("loss_gap", "ledger_gap")


def _rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1.0)


def malformed(report, labels, n: int, k: int) -> bool:
    med = np.asarray(report.medoids).reshape(-1)
    lab = None if labels is None else np.asarray(labels).reshape(-1)
    return not (med.shape[0] == k and len(set(med.tolist())) == k
                and med.min() >= 0 and med.max() < n
                and len(report.build_rounds) == k
                and report.n_swaps == len(report.swap_history)
                and lab is not None and lab.shape[0] == n
                and lab.min() >= 0 and lab.max() < k)


def judge(x: np.ndarray, metric: str, k: int, seed: int, report, labels,
          *, batch_size: int, reuse: str, device) -> Dict[str, float]:
    """The numbers of one fit of ``x`` (``[n, d]`` float32) with fit seed
    ``seed``: ``report`` the program's FitReport, ``labels`` its in-sample
    labels."""
    n = x.shape[0]
    if malformed(report, labels, n, k):
        return {"malformed": 1.0}
    dec = decisions(report.medoids, report.swap_history, report.converged)
    if dec is None:
        return {"malformed": 1.0}
    space = Space(x, metric, "float64", device)
    ref = walk(space, k, seed, batch_size=batch_size, reuse=reuse,
               follow=dec)
    ledger = [_rel(report.evals_by_phase.get(ph, 0), v)
              for ph, v in ref.evals_by_phase.items()]
    if set(report.evals_by_phase) - set(ref.evals_by_phase):
        ledger.append(float("inf"))
    dm = space.to_medoids(ref.medoids)
    near = torch.min(dm, dim=1).values.sum()
    lab = torch.as_tensor(np.asarray(labels, np.int64), device=dm.device)
    labelled = dm.gather(1, lab[:, None]).sum()
    losses = [_rel(report.loss, float(near)),
              float((labelled - near) / near)] + list(ref.gaps)
    losses += [_rel(p[2], r[2]) for p, r in zip(report.swap_history,
                                                 ref.history)]
    return {"loss_gap": max(losses), "ledger_gap": max(ledger),
            "malformed": 0.0}


def combine(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the fits checked."""
    out = {name: 0.0 for name in NUMBERS + ("malformed",)}
    for p in parts:
        for name in out:
            out[name] = max(out[name], p.get(name, 0.0))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each number the cell compares beside its limit, ``malformed``
    last."""
    out = {name: {"value": numbers.get(name, float("inf")),
                  "limit": float(limit)} for name, limit in limits.items()}
    out["malformed"] = {"value": numbers.get("malformed", 0.0),
                        "limit": 0.0}
    return out


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def sample(n_fits: int, count: int, seed: int) -> List[int]:
    """Which of the window's fits to check: ``count`` of them, drawn
    from the run's seed."""
    rng = np.random.default_rng([seed % 2 ** 63, 0xC4EC])
    count = min(count, n_fits)
    return sorted(rng.choice(n_fits, size=count, replace=False).tolist())


def judge_record(rec, x: np.ndarray, cfg: dict, device
                 ) -> Dict[str, float]:
    """:func:`judge` of one of a run's fits (``harness.FitRecord``)."""
    rows = x if rec.rows is None else x[rec.rows]
    return judge(np.ascontiguousarray(rows), cfg["metric"], int(cfg["k"]),
                 rec.seed, rec.report, rec.labels,
                 batch_size=int(cfg["batch_size"]), reuse=rec.reuse,
                 device=device)
