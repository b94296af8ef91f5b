"""Lockstep rounds a batch call (``BatchFitReport.dispatches_by_phase``
summed: one round launch for every lane), over the window's calls."""


def read(run):
    rounds = [sum(c.report.dispatches_by_phase.values()) for c in run.calls
              if c.report.dispatches_by_phase]
    return sum(rounds) / len(rounds) if rounds else None
