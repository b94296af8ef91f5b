"""SWAP's wall a fit (the program's ``wall_by_phase["swap"]``; a
batch's phase wall over its lanes), over the window."""


def read(run):
    n = len(run.fits)
    return sum(c.report.wall_by_phase.get("swap", 0.0)
               for c in run.calls) / n if n else None
