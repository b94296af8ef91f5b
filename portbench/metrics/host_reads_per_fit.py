"""Device-to-host reads a fit (``host_reads_by_phase`` summed; a batch's
over its lanes), over the window: each waits for the card."""


def read(run):
    n = len(run.fits)
    return sum(sum(c.report.host_reads_by_phase.values())
               for c in run.calls) / n if n else None
