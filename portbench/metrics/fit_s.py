"""Wall seconds a fit: the measured window, from its start to the end
of its last call (ending in a device synchronisation), over the fits
its calls completed (a batch call of L lanes is L fits)."""


def read(run):
    n = len(run.fits)
    return run.wall_s / n if n else None
