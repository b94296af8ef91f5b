"""The port's kernel launches a fit (``kernels.ops.launch_counts()``
over the window, masked rounds included), over the window's fits."""


def read(run):
    n = len(run.fits)
    return sum(run.launches.values()) / n if n else None
