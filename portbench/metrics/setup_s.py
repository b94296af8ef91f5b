"""Seconds from the process's start to the window's: imports, the
kernels' library (built by nvcc on a checkout's first run), the data,
one warm-up call at the cell's shapes."""


def read(run):
    return run.setup_s
