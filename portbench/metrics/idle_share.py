"""The traced call's wall in which no device activity ran, %: one less
the union of the device's activity intervals over the call's wall.  The
profiler slows the host, so this is the traced run's share."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
