"""The traced call's needed distance work at the card's peaks (fresh
evaluations at 2·d float32 operations, cached ones at a float32 read;
``peaks.distance_work_s``) over the device's busy time in that call, %.
The evaluations are the algorithm's, so it reads the same work whatever
kernel does it."""

from portbench.peaks import distance_work_s


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or not t["fresh_evals"] + t["cached_evals"]:
        return None
    least = distance_work_s(t["fresh_evals"], t["cached_evals"],
                            int(run.config["d"]))
    return 100.0 * least / t["busy_s"]
