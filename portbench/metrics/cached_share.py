"""Evaluations the PIC ring served, as a share of all evaluations
(``cached_evals`` over fresh and cached), over the window, %."""


def read(run):
    fits = run.fits
    if not any(k.endswith("_cached") for f in fits
               for k in f.report.evals_by_phase):
        return None
    cached = sum(f.report.cached_evals for f in fits)
    return 100.0 * cached / (cached + sum(f.report.distance_evals
                                          for f in fits))
