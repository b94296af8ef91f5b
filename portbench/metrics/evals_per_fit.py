"""Fresh distance evaluations a fit (``FitReport.distance_evals``, the
paper's ledger), over the window."""


def read(run):
    fits = run.fits
    return (sum(f.report.distance_evals for f in fits) / len(fits)
            if fits else None)
