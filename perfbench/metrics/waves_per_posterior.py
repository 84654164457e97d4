"""Waves a posterior, the mean of `Posterior.runs` over the window (the
program's count of waves whose gate was open)."""

import statistics


def read(run):
    return statistics.fmean(p["runs"] for p in run.posteriors) if run.posteriors else None
