"""Median time to posterior over the traced run's posteriors (host
clock)."""

import statistics


def read(run):
    return statistics.median(p["ms"] for p in run.posteriors) if run.posteriors else None
