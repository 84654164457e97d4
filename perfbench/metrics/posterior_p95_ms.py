"""95th percentile of the time to posterior over every posterior of the
window: from the call into `run_abc` to its return with the accepted set
on the host (host clock)."""

import statistics


def read(run):
    ms = [p["ms"] for p in run.posteriors]
    return statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else None
