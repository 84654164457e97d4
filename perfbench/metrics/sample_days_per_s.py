"""Sample-days simulated a second: every sample-day of a wave whose gate
was open, over the window's seconds (host clock)."""


def read(run):
    waves = sum(p["runs"] for p in run.posteriors)
    return waves * run.cell.batch * run.days / run.window_s
