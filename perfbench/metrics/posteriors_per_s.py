"""Posteriors completed in the window over its seconds (host clock)."""


def read(run):
    return len(run.posteriors) / run.window_s
