"""The share of the traced window in which no kernel, copy or fill ran on
the card: 1 - the union of the profiler's device intervals over the
window."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
