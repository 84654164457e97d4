"""The device loop's host syncs a posterior: the change of
`repro_torch.core.abc.HOST_SYNCS` over the window, over the posteriors."""


def read(run):
    return run.counters["host_syncs"] / len(run.posteriors) if run.posteriors else None
