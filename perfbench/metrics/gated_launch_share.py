"""Launches of the cell's wave entry whose gate read 0, over all its
launches in the window: `ENTRY_GATED` over `ENTRY_LAUNCHES` of
`repro_torch.kernels.abc_sim`."""


def read(run):
    n = run.counters["launches"]
    return run.counters["gated"] / n if n else None
