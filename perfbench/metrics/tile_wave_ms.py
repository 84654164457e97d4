"""The tile route's own device time a wave, in ms: the window's device time
of the kernels whose name holds `_tile_` (the region axis's tile route,
`csrc/abc_sim_regional_tile.cuh`) over the waves run, apart from the loop
around them. Nothing to read where no such kernel ran."""


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(s for name, s in run.trace["device_s"].items() if "_tile_" in name)
    waves = sum(p["runs"] for p in run.posteriors)
    if kernel_s <= 0 or waves <= 0:
        return None
    return 1e3 * kernel_s / waves
