"""Seconds from the process's start to the first timed posterior: imports,
the CUDA context, the kernels' build or load, the series, the simulator,
the tolerance's pilot and the warm-up posteriors (host clock)."""


def read(run):
    return run.setup_s
