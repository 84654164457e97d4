"""The abc_sim kernels' share of their roofline, in %: the least time the
card could take for the operations (the configuration's count) and bytes
of the simulated samples, at the published peaks, over the device time of
the kernels whose name holds `abc_sim` (profiler trace)."""

from perfbench.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(s for name, s in run.trace["device_s"].items() if "abc_sim" in name)
    if kernel_s <= 0:
        return None
    samples = sum(p["runs"] for p in run.posteriors) * run.cell.batch
    n_params = len(run.cell.config["prior_highs"])
    least = max(run.ops(samples) / F32_OPS_PER_S, samples * (n_params + 1) * 4 / HBM_BYTES_PER_S)
    return 100.0 * least / kernel_s
