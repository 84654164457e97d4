"""The whole window's share of the card's float32 peak, in %: the
configuration's operations of every simulated sample over the traced
window's seconds times 67 TFLOP/s."""

from perfbench.peaks import F32_OPS_PER_S


def read(run):
    if run.trace is None:
        return None
    samples = sum(p["runs"] for p in run.posteriors) * run.cell.batch
    return 100.0 * run.ops(samples) / (run.trace["window_s"] * F32_OPS_PER_S)
