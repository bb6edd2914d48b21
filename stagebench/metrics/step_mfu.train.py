"""The whole step on the device: model FLOPs of the steps traced
(`stagebench.flops`, no recompute) over the traced window's wall, as a
share of the card's dense peak in the configuration's compute type
(`stagebench/peaks.json`), in %."""


def read(run):
    if run.trace is None or not run.trace["steps"] or not run.peak_flops:
        return None
    return 100.0 * run.flops_per_step * run.trace["steps"] / run.trace["window_s"] / run.peak_flops
