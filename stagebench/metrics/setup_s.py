"""Seconds from process start to the first timed step: imports, the
CUDA context, drawing and loading the weights, building the step, and
the warm-up steps."""


def read(run):
    return run.setup_s
