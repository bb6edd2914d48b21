"""Device activities (kernels, copies, sets) in the traced window, over
the steps traced."""


def read(run):
    if run.trace is None or not run.trace["steps"]:
        return None
    return run.trace["launches"] / run.trace["steps"]
