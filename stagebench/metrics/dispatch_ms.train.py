"""The model step's host side (`repro_torch.launch.steps` train step,
`models/*`, `optim/adamw.py`): the recorder's ``step.dispatch_cpu_wall``
a step over the window, in ms: the time the host takes to enqueue a
step's launches (and the loss's pinned copy)."""


def read(run):
    if not run.step_records:
        return None
    total = sum(r.durations.get("step.dispatch_cpu_wall", 0.0) for r in run.step_records)
    return 1e3 * total / len(run.step_records)
