"""The data layer (`repro_torch.data.pipeline.PrefetchPipeline` and the
host-to-device copy): the recorder's ``data.next_wait`` summed over the
window's steps, over the step count, in ms."""


def read(run):
    if not run.step_records:
        return None
    total = sum(r.durations.get("data.next_wait", 0.0) for r in run.step_records)
    return 1e3 * total / len(run.step_records)
