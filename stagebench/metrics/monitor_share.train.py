"""The monitor (`repro_torch.telemetry.collector.Monitor`): its
gather-and-label seconds inside the window over the window's wall
(`Monitor.overhead_fraction`'s ratio), in %; nothing where no monitor
window closed in the window."""


def read(run):
    if run.monitor_windows == 0:
        return None
    return 100.0 * run.monitor_seconds / run.window_s
