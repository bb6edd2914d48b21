"""The program's device-timed regions of its train step, as each step's
record carries them in its side channel (`repro_torch.telemetry.regions`):
``region.<name>.<phase>`` (``region.optimizer``, ``region.none``) in
seconds of the stream between the region's boundaries, and
``region.step``, the step's span, on the steps whose regions were on
(the traced window's)."""
from __future__ import annotations

__all__ = ["region_ms"]


def region_ms(run, wanted) -> float | None:
    """Device ms a step of the side values whose key `wanted` accepts:
    summed over the window's steps that carry regions, over their count;
    None where no step does (regions off, or a program without them)."""
    sides = [r.side for r in run.step_records if "region.step" in getattr(r, "side", {})]
    if not sides:
        return None
    total = sum(v for side in sides for key, v in side.items()
                if key != "region.step" and wanted(key))
    return 1e3 * total / len(sides)
