"""The SSD's chunked scan (`ssm._ssd`): the device ms a step of the
program's region ``ssm_scan`` in all its phases (forward, remat
recompute, backward); None where no step carries it (regions off, or a
program that does not mark the scan apart from the rest of ``ssm``)."""
from stagebench.regions import region_ms


def _scan(key: str) -> bool:
    return key.startswith("region.ssm_scan.")


def read(run):
    if not any(_scan(key) for r in run.step_records for key in getattr(r, "side", {})):
        return None
    return region_ms(run, _scan)
