"""The SSD mixer past its input norm (`ssm.apply_ssm`: the input
projection, the conv, the chunked scan, the gate and its norm, the
output projection): the device ms a step of the program's regions
``ssm`` and ``ssm_scan`` (nested in it) in all their phases (forward,
remat recompute, backward)."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key.startswith(("region.ssm.", "region.ssm_scan.")))
