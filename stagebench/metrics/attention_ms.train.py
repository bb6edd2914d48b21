"""Attention (`transformer.Block._attention`, `attention.chunked_causal_attention`):
the device ms a step of the program's region ``attention`` in all its
phases (forward, remat recompute, backward)."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key.startswith("region.attention."))
