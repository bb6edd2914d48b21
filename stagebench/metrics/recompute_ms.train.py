"""Remat (the `torch.utils.checkpoint` re-runs of the layers and of the
attention's query blocks in the backward): the device ms a step of every
region's ``recompute`` phase.  It overlaps the other regions' metrics by
design: it is their recompute phases summed."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key.endswith(".recompute"))
