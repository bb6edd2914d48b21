"""The MLP (`transformer.Block._feed_forward`, `layers.apply_mlp`, with its
norm): the device ms a step of the program's region ``mlp`` in all its
phases."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key.startswith("region.mlp."))
