"""The optimizer (`optim/adamw.py` `apply_updates`: the clip norm and
AdamW): the device ms a step of the program's region ``optimizer``."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key == "region.optimizer")
