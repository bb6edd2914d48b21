"""The head and the loss (the final norm, `layers.lm_logits`,
`layers.cross_entropy_loss`): the device ms a step of the program's region
``head_loss`` in all its phases."""
from stagebench.regions import region_ms


def read(run):
    return region_ms(run, lambda key: key.startswith("region.head_loss."))
