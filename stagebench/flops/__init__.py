"""Model FLOPs of one training step, by family.

The benchmark keeps its own count: the operations the forward and
backward passes require, with no recompute (a remat step recomputes its
forward, which is work the program chooses, not work the model needs).
A matrix product of an [m, k] and a [k, n] operand is 2 m k n; a
backward pass is twice its forward.  `step_flops` finds the family's
module here by name (``flops/<family>.py``), so a new family is a new
file.
"""
from __future__ import annotations

import importlib

__all__ = ["step_flops"]


def step_flops(config: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of `config` on [batch, seq] tokens."""
    family = importlib.import_module(f"{__name__}.{config['family']}")
    return float(family.step_flops(config, batch, seq))
