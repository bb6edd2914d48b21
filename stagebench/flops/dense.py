"""Dense decoder: 6 FLOPs a parameter a token (forward 2, backward 4;
the tied head is the embedding's product), plus causal attention:
per layer and sequence, the scores and the weighted sum over the
positions each query sees, s (s + 1) / 2 pairs of 2 x 2 x q_dim FLOPs
forward, three times that with the backward."""
from __future__ import annotations

import math

from ..reference.params import Arch, param_layout


def parameters(arch: Arch) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_layout(arch))


def visible_pairs(arch: Arch, seq: int) -> int:
    """(query, key) pairs a sequence's attention computes, under the
    causal mask and the window where there is one."""
    if arch.window is None:
        return seq * (seq + 1) // 2
    w = min(arch.window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def attention_flops(arch: Arch, batch: int, seq: int) -> int:
    q_dim = arch.n_heads * arch.head_dim
    return 3 * 4 * q_dim * visible_pairs(arch, seq) * arch.n_layers * batch


def step_flops(config: dict, batch: int, seq: int) -> int:
    arch = Arch.from_config(config)
    return 6 * parameters(arch) * batch * seq + attention_flops(arch, batch, seq)
