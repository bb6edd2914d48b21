"""Hybrid (Hymba): the dense count (parameters and windowed attention)
plus the SSD scan of every layer.  Per chunk of Q tokens the scan
needs, forward: the causal Q (Q + 1) / 2 pairs of C.B (2 N) and of the
decay-weighted sum over the heads' channels (2 H P); each chunk's state
(2 Q N H P); each token's read of the carried state (2 Q N H P).  The
backward is twice that."""
from __future__ import annotations

from ..reference.params import Arch
from .dense import attention_flops, parameters


def scan_flops(arch: Arch, batch: int, seq: int) -> int:
    q = min(arch.ssm_chunk, seq)
    n, hp = arch.ssm_state, arch.d_inner
    per_chunk = q * (q + 1) // 2 * (2 * n + 2 * hp) + 4 * q * n * hp
    return 3 * per_chunk * (seq // q) * arch.n_layers * batch


def step_flops(config: dict, batch: int, seq: int) -> int:
    arch = Arch.from_config(config)
    return (6 * parameters(arch) * batch * seq + attention_flops(arch, batch, seq)
            + scan_flops(arch, batch, seq))
