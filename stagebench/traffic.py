"""The token stream a cell feeds the program, from ``--seed``.

The benchmark's own copy of the port's synthetic generator
(`repro_torch.data.pipeline.SyntheticTokens`): batch t is a pure
function of (seed, t), every row different, tokens power-law tilted
(``vocab * u ** tilt``) so the stream has unigram structure, labels the
next token.  A traffic file (``stagebench/traffic/<name>.json``) gives
the batch, the sequence length, the tilt, the prefetch depth and an
optional stall of the producer (``stall_ms`` every ``stall_every``
batches).
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenStream", "stall_of"]


class TokenStream:
    """Batches ``{"tokens", "labels"}`` of int32 [batch, seq]."""

    def __init__(self, vocab_size: int, traffic: dict, seed: int):
        self.vocab_size = vocab_size
        self.batch = traffic["batch"]
        self.seq = traffic["seq"]
        self.tilt = traffic["tilt"]
        self.seed = seed

    def batch_at(self, cursor: int) -> dict[str, np.ndarray]:
        key = (self.seed * 0x9E3779B97F4A7C15 + cursor + 1) % (2**63)
        u = np.random.default_rng(key).random(size=(self.batch, self.seq + 1))
        tokens = np.minimum((self.vocab_size * u ** self.tilt).astype(np.int32),
                            self.vocab_size - 1)
        return {"tokens": np.ascontiguousarray(tokens[:, :-1]),
                "labels": np.ascontiguousarray(tokens[:, 1:])}


def stall_of(traffic: dict):
    """The producer's stall in seconds before batch t, or None."""
    every, ms = traffic.get("stall_every", 0), traffic.get("stall_ms", 0)
    if not every or not ms:
        return None
    return lambda t: ms / 1e3 if t % every == 0 else 0.0
