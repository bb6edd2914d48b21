"""Unified model interface: `build_model(cfg)` returns a `Model`.

  init(generator=None, device="cuda") -> TransformerLM   (the parameters)
  loss(module, batch, triangular=False)   -> scalar     (train objective)
  forward(module, batch, triangular=False) -> logits    (prefill compute)

Batches are dicts of tensors: ``tokens`` and ``labels`` [B, S].  Only the
dense family is in the port; every other family raises.  Decode steps,
caches and the input / cache / sharding specs of the reference's `Model`
belong to later slices (`ROADMAP.md` §A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import transformer as tfm

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., tfm.TransformerLM]
    loss: Callable[..., Any]
    forward: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not in the PyTorch port "
            "yet (ROADMAP.md §A); the port builds the dense family"
        )

    def init(generator=None, device="cuda"):
        return tfm.TransformerLM(cfg, device=device, generator=generator)

    def loss(module, batch, *, triangular=False):
        return tfm.lm_loss(module, batch["tokens"], batch["labels"], triangular=triangular)

    def forward(module, batch, *, triangular=False):
        return module(batch["tokens"], triangular=triangular)

    return Model(cfg=cfg, init=init, loss=loss, forward=forward)
