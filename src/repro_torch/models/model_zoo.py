"""Unified model interface: `build_model(cfg)` returns a `Model`.

  init(generator=None, device="cuda") -> TransformerLM   (the parameters)
  loss(module, batch, triangular=False)   -> scalar     (train objective)
  forward(module, batch, triangular=False) -> logits    (prefill compute)
  decode_step(module, caches, tokens, index, seq_len) -> (logits, caches)
  init_caches(module, batch, seq_len, device=None)    -> caches

Batches are dicts of tensors: ``tokens`` and ``labels`` [B, S], and
``frontend_embeds`` [B, P, D] for the vlm family.  The decoder-only
families (dense, moe, ssm, hybrid, vlm) are in the port; `encdec`
raises.  ``index`` of `decode_step` is a Python int.  The reference's
`input_specs`, `cache_specs` and `param_axes` serve its sharding plans
and dry run, and wait for the port of `distributed/sharding.py`
(`ROADMAP.md` §A).
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
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: family 'encdec' is not in the PyTorch port yet "
            "(ROADMAP.md §A); the port builds the decoder-only families"
        )

    def init(generator=None, device="cuda"):
        return tfm.TransformerLM(cfg, device=device, generator=generator)

    def loss(module, batch, *, triangular=False):
        return tfm.lm_loss(module, batch["tokens"], batch["labels"],
                           frontend_embeds=batch.get("frontend_embeds"),
                           triangular=triangular)

    def forward(module, batch, *, triangular=False):
        return module(batch["tokens"], frontend_embeds=batch.get("frontend_embeds"),
                      triangular=triangular)

    def decode_step(module, caches, tokens, index: int, seq_len: int):
        return tfm.decode_step_lm(module, caches, tokens, index, seq_len)

    def init_caches(module, batch: int, seq_len: int, device=None):
        if device is None:
            device = module.embed.device
        return tfm.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg=cfg, init=init, loss=loss, forward=forward,
                 decode_step=decode_step, init_caches=init_caches)
