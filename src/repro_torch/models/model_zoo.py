"""Unified model interface: `build_model(cfg)` returns a `Model`.

  init(generator=None, device="cuda") -> the module (the parameters):
                                          TransformerLM, or EncDecLM for encdec
  loss(module, batch, triangular=False)   -> scalar     (train objective)
  forward(module, batch, triangular=False) -> logits    (prefill compute)
  decode_step(module, caches, tokens, index, seq_len) -> (logits, caches)
  init_caches(module, batch, seq_len, device=None, frames=None) -> caches

Batches are dicts of tensors: ``tokens`` and ``labels`` [B, S], and the
stub modality frontend's input where the family needs one: ``frames``
[B, T_enc, D] for encdec (whisper), ``frontend_embeds`` [B, P, D] for
vlm.  Every family of the reference is in the port: dense, moe, ssm,
hybrid, vlm and encdec.  For encdec, `init_caches` runs the encoder
over `frames` (zeros [B, max(seq_len // enc_seq_divisor, 1), D] in the
compute dtype when none are given); the other families ignore them.
``index`` of `decode_step` is a Python int.  The reference's
`input_specs`, `cache_specs` and `param_axes` serve its sharding plans
and dry run, and wait for the port of `distributed/sharding.py`
(`ROADMAP.md` §A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import encdec
from . import transformer as tfm

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., nn.Module]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Any]


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator=None, device="cuda"):
        return encdec.EncDecLM(cfg, device=device, generator=generator)

    def loss(module, batch, *, triangular=False):
        return encdec.encdec_loss(module, batch["frames"], batch["tokens"],
                                  batch["labels"], triangular=triangular)

    def forward(module, batch, *, triangular=False):
        return module(batch["frames"], batch["tokens"], triangular=triangular)

    def decode_step(module, caches, tokens, index: int, seq_len: int):
        return encdec.decode_step_encdec(module, caches, tokens, index)

    def init_caches(module, batch: int, seq_len: int, device=None, frames=None):
        if frames is None:
            t_enc = max(seq_len // cfg.enc_seq_divisor, 1)
            frames = torch.zeros((batch, t_enc, cfg.d_model),
                                 dtype=tfm.torch_dtype(cfg.compute_dtype),
                                 device=module.embed.device if device is None else device)
        return encdec.init_encdec_caches(module, frames, seq_len)

    return Model(cfg=cfg, init=init, loss=loss, forward=forward,
                 decode_step=decode_step, init_caches=init_caches)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return _build_encdec(cfg)

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

    def init_caches(module, batch: int, seq_len: int, device=None, frames=None):
        if device is None:
            device = module.embed.device
        return tfm.init_decode_caches(cfg, batch, seq_len, device)

    return Model(cfg=cfg, init=init, loss=loss, forward=forward,
                 decode_step=decode_step, init_caches=init_caches)
