"""Unified model interface: `build_model(cfg)` returns a `Model`.

  init(generator=None, device="cuda") -> the module (the parameters):
                                          TransformerLM, or EncDecLM for encdec
  loss(module, batch, triangular=False)   -> scalar     (train objective)
  loss_parts(module, batch, triangular=False) -> (ce, aux), loss = ce + aux
  forward(module, batch, triangular=False) -> logits    (prefill compute)
  decode_step(module, caches, tokens, index, seq_len) -> (logits, caches)
  init_caches(module, batch, seq_len, device=None, frames=None) -> caches
  input_specs(shape)                 -> batch of meta tensors
  cache_specs(shape)                 -> caches of meta tensors
  param_axes()                       -> parameter name -> logical axes

Batches are dicts of tensors: ``tokens`` and ``labels`` [B, S], and the
stub modality frontend's input where the family needs one: ``frames``
[B, T_enc, D] for encdec (whisper), ``frontend_embeds`` [B, P, D] for
vlm.  Every family of the reference is in the port: dense, moe, ssm,
hybrid, vlm and encdec.  For encdec, `init_caches` runs the encoder
over `frames` (zeros [B, max(seq_len // enc_seq_divisor, 1), D] in the
compute dtype when none are given); the other families ignore them.
``index`` of `decode_step` is a Python int.

`input_specs` and `cache_specs` give a `ShapeConfig`'s batch and caches
as tensors on the ``meta`` device (shape and dtype, no storage: the
counterpart of the reference's ``jax.ShapeDtypeStruct``); `param_axes`
keys each parameter's logical axes by its `named_parameters()` name.
They serve the sharding plans (`repro_torch.distributed.sharding`) and
the step builders (`repro_torch.launch.steps`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec
from . import transformer as tfm

__all__ = ["Model", "build_model"]

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., nn.Module]
    loss: Callable[..., Any]
    loss_parts: Callable[..., Any]
    forward: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Any]
    input_specs: Callable[[ShapeConfig], dict]
    cache_specs: Callable[[ShapeConfig], dict]
    param_axes: Callable[[], dict]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _spec((b, s), _I32), "labels": _spec((b, s), _I32)}
    if shape.kind == "prefill":
        return {"tokens": _spec((b, s), _I32)}
    return {"tokens": _spec((b, 1), _I32)}


def _vlm_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s, p = shape.global_batch, shape.seq_len, cfg.n_patches
    st = max(s - p, 1)
    emb = _spec((b, p, cfg.d_model), tfm.torch_dtype(cfg.compute_dtype))
    if shape.kind == "train":
        return {"tokens": _spec((b, st), _I32), "labels": _spec((b, st), _I32),
                "frontend_embeds": emb}
    if shape.kind == "prefill":
        return {"tokens": _spec((b, st), _I32), "frontend_embeds": emb}
    return {"tokens": _spec((b, 1), _I32)}


def _encdec_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    t_enc = max(s // cfg.enc_seq_divisor, 1)
    frames = _spec((b, t_enc, cfg.d_model), tfm.torch_dtype(cfg.compute_dtype))
    if shape.kind == "train":
        return {"frames": frames, "tokens": _spec((b, s), _I32),
                "labels": _spec((b, s), _I32)}
    if shape.kind == "prefill":
        return {"frames": frames, "tokens": _spec((b, s), _I32)}
    return {"tokens": _spec((b, 1), _I32), "frames": frames}


def _lm_cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """`tfm.init_decode_caches`' tree: KV caches in the compute dtype (in
    ``cfg.cache_layout``), the SSM's state and conv tail in f32."""
    cd = tfm.torch_dtype(cfg.compute_dtype)
    b, s, n = shape.global_batch, shape.seq_len, cfg.n_layers
    specs: dict[str, torch.Tensor] = {}
    if cfg.family != "ssm":
        c = tfm.cache_len_for(cfg, s)
        if cfg.cache_layout == "bksd":
            kv = (n, b, cfg.n_kv_heads, c, cfg.head_dim)
        else:
            kv = (n, b, c, cfg.n_kv_heads, cfg.head_dim)
        specs["k"] = _spec(kv, cd)
        specs["v"] = _spec(kv, cd)
    if cfg.family in ("ssm", "hybrid"):
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
        specs["ssm_state"] = _spec(
            (n, b, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
        specs["conv"] = _spec((n, b, cfg.ssm_conv_width - 1, conv_dim), torch.float32)
    return specs


def _encdec_cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """`encdec.init_encdec_caches`' tree, always ``bskd``."""
    cd = tfm.torch_dtype(cfg.compute_dtype)
    b, s, n = shape.global_batch, shape.seq_len, cfg.n_layers
    t_enc = max(s // cfg.enc_seq_divisor, 1)
    kv = _spec((n, b, s, cfg.n_kv_heads, cfg.head_dim), cd)
    cross = _spec((n, b, t_enc, cfg.n_kv_heads, cfg.head_dim), cd)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator=None, device="cuda"):
        return encdec.EncDecLM(cfg, device=device, generator=generator)

    def loss(module, batch, *, triangular=False):
        return encdec.encdec_loss(module, batch["frames"], batch["tokens"],
                                  batch["labels"], triangular=triangular)

    def loss_parts(module, batch, *, triangular=False):
        ce = loss(module, batch, triangular=triangular)
        return ce, torch.zeros((), dtype=torch.float32, device=ce.device)

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

    return Model(cfg=cfg, init=init, loss=loss, loss_parts=loss_parts, forward=forward,
                 decode_step=decode_step, init_caches=init_caches,
                 input_specs=lambda shape: _encdec_specs(cfg, shape),
                 cache_specs=lambda shape: _encdec_cache_specs(cfg, shape),
                 param_axes=lambda: encdec.encdec_axes(cfg))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return _build_encdec(cfg)

    def init(generator=None, device="cuda"):
        return tfm.TransformerLM(cfg, device=device, generator=generator)

    def loss_parts(module, batch, *, triangular=False):
        return tfm.lm_loss_parts(module, batch["tokens"], batch["labels"],
                                 frontend_embeds=batch.get("frontend_embeds"),
                                 triangular=triangular)

    def loss(module, batch, *, triangular=False):
        ce, aux = loss_parts(module, batch, triangular=triangular)
        return ce + aux

    def forward(module, batch, *, triangular=False):
        return module(batch["tokens"], frontend_embeds=batch.get("frontend_embeds"),
                      triangular=triangular)

    def decode_step(module, caches, tokens, index: int, seq_len: int):
        return tfm.decode_step_lm(module, caches, tokens, index, seq_len)

    def init_caches(module, batch: int, seq_len: int, device=None, frames=None):
        if device is None:
            device = module.embed.device
        return tfm.init_decode_caches(cfg, batch, seq_len, device)

    specs = _vlm_specs if cfg.family == "vlm" else _lm_specs
    return Model(cfg=cfg, init=init, loss=loss, loss_parts=loss_parts, forward=forward,
                 decode_step=decode_step, init_caches=init_caches,
                 input_specs=lambda shape: specs(cfg, shape),
                 cache_specs=lambda shape: _lm_cache_specs(cfg, shape),
                 param_axes=lambda: tfm.lm_axes(cfg))
