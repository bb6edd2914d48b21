"""Whisper-style encoder-decoder backbone (transformer only).

The audio conv frontend is a stub, as in the reference package: frames
arrive as [B, T_enc, D] embeddings (T_enc = seq / ``enc_seq_divisor``)
and the encoder consumes them directly.  Positions are sinusoidal on
both sides.  The family has no RoPE and no qkv bias (its projections are
plain products), its attention is f32 whatever ``attn_cast_f32`` says,
and the embedding is always the LM head.

Parameter names follow the reference tree, weights [in, out]:
``embed``; ``enc_layers.<i>.{attn_norm, attn.{wq,wk,wv,wo}, mlp_norm,
mlp.*}``; ``dec_layers.<i>`` with the same plus ``cross_norm`` and
``cross.{wq,wk,wv,wo}``; ``enc_final_norm``; ``dec_final_norm``.  So
`transformer.params_from_jax` carries the reference's trees across.

Decode keeps the reference's cache tree ``{"k", "v", "cross_k",
"cross_v"}`` of stacked [L, B, S, KV, D] tensors, always in the ``bskd``
layout (the reference ignores ``cache_layout`` for this family).  The
self-attention caches are written in place; the cross K/V are computed
once, from the encoder pass, by `init_encdec_caches`, and only read.
With a serve step's `TensorParallel` context both attentions run on the
rank's slices of their caches (`transformer.tp_decode_attention`; the
cross K/V split over the model axis along the encoder's time, read
with no mask).

Two behaviours of the reference are kept (`ROADMAP.md` §C):
- each decode step adds the sinusoid of position 0, whatever its index,
  so decode logits part from the teacher-forced forward after position 0;
- a batch must carry ``frames``, which the synthetic token pipeline does
  not make, so the train driver fails on this family (``KeyError``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.tensor_parallel import gathered
from .attention import (
    chunked_causal_attention,
    decode_attention,
    full_cross_attention,
    update_kv_cache,
)
from .layers import (
    apply_mlp,
    cross_entropy_loss,
    dense_init,
    embed_tokens,
    lm_logits,
    mlp_axes,
    norm_axes,
    vocab_parallel,
)
from .transformer import (
    LAYER_STACKS,
    MLP,
    Attention,
    Norm,
    _run_layer,
    attn_axes,
    check_device,
    flat_axes,
    torch_dtype,
    tp_attention,
    tp_decode_attention,
)

__all__ = [
    "EncDecLM",
    "decode_step_encdec",
    "encdec_axes",
    "encdec_loss",
    "init_encdec_caches",
    "sinusoidal_positions",
]


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """[seq, d] f32: sin then cos (concatenated, not interleaved) of
    pos / 10000 ** (2 i / d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, head_dim)


def encdec_axes(cfg) -> dict[str, tuple]:
    """Parameter name (as `EncDecLM.named_parameters` gives it) -> logical
    axes, one per dimension."""
    enc_layer = {
        "attn_norm": norm_axes(cfg.norm),
        "attn": attn_axes(cfg),
        "mlp_norm": norm_axes(cfg.norm),
        "mlp": mlp_axes(cfg.act),
    }
    dec_layer = dict(enc_layer, cross_norm=norm_axes(cfg.norm), cross=attn_axes(cfg))
    axes = {"embed": ("vocab", "embed")}
    for i in range(cfg.n_enc_layers):
        axes.update(flat_axes(enc_layer, f"enc_layers.{i}."))
    for i in range(cfg.n_layers):
        axes.update(flat_axes(dec_layer, f"dec_layers.{i}."))
    axes.update(flat_axes(norm_axes(cfg.norm), "enc_final_norm."))
    axes.update(flat_axes(norm_axes(cfg.norm), "dec_final_norm."))
    return axes


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention, then the MLP."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.mlp_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.mlp = MLP(cfg, dtype, device, generator)

    def _qkv(self, x):
        cfg, a = self.cfg, self.attn
        h = self.attn_norm(x)
        return (_split_heads(h @ a.wq, cfg.n_heads, cfg.head_dim),
                _split_heads(h @ a.wk, cfg.n_kv_heads, cfg.head_dim),
                _split_heads(h @ a.wv, cfg.n_kv_heads, cfg.head_dim))

    def _mlp(self, x, tp=None):
        """x plus its MLP."""
        return x + apply_mlp(self.mlp, self.mlp_norm(x), self.cfg.act, tp)

    def forward(self, x, tp=None):
        b, t, _ = x.shape
        if tp is not None and tp.size > 1:
            h = self.attn_norm(x)
            return self._mlp(x + tp_attention(tp, self.cfg, self.attn, h, h,
                                              full_cross_attention), tp)
        out = full_cross_attention(*self._qkv(x))
        return self._mlp(x + out.reshape(b, t, self.cfg.q_dim) @ self.attn.wo)


class DecoderLayer(EncoderLayer):
    """Causal self-attention, cross-attention over the encoder states,
    then the MLP, each pre-norm and residual."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__(cfg, dtype, device, generator)
        self.cross_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.cross = Attention(cfg, dtype, device, generator)

    def cross_kv(self, enc_out):
        """The encoder states' keys and values, [B, T_enc, KV, D] each."""
        cfg = self.cfg
        return (_split_heads(enc_out @ self.cross.wk, cfg.n_kv_heads, cfg.head_dim),
                _split_heads(enc_out @ self.cross.wv, cfg.n_kv_heads, cfg.head_dim))

    def _cross(self, x, ek, ev):
        """x plus its cross-attention over the keys ek and values ev."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = _split_heads(self.cross_norm(x) @ self.cross.wq, cfg.n_heads, cfg.head_dim)
        return x + full_cross_attention(q, ek, ev).reshape(b, s, cfg.q_dim) @ self.cross.wo

    def forward(self, x, enc_out, triangular: bool = False, tp=None):
        cfg = self.cfg
        b, s, _ = x.shape

        def causal(q, k, v, q_blocks=None, q_chunk=cfg.attn_q_chunk):
            return chunked_causal_attention(
                q, k, v, q_chunk=q_chunk, kv_chunk=cfg.attn_kv_chunk,
                triangular=triangular, q_blocks=q_blocks,
            )

        if tp is not None and tp.size > 1:
            h = self.attn_norm(x)
            x = x + tp_attention(tp, cfg, self.attn, h, h, causal, q_chunk=cfg.attn_q_chunk)
            x = x + tp_attention(tp, cfg, self.cross, self.cross_norm(x), enc_out,
                                 full_cross_attention)
            return self._mlp(x, tp)
        x = x + causal(*self._qkv(x)).reshape(b, s, cfg.q_dim) @ self.attn.wo
        return self._mlp(self._cross(x, *self.cross_kv(enc_out)))

    def decode(self, x_tok, layer_cache, index: int, tp=None):
        """One token at position `index`: its k, v written into the
        layer's cache slices in place, attention over ``index + 1``
        positions, then cross-attention over the stored cross K/V."""
        cfg = self.cfg
        b = x_tok.shape[0]
        if tp is not None:
            x = x_tok + tp_decode_attention(tp, cfg, self.attn, self.attn_norm(x_tok),
                                            layer_cache, index + 1, write=index)
            t_enc = layer_cache["cross_k"].shape[1] * (
                tp.size if "cross_k" in tp.caches else 1)
            x = x + tp_decode_attention(tp, cfg, self.cross, self.cross_norm(x), layer_cache,
                                        t_enc, keys=("cross_k", "cross_v"))
            return self._mlp(x, tp)
        q, k, v = self._qkv(x_tok)
        kc, vc = update_kv_cache(layer_cache["k"], layer_cache["v"], k, v, index)
        out = decode_attention(q, kc, vc, index + 1)
        x = x_tok + out.reshape(b, 1, cfg.q_dim) @ self.attn.wo
        return self._mlp(self._cross(x, layer_cache["cross_k"], layer_cache["cross_v"]))


class EncDecLM(nn.Module):
    """The encoder-decoder model of `cfg`, its weights on `device`.

    Weights are drawn in f32 from `generator` (a CPU generator; seed 0
    when None) and cast to ``cfg.param_dtype``, so one seed gives the
    same weights on the card and on the CPU.  Each layer runs under
    `torch.utils.checkpoint` when ``cfg.remat`` and gradients are on.
    """

    def __init__(self, cfg, *, device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = check_device(type(self).__name__, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype, device, scale=0.02))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, device, generator) for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, generator) for _ in range(cfg.n_layers))
        self.enc_final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.dec_final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)

    def _layer(self, layer, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(_run_layer, layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return _run_layer(layer, *args)

    def encode(self, frames: torch.Tensor, tp=None) -> torch.Tensor:
        """frames [B, T_enc, D] (stub embeddings) -> encoder states."""
        cd = torch_dtype(self.cfg.compute_dtype)
        _, t, d = frames.shape
        x = frames.to(cd) + sinusoidal_positions(t, d, frames.device).to(cd)[None]
        for layer in self.enc_layers:
            x = self._layer(layer, x, tp)
        return self.enc_final_norm(x)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor, *,
                triangular: bool = False, tp=None) -> torch.Tensor:
        """Teacher-forced decoder logits [B, S, Vpad] (f32; this rank's
        vocab columns under a vocab-split `TensorParallel` `tp`).  A
        weight `tp` stores split over batch axes is gathered where it is
        used: a layer's in that layer, the others for the pass."""
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        enc_out = self.encode(frames, tp)
        with gathered(tp, self, skip=LAYER_STACKS):
            x = embed_tokens(self.embed, tokens, cd, tp)
            x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device).to(cd)[None]
            for layer in self.dec_layers:
                x = self._layer(layer, x, enc_out, triangular, tp)
            x = self.dec_final_norm(x)
            return lm_logits(x, self.embed, None, cfg.vocab_size, tp)


def encdec_loss(model: EncDecLM, frames, tokens, labels, *, triangular=False, tp=None):
    logits = model(frames, tokens, triangular=triangular, tp=tp)
    return cross_entropy_loss(logits, labels, vocab_parallel(model.embed, None, tp))


@torch.no_grad()
def init_encdec_caches(model: EncDecLM, frames: torch.Tensor, seq_len: int) -> dict:
    """Zeroed self-attention caches [L, B, seq_len, KV, D] in the compute
    dtype, and each decoder layer's cross K/V of one encoder pass over
    `frames`, stacked [L, B, T_enc, KV, D]."""
    cfg = model.cfg
    enc_out = model.encode(frames)
    pairs = [layer.cross_kv(enc_out) for layer in model.dec_layers]
    shape = (cfg.n_layers, frames.shape[0], seq_len, cfg.n_kv_heads, cfg.head_dim)
    cd = torch_dtype(cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=cd, device=enc_out.device),
        "v": torch.zeros(shape, dtype=cd, device=enc_out.device),
        "cross_k": torch.stack([k for k, _ in pairs]),
        "cross_v": torch.stack([v for _, v in pairs]),
    }


@torch.inference_mode()
def decode_step_encdec(model: EncDecLM, caches: dict, tokens: torch.Tensor,
                       index: int, tp=None) -> tuple[torch.Tensor, dict]:
    """One serve step of tokens [B, 1] at position `index` (a Python
    int): (logits [B, 1, Vpad] f32, caches), the self-attention caches
    written in place.  Adds the sinusoid of position 0 at every index,
    as the reference does.  `tp`: a serve step's context
    (`transformer.decode_step_lm`)."""
    cfg = model.cfg
    cd = torch_dtype(cfg.compute_dtype)
    with gathered(tp, model, skip=LAYER_STACKS):
        x = embed_tokens(model.embed, tokens, cd, tp)
        x = x + sinusoidal_positions(1, cfg.d_model, x.device).to(cd)[None]
        for i, layer in enumerate(model.dec_layers):
            with gathered(tp, layer):
                x = layer.decode(x, {name: c[i] for name, c in caches.items()}, index, tp)
        x = model.dec_final_norm(x)
        return lm_logits(x, model.embed, None, cfg.vocab_size, tp), caches
