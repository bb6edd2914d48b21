"""Decoder-only LM backbone, dense family: pre-norm GQA attention and a
(Sw/Ge)GLU or GELU MLP per layer.

The reference package stacks its layer weights on a leading [L] axis for
`lax.scan`; here each layer is a module of its own (`Block`) and the
forward pass loops over them, with `torch.utils.checkpoint` around each
layer when ``cfg.remat``.  Parameter names follow the reference tree
(``layers.<i>.attn.wq``, ``final_norm.scale``, ...), weights [in, out],
so `params_from_jax` carries its trees across.

Two reference behaviours that follow from the stacked layout are kept:
- weight decay falls on leaves of two or more dimensions *in the
  reference's tree*, where under ``scan_layers`` every per-layer bias and
  norm scale is a stacked [L, d] leaf: `decay_mask` names that set;
- `params_from_jax` splits the [L, ...] axis into the layer modules.

The MoE, SSM, hybrid and VLM families and the decode path are not in
this package yet (`ROADMAP.md` §A).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import chunked_causal_attention
from .layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    cross_entropy_loss,
    dense_init,
    embed_tokens,
    lm_logits,
    mlp_shapes,
)

__all__ = [
    "TransformerLM",
    "decay_mask",
    "lm_loss",
    "params_from_jax",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
            if kind == "ln" else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale, self.bias, self.kind)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)),
                            ("wv", (d, kvd)), ("wo", (qd, d))):
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, shape, dtype, device)))
        if cfg.qkv_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(n, dtype=dtype, device=device)))


class MLP(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        for name, shape in mlp_shapes(cfg.d_model, cfg.d_ff, cfg.act).items():
            w = (dense_init(generator, shape, dtype, device) if len(shape) == 2
                 else torch.zeros(shape, dtype=dtype, device=device))
            self.register_parameter(name, nn.Parameter(w))


class Block(nn.Module):
    """One layer: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.mlp_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.mlp = MLP(cfg, dtype, device, generator)

    def _attention(self, x, positions, triangular):
        cfg, a = self.cfg, self.attn
        h = self.attn_norm(x)
        b, s, _ = h.shape
        q, k, v = h @ a.wq, h @ a.wk, h @ a.wv
        if cfg.qkv_bias:
            q, k, v = q + a.bq, k + a.bk, v + a.bv
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = chunked_causal_attention(
            q,
            k,
            v,
            q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk,
            window=cfg.window if cfg.attention == "sliding" else None,
            triangular=triangular,
            cast_f32=cfg.attn_cast_f32,
            remat_qblock=cfg.attn_remat,
        )
        return out.reshape(b, s, cfg.q_dim) @ a.wo

    def forward(self, x, positions, triangular: bool = False):
        x = x + self._attention(x, positions, triangular)
        return x + apply_mlp(self.mlp, self.mlp_norm(x), self.cfg.act)


class TransformerLM(nn.Module):
    """The dense decoder-only LM of `cfg`, its weights on `device`.

    Weights are drawn in f32 from `generator` (a CPU generator; seed 0
    when None) and cast to ``cfg.param_dtype``: one seed gives the same
    weights on the card and on the CPU.  The embedding doubles as the LM
    head when ``cfg.tie_embeddings``.
    """

    def __init__(self, cfg, *, device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not in the PyTorch "
                "port yet (ROADMAP.md §A)"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TransformerLM(device={str(device)!r}): no CUDA device is "
                "available (pass device='cpu' to run on the CPU)"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype, device, scale=0.02))
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device, generator) for _ in range(cfg.n_layers)
        )
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.head = None if cfg.tie_embeddings else nn.Parameter(dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dtype, device, scale=0.02))

    def forward(self, tokens: torch.Tensor, *, triangular: bool = False) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, Vpad] f32 (the dense family has
        no auxiliary loss)."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, torch_dtype(cfg.compute_dtype))
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.layers:
            if cfg.remat:
                x = checkpoint(layer, x, positions, triangular,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, positions, triangular)
        x = self.final_norm(x)
        return lm_logits(x, self.embed, self.head, cfg.vocab_size)


def lm_loss(
    model: TransformerLM,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    triangular: bool = False,
) -> torch.Tensor:
    logits = model(tokens, triangular=triangular)
    return cross_entropy_loss(logits, labels)


def decay_mask(model: TransformerLM) -> dict[str, bool]:
    """Parameter name -> whether AdamW decays it: leaves of two or more
    dimensions in the reference's tree, where ``scan_layers`` stacks each
    per-layer leaf on an [L] axis (so only `final_norm` escapes there)."""
    stacked = model.cfg.scan_layers
    return {
        name: p.dim() + int(stacked and name.startswith("layers.")) >= 2
        for name, p in model.named_parameters()
    }


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """The reference's `init_lm` tree (leaves as numpy arrays) as a state
    dict of `TransformerLM(cfg)`.  Under ``scan_layers`` each per-layer
    leaf is split off its leading [L] axis; a tied embedding stays one
    parameter (the tree has no ``head``).  Load it with
    ``model.load_state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def put(prefix: str, node) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                put(f"{prefix}.{key}", child)
        else:
            out[prefix] = _to_tensor(node)

    put("embed", tree["embed"])
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        if cfg.scan_layers:
            layer = _index_tree(layers, i)
        else:
            layer = layers[i]
        put(f"layers.{i}", layer)
    put("final_norm", tree["final_norm"])
    if "head" in tree:
        put("head", tree["head"])
    return out


def _index_tree(node, i: int):
    if isinstance(node, dict):
        return {k: _index_tree(v, i) for k, v in node.items()}
    return np.asarray(node)[i]
