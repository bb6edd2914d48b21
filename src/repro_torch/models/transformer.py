"""Decoder-only LM backbone for the dense / moe / ssm / hybrid / vlm
families.

Families:
  dense   pre-norm GQA attention + (Sw/Ge)GLU or GELU MLP
  moe     attention + top-k expert MLP (`moe.py`)
  ssm     Mamba-2 SSD mixer only (attention-free, no MLP)
  hybrid  Hymba-style parallel attention + SSD heads, then MLP
  vlm     dense backbone consuming [patch embeds ; token embeds]

The reference package stacks its layer weights on a leading [L] axis for
`lax.scan`; here each layer is a module of its own (`Block`) and the
forward pass loops over them, with `torch.utils.checkpoint` around each
layer when ``cfg.remat``.  Parameter names follow the reference tree
(``layers.<i>.attn.wq``, ``layers.<i>.ssm.A_log``, ``layers.<i>.moe.router``,
``final_norm.scale``, ...), weights [in, out], so `params_from_jax`
carries its trees across.

Two reference behaviours that follow from the stacked layout are kept:
- weight decay falls on leaves of two or more dimensions *in the
  reference's tree*, where under ``scan_layers`` every per-layer bias and
  norm scale is a stacked [L, d] leaf: `decay_mask` names that set;
- `params_from_jax` splits the [L, ...] axis into the layer modules.

The logical sharding axes (`lm_axes`, from `block_axes`, `attn_axes` and
the layers' own helpers) are keyed by the names `named_parameters()`
gives.  The reference stacks each per-layer leaf under ``scan_layers``
with a leading ``"layer"`` axis; every plan replicates that axis, and
here each layer's leaf has its own name and no such axis.

Decode (`decode_step_lm`) keeps the reference's cache tree: a dict
``{"k", "v"[, "ssm_state", "conv"]}`` of stacked [L, ...] tensors, the KV
caches in the ``bskd`` or ``bksd`` layout.  Each layer's slice is written
in place and the same dict returned; the reference donates its caches,
so the values are the same.  ``index`` is a Python int, so the ring
buffer's write position and the valid length need no device sync.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import moe as moe_lib
from . import ssm as ssm_lib
from .attention import (
    chunked_causal_attention,
    decode_attention,
    decode_attention_bksd,
    update_kv_cache,
    update_kv_cache_bksd,
)
from .layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    cross_entropy_loss,
    dense_init,
    embed_tokens,
    lm_logits,
    mlp_axes,
    mlp_shapes,
    norm_axes,
)

__all__ = [
    "TransformerLM",
    "attn_axes",
    "block_axes",
    "cache_len_for",
    "check_device",
    "decay_mask",
    "decode_step_lm",
    "init_decode_caches",
    "flat_axes",
    "lm_axes",
    "lm_loss",
    "lm_loss_parts",
    "params_from_jax",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _has_attention(cfg) -> bool:
    return cfg.family != "ssm"


def _has_ssm(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_moe(cfg) -> bool:
    # n_experts == 0 with family "moe" drops the expert blocks entirely
    return cfg.family == "moe" and cfg.n_experts > 0


def _has_mlp(cfg) -> bool:
    return cfg.d_ff > 0 and cfg.family != "moe"


def check_device(owner: str, device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no card
    is there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(device)!r}): no CUDA device is "
            "available (pass device='cpu' to run on the CPU)"
        )
    return device


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
    """One layer of the family: the mixer(s) (attention, SSD or both in
    parallel), then the expert block or the MLP, each pre-norm and
    residual."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        if _has_attention(cfg):
            self.attn_norm = Norm(d, cfg.norm, dtype, device)
            self.attn = Attention(cfg, dtype, device, generator)
        if _has_ssm(cfg):
            self.ssm_norm = Norm(d, cfg.norm, dtype, device)
            self.ssm = ssm_lib.SSM(cfg, dtype, device, generator)
        if cfg.family == "hybrid":
            # per-path output norms for the parallel-head average
            self.attn_out_norm = Norm(d, "rms", dtype, device)
            self.ssm_out_norm = Norm(d, "rms", dtype, device)
        if _has_moe(cfg):
            self.moe_norm = Norm(d, cfg.norm, dtype, device)
            self.moe = moe_lib.MoE(cfg, dtype, device, generator)
        if _has_mlp(cfg):
            self.mlp_norm = Norm(d, cfg.norm, dtype, device)
            self.mlp = MLP(cfg, dtype, device, generator)

    def _qkv(self, x, positions):
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
        return q, k, v

    def _attention(self, x, positions, triangular):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
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
        return out.reshape(b, s, cfg.q_dim) @ self.attn.wo

    def _attention_decode(self, x_tok, layer_cache, pos, index, cache_len):
        """x_tok: [B, 1, D] at absolute position `index` (`pos` holds it
        on the device); writes k, v into the layer's cache slices."""
        cfg = self.cfg
        b = x_tok.shape[0]
        # rope at the absolute position, before the write
        q, k, v = self._qkv(x_tok, pos)
        write = index % cache_len  # ring buffer for sliding windows
        length = min(index + 1, cache_len)
        if cfg.cache_layout == "bksd":
            kc, vc = update_kv_cache_bksd(layer_cache["k"], layer_cache["v"], k, v, write)
            out = decode_attention_bksd(q, kc, vc, length, cast_f32=cfg.attn_cast_f32)
        else:
            kc, vc = update_kv_cache(layer_cache["k"], layer_cache["v"], k, v, write)
            out = decode_attention(q, kc, vc, length, cast_f32=cfg.attn_cast_f32)
        return out.reshape(b, 1, cfg.q_dim) @ self.attn.wo

    def _ssm_decode(self, h, layer_cache):
        out, new = ssm_lib.decode_ssm(
            self.ssm, {"state": layer_cache["ssm_state"], "conv": layer_cache["conv"]},
            h, self.cfg,
        )
        layer_cache["ssm_state"].copy_(new["state"])
        layer_cache["conv"].copy_(new["conv"])
        return out

    def _mix(self, attn_out, ssm_out):
        """The hybrid's parallel-head average."""
        return 0.5 * (self.attn_out_norm(attn_out) + self.ssm_out_norm(ssm_out))

    def _feed_forward(self, x):
        """The expert block or the MLP: (x, aux), aux None without experts."""
        aux = None
        if _has_moe(self.cfg):
            y, aux = self.moe(self.moe_norm(x))
            x = x + y
        if _has_mlp(self.cfg):
            x = x + apply_mlp(self.mlp, self.mlp_norm(x), self.cfg.act)
        return x, aux

    def forward(self, x, positions, triangular: bool = False):
        """One layer. Returns (x, aux or None)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            attn_out = self._attention(x, positions, triangular)
            ssm_out = ssm_lib.apply_ssm(self.ssm, self.ssm_norm(x), cfg)
            x = x + self._mix(attn_out, ssm_out)
        else:
            if _has_attention(cfg):
                x = x + self._attention(x, positions, triangular)
            if _has_ssm(cfg):
                x = x + ssm_lib.apply_ssm(self.ssm, self.ssm_norm(x), cfg)
        return self._feed_forward(x)

    def decode(self, x_tok, layer_cache, pos, index: int, cache_len: int):
        """One layer of one decode step; the layer's caches (views into
        the stacked tensors) are written in place."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            attn_out = self._attention_decode(x_tok, layer_cache, pos, index, cache_len)
            ssm_out = self._ssm_decode(self.ssm_norm(x_tok), layer_cache)
            x_tok = x_tok + self._mix(attn_out, ssm_out)
        else:
            if _has_attention(cfg):
                x_tok = x_tok + self._attention_decode(
                    x_tok, layer_cache, pos, index, cache_len)
            if _has_ssm(cfg):
                x_tok = x_tok + self._ssm_decode(self.ssm_norm(x_tok), layer_cache)
        return self._feed_forward(x_tok)[0]


def attn_axes(cfg) -> dict:
    """Logical axes of `Attention`'s parameters.  The KV projections carry
    their own axis: a plan may replicate them where n_kv_heads does not
    divide the tensor-parallel degree."""
    p = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)})
    return p


def block_axes(cfg) -> dict:
    """Logical axes of one `Block`, nested as its submodules."""
    ax: dict = {}
    if _has_attention(cfg):
        ax["attn_norm"] = norm_axes(cfg.norm)
        ax["attn"] = attn_axes(cfg)
    if _has_ssm(cfg):
        ax["ssm_norm"] = norm_axes(cfg.norm)
        ax["ssm"] = ssm_lib.ssm_axes()
    if cfg.family == "hybrid":
        ax["attn_out_norm"] = norm_axes("rms")
        ax["ssm_out_norm"] = norm_axes("rms")
    if _has_moe(cfg):
        ax["moe_norm"] = norm_axes(cfg.norm)
        ax["moe"] = moe_lib.moe_axes()
    if _has_mlp(cfg):
        ax["mlp_norm"] = norm_axes(cfg.norm)
        ax["mlp"] = mlp_axes(cfg.act)
    return ax


def flat_axes(tree: dict, prefix: str = "") -> dict[str, tuple]:
    """A nested dict of axis tuples, keyed by dotted parameter names."""
    out: dict[str, tuple] = {}
    for key, node in tree.items():
        name = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(flat_axes(node, name + "."))
        else:
            out[name] = tuple(node)
    return out


def lm_axes(cfg) -> dict[str, tuple]:
    """Parameter name (as `TransformerLM.named_parameters` gives it) ->
    logical axes, one per dimension."""
    axes = {"embed": ("vocab", "embed")}
    for i in range(cfg.n_layers):
        axes.update(flat_axes(block_axes(cfg), f"layers.{i}."))
    axes.update(flat_axes(norm_axes(cfg.norm), "final_norm."))
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


class TransformerLM(nn.Module):
    """The decoder-only LM of `cfg`, its weights on `device`.

    Weights are drawn in f32 from `generator` (a CPU generator; seed 0
    when None) and cast to ``cfg.param_dtype``, except the leaves the
    reference keeps in f32 (the SSM's `A_log`, `D`, `dt_bias` and the MoE
    router): one seed gives the same weights on the card and on the CPU.
    The embedding doubles as the LM head when ``cfg.tie_embeddings``.
    """

    def __init__(self, cfg, *, device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: family 'encdec' is built by EncDecLM "
                "(models/encdec.py), not TransformerLM"
            )
        device = check_device(type(self).__name__, device)
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

    def forward_lm(
        self,
        tokens: torch.Tensor,
        *,
        frontend_embeds: torch.Tensor | None = None,
        triangular: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: [B, S_text] -> (logits [B, S, Vpad] f32, moe aux loss []).

        For vlm, frontend_embeds [B, P, D] are prepended and S = P + S_text.
        """
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        x = embed_tokens(self.embed, tokens, cd)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(cd), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            if cfg.remat:
                x, a = checkpoint(layer, x, positions, triangular,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = layer(x, positions, triangular)
            if a is not None:
                aux = aux + a
        x = self.final_norm(x)
        return lm_logits(x, self.embed, self.head, cfg.vocab_size), aux

    def forward(self, tokens: torch.Tensor, *, frontend_embeds=None,
                triangular: bool = False) -> torch.Tensor:
        """tokens: [B, S_text] -> logits [B, S, Vpad] f32."""
        return self.forward_lm(tokens, frontend_embeds=frontend_embeds,
                               triangular=triangular)[0]


def lm_loss_parts(
    model: TransformerLM,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    frontend_embeds: torch.Tensor | None = None,
    moe_aux_weight: float = 0.01,
    triangular: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy, weighted MoE aux) whose sum is `lm_loss`: the
    first a mean over supervised tokens, the second over dispatch groups
    (zero without experts)."""
    logits, aux = model.forward_lm(
        tokens, frontend_embeds=frontend_embeds, triangular=triangular)
    if frontend_embeds is not None:
        # labels only cover text positions; patch positions are unsupervised
        logits = logits[:, frontend_embeds.shape[1]:, :]
    return cross_entropy_loss(logits, labels), moe_aux_weight * aux


def lm_loss(
    model: TransformerLM,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    frontend_embeds: torch.Tensor | None = None,
    moe_aux_weight: float = 0.01,
    triangular: bool = False,
) -> torch.Tensor:
    ce, aux = lm_loss_parts(model, tokens, labels, frontend_embeds=frontend_embeds,
                            moe_aux_weight=moe_aux_weight, triangular=triangular)
    return ce + aux


# ---------------------------------------------------------------------------
# Decode (single-token serve step with per-layer caches)
# ---------------------------------------------------------------------------


def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.attention == "sliding":
        return min(seq_len, cfg.window)
    return seq_len


def init_decode_caches(cfg, batch: int, seq_len: int, device) -> dict:
    """Stacked per-layer caches ([L, ...] leaves): KV caches in the
    compute dtype, the SSM's state and conv tail in f32."""
    cd = torch_dtype(cfg.compute_dtype)
    n = cfg.n_layers
    caches: dict[str, torch.Tensor] = {}
    if _has_attention(cfg):
        c = cache_len_for(cfg, seq_len)
        if cfg.cache_layout == "bksd":
            shape = (n, batch, cfg.n_kv_heads, c, cfg.head_dim)
        else:
            shape = (n, batch, c, cfg.n_kv_heads, cfg.head_dim)
        caches["k"] = torch.zeros(shape, dtype=cd, device=device)
        caches["v"] = torch.zeros(shape, dtype=cd, device=device)
    if _has_ssm(cfg):
        one = ssm_lib.init_ssm_cache(cfg, batch, device)
        caches["ssm_state"] = one["state"][None].repeat(n, 1, 1, 1, 1)
        caches["conv"] = one["conv"][None].repeat(n, 1, 1, 1)
    return caches


@torch.inference_mode()
def decode_step_lm(
    model: TransformerLM,
    caches: dict,
    tokens: torch.Tensor,   # [B, 1] current tokens
    index: int,             # absolute position of this token
    seq_len: int,
) -> tuple[torch.Tensor, dict]:
    """One serve step: (logits [B, 1, Vpad] f32, caches), the caches
    written in place."""
    cfg = model.cfg
    x = embed_tokens(model.embed, tokens, torch_dtype(cfg.compute_dtype))
    cache_len = cache_len_for(cfg, seq_len)
    pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
    for i, layer in enumerate(model.layers):
        layer_cache = {name: c[i] for name, c in caches.items()}
        x = layer.decode(x, layer_cache, pos, index, cache_len)
    x = model.final_norm(x)
    return lm_logits(x, model.embed, model.head, cfg.vocab_size), caches


#: the per-layer stacks of the reference's trees: ``layers`` of the
#: decoder-only families, ``enc_layers`` and ``dec_layers`` of encdec
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether AdamW decays it: leaves of two or more
    dimensions in the reference's tree, where ``scan_layers`` stacks each
    per-layer leaf on an [L] axis (so only the final norms escape there)."""
    stacked = model.cfg.scan_layers
    return {
        name: p.dim() + int(stacked and name.split(".")[0] in LAYER_STACKS) >= 2
        for name, p in model.named_parameters()
    }


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """The reference's `init_lm` or `init_encdec` tree (leaves as numpy
    arrays) as a state dict of `TransformerLM(cfg)` or `EncDecLM(cfg)`.
    Each layer stack (`LAYER_STACKS`) is split into its layers: off the
    leading [L] axis of every leaf under ``scan_layers``, else from the
    list; a tied embedding stays one parameter (the tree has no
    ``head``).  Load it with ``model.load_state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def put(prefix: str, node) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                put(f"{prefix}.{key}", child)
        else:
            out[prefix] = _to_tensor(node)

    counts = {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
              "enc_layers": cfg.n_enc_layers}
    for key, node in tree.items():
        if key not in LAYER_STACKS:
            put(key, node)
            continue
        for i in range(counts[key]):
            put(f"{key}.{i}", _index_tree(node, i) if cfg.scan_layers else node[i])
    return out


def _index_tree(node, i: int):
    if isinstance(node, dict):
        return {k: _index_tree(v, i) for k, v in node.items()}
    return np.asarray(node)[i]
