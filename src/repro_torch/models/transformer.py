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

With a `TensorParallel` context the decode runs on this rank's batch
rows, its shards of the weights and its slices of the caches
(`tp_decode_attention`: the KV caches' sequence split over the model
axis, `DECODE_PLAN`; the SSM's caches split over the batch only).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..distributed.tensor_parallel import gathered
from ..telemetry import regions
from . import moe as moe_lib
from . import ssm as ssm_lib
from .attention import (
    chunked_causal_attention,
    decode_attention,
    decode_attention_bksd,
    query_split,
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
    gathered_columns,
    lm_logits,
    mlp_axes,
    mlp_shapes,
    norm_axes,
    vocab_parallel,
    whole_columns,
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
    "tp_attention",
    "tp_decode_attention",
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

    def _attention(self, x, positions, triangular, tp=None):
        cfg = self.cfg
        b, s, _ = x.shape

        def core(q, k, v, q_blocks=None, q_chunk=cfg.attn_q_chunk):
            return chunked_causal_attention(
                q,
                k,
                v,
                q_chunk=q_chunk,
                kv_chunk=cfg.attn_kv_chunk,
                window=cfg.window if cfg.attention == "sliding" else None,
                triangular=triangular,
                cast_f32=cfg.attn_cast_f32,
                remat_qblock=cfg.attn_remat,
                q_blocks=q_blocks,
            )

        if tp is not None and tp.size > 1:
            h = self.attn_norm(x)
            return tp_attention(tp, cfg, self.attn, h, h, core, bias=cfg.qkv_bias,
                                rope=lambda t: apply_rope(t, positions, cfg.rope_theta),
                                q_chunk=cfg.attn_q_chunk)
        q, k, v = self._qkv(x, positions)
        return core(q, k, v).reshape(b, s, cfg.q_dim) @ self.attn.wo

    def _attention_decode(self, x_tok, layer_cache, pos, index, cache_len, tp=None):
        """x_tok: [B, 1, D] at absolute position `index` (`pos` holds it
        on the device); writes k, v into the layer's cache slices."""
        cfg = self.cfg
        b = x_tok.shape[0]
        write = index % cache_len  # ring buffer for sliding windows
        length = min(index + 1, cache_len)
        if tp is not None:
            return tp_decode_attention(
                tp, cfg, self.attn, self.attn_norm(x_tok), layer_cache, length,
                write=write, bias=cfg.qkv_bias, cast_f32=cfg.attn_cast_f32,
                layout=cfg.cache_layout,
                rope=lambda t: apply_rope(t, pos, cfg.rope_theta))
        # rope at the absolute position, before the write
        q, k, v = self._qkv(x_tok, pos)
        if cfg.cache_layout == "bksd":
            kc, vc = update_kv_cache_bksd(layer_cache["k"], layer_cache["v"], k, v, write)
            out = decode_attention_bksd(q, kc, vc, length, cast_f32=cfg.attn_cast_f32)
        else:
            kc, vc = update_kv_cache(layer_cache["k"], layer_cache["v"], k, v, write)
            out = decode_attention(q, kc, vc, length, cast_f32=cfg.attn_cast_f32)
        return out.reshape(b, 1, cfg.q_dim) @ self.attn.wo

    def _ssm_decode(self, h, layer_cache, tp=None):
        out, new = ssm_lib.decode_ssm(
            self.ssm, {"state": layer_cache["ssm_state"], "conv": layer_cache["conv"]},
            h, self.cfg, tp,
        )
        layer_cache["ssm_state"].copy_(new["state"])
        layer_cache["conv"].copy_(new["conv"])
        return out

    def _mix(self, attn_out, ssm_out):
        """The hybrid's parallel-head average."""
        return 0.5 * (self.attn_out_norm(attn_out) + self.ssm_out_norm(ssm_out))

    def _feed_forward(self, x, tp=None):
        """The expert block or the MLP: (x, aux), aux None without experts.
        Each is a timed region (`telemetry.regions`), entered on x before
        its norm and its residual read it."""
        aux = None
        if _has_moe(self.cfg):
            x = regions.enter("moe", x)
            y, aux = self.moe(self.moe_norm(x), tp)
            x = x + regions.exit("moe", y)
        if _has_mlp(self.cfg):
            x = regions.enter("mlp", x)
            y = apply_mlp(self.mlp, self.mlp_norm(x), self.cfg.act, tp)
            x = x + regions.exit("mlp", y)
        return x, aux

    def forward(self, x, positions, triangular: bool = False, tp=None):
        """One layer. Returns (x, aux or None).  `tp`: this rank's
        `TensorParallel` context, None for the plain layer.

        Each mixer is a timed region (`telemetry.regions`), entered on x
        before anything reads it; the hybrid's x also feeds the SSD path,
        whose region opens after its norm."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            x = regions.enter("attention", x)
            attn_out = regions.exit("attention", self._attention(x, positions, triangular, tp))
            h = regions.enter("ssm", self.ssm_norm(x))
            ssm_out = regions.exit("ssm", ssm_lib.apply_ssm(self.ssm, h, cfg, tp))
            x = x + self._mix(attn_out, ssm_out)
        else:
            if _has_attention(cfg):
                x = regions.enter("attention", x)
                y = self._attention(x, positions, triangular, tp)
                x = x + regions.exit("attention", y)
            if _has_ssm(cfg):
                x = regions.enter("ssm", x)
                y = ssm_lib.apply_ssm(self.ssm, self.ssm_norm(x), cfg, tp)
                x = x + regions.exit("ssm", y)
        return self._feed_forward(x, tp)

    def decode(self, x_tok, layer_cache, pos, index: int, cache_len: int, tp=None):
        """One layer of one decode step; the layer's caches (views into
        the stacked tensors) are written in place."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            attn_out = self._attention_decode(x_tok, layer_cache, pos, index, cache_len, tp)
            ssm_out = self._ssm_decode(self.ssm_norm(x_tok), layer_cache, tp)
            x_tok = x_tok + self._mix(attn_out, ssm_out)
        else:
            if _has_attention(cfg):
                x_tok = x_tok + self._attention_decode(
                    x_tok, layer_cache, pos, index, cache_len, tp)
            if _has_ssm(cfg):
                x_tok = x_tok + self._ssm_decode(self.ssm_norm(x_tok), layer_cache, tp)
        return self._feed_forward(x_tok, tp)[0]


def _run_layer(layer, *args):
    """One layer, its weights stored split over batch axes gathered for
    it alone (`tensor_parallel.gathered`; ``args[-1]`` is the context)."""
    with gathered(args[-1], layer):
        return layer(*args)


def _product(x, w, b):
    y = x @ w
    return y if b is None else y + b


def _split_core(tp, core, q, k, v, q_chunk=None):
    """`core` on this rank's share of the attention, the shares'
    outputs all-gathered: its (batch, kv head) groups where the axis
    divides their count; else its query rows where the axis divides the
    sequence (`attention.query_split`: ``q_chunk``, a causal core's block
    size, None for a bidirectional core), k and v whole, through `copy`
    (every rank reads all of them for its own rows); else whole."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    m = tp.size
    if (b * n_kv) % m == 0:
        g = h // n_kv
        q = q.reshape(b, s, n_kv, g, d).transpose(1, 2).reshape(b * n_kv, s, g, d)
        k, v = (t.transpose(1, 2).reshape(b * n_kv, t.shape[1], 1, d) for t in (k, v))
        out = tp.gather(core(tp.split(q, 0), tp.split(k, 0), tp.split(v, 0)), 0)
        return out.reshape(b, n_kv, s, g, d).transpose(1, 2).reshape(b, s, h, d)
    split = query_split(s, m, q_chunk)
    if split is None:
        return core(q, k, v)
    size, order = split
    k, v = tp.copy(k), tp.copy(v)
    if q_chunk is None:  # one contiguous block a rank
        return tp.gather(core(tp.split(q, 1), k, v), 1)
    ranked = [i for blocks in order for i in blocks]  # the blocks in rank order
    mine = tp.split(q.reshape(b, s // size, size, h, d)[:, ranked], 1)
    out = core(mine.reshape(b, -1, h, d), k, v, q_blocks=order[tp.rank], q_chunk=size)
    out = tp.gather(out.reshape(mine.shape), 1)
    inverse = sorted(range(len(ranked)), key=ranked.__getitem__)  # back to sequence order
    return out[:, inverse].reshape(b, s, h, d)


def tp_attention(tp, cfg, a, h, h_kv, core, *, bias: bool = False, rope=None,
                 q_chunk: int | None = None):
    """An attention layer's projections, `core` and output product on this
    rank of the model axis (`TensorParallel` `tp`): queries from `h`, keys
    and values from `h_kv` ([B, S, D] each, normed), ``a`` the layer's
    `Attention` weights (its qkv biases read where `bias`), `rope` a
    rotation of [B, S, heads, D] or None.  Returns [B, S, D], after the
    all-reduce of the ``wo`` row product.

    Megatron heads where the query heads divide the axis: the rank's
    query heads from its shard of ``wq``, the key/value heads they read
    from its shard of ``wk``/``wv`` (or, where those are whole, from the
    slice of their columns that holds those heads), attention on those
    heads, ``wo`` a row product.  Otherwise (a head split across ranks):
    each projection a column product, gathered whole
    (`layers.gathered_columns`), the attention split by `_split_core`,
    ``wo`` a row product on this rank's slice of its input.  `q_chunk`:
    a causal `core`'s query block size (it then takes ``q_blocks`` and
    ``q_chunk``, `attention.chunked_causal_attention`'s); None for a
    bidirectional one.
    """
    b, s, _ = h.shape
    hd, m, r = cfg.head_dim, tp.size, tp.rank
    g, hl = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // m
    xq = tp.copy(h)
    xkv = xq if h_kv is h else tp.copy(h_kv)
    bq, bk, bv = (a.bq, a.bk, a.bv) if bias else (None, None, None)
    kv_split = tp.dim(a.wk) is not None
    heads = (tp.dim(a.wq) is not None and tp.dim(a.wo) is not None and cfg.n_heads % m == 0
             and (cfg.n_kv_heads % m == 0 if kv_split else hl % g == 0 or g % hl == 0))
    if heads:
        q = _product(xq, a.wq, bq)
        if kv_split:
            k, v = _product(xkv, a.wk, bk), _product(xkv, a.wv, bv)
        else:  # the kv heads this rank's query heads read
            part = slice(r * hl // g * hd, (((r + 1) * hl - 1) // g + 1) * hd)
            k, v = (_product(xkv, *whole_columns(tp, w, b_, part))
                    for w, b_ in ((a.wk, bk), (a.wv, bv)))
    else:
        q = gathered_columns(tp, h, a.wq, bq, xq)
        k = gathered_columns(tp, h_kv, a.wk, bk, xkv)
        v = gathered_columns(tp, h_kv, a.wv, bv, xkv)
    q = q.reshape(b, s, -1, hd)
    k, v = (t.reshape(b, h_kv.shape[1], -1, hd) for t in (k, v))
    if rope is not None:
        q, k = rope(q), rope(k)
    if heads:
        return tp.reduce(core(q, k, v).reshape(b, s, -1) @ a.wo)
    out = _split_core(tp, core, q, k, v, q_chunk).reshape(b, s, -1)
    if tp.dim(a.wo) is not None:
        return tp.reduce(tp.split(out, -1) @ a.wo)
    return out @ a.wo


def tp_decode_attention(tp, cfg, a, h, layer_cache: dict, length: int, *,
                        keys=("k", "v"), write: int | None = None, rope=None,
                        bias: bool = False, cast_f32: bool = True,
                        layout: str = "bskd") -> torch.Tensor:
    """One token's attention on this rank of the model axis (`tp`) against
    its slice of a layer's cache: `h` [B, 1, D] (normed; this rank's
    batch rows), ``a`` the layer's `Attention` weights (its qkv biases
    read where `bias`), ``layer_cache[keys[0]]`` and ``[keys[1]]`` the K
    and V caches in `layout`, split over the model axis along the
    sequence where ``keys[0]`` is in ``tp.caches`` (this rank's share of
    the positions, from ``tp.rank`` times its length), else whole;
    `length` the valid global length.  Returns [B, 1, D], after the
    all-reduce of the ``wo`` row product.

    The projections are column products (`layers.gathered_columns`),
    gathered whole: q for every head, and, where `write` is a position,
    the token's k and v, which only the rank whose slice holds `write`
    writes.  The attention runs over the rank's positions for every head,
    its softmax combined over the ranks (`attention.decode_attention`),
    then ``wo`` is a row product on the rank's slice of the heads."""
    b, hd = h.shape[0], cfg.head_dim
    bq, bk, bv = (a.bq, a.bk, a.bv) if bias else (None, None, None)
    kc, vc = layer_cache[keys[0]], layer_cache[keys[1]]
    local = kc.shape[1 if layout == "bskd" else 2]
    split = keys[0] in tp.caches
    offset = tp.rank * local if split else 0
    q = gathered_columns(tp, h, a.wq, bq).reshape(b, 1, -1, hd)
    if rope is not None:
        q = rope(q)
    if write is not None:  # every rank gathers k and v; the owner writes them
        k = gathered_columns(tp, h, a.wk, bk).reshape(b, 1, -1, hd)
        v = gathered_columns(tp, h, a.wv, bv).reshape(b, 1, -1, hd)
        if offset <= write < offset + local:
            update = update_kv_cache if layout == "bskd" else update_kv_cache_bksd
            update(kc, vc, rope(k) if rope is not None else k, v, write - offset)
    combine = (lambda xs: tp.all_max(xs[0]), lambda xs: tp.all_sum(xs[0])) if split else None
    attend = decode_attention if layout == "bskd" else decode_attention_bksd
    out = attend(q, kc, vc, length, cast_f32, offset=offset, combine=combine).reshape(b, 1, -1)
    if tp.dim(a.wo) is not None:
        return tp.reduce(tp.split(out, -1) @ a.wo)
    return out @ a.wo


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
        tp=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: [B, S_text] -> (logits [B, S, Vpad] f32, moe aux loss []).

        For vlm, frontend_embeds [B, P, D] are prepended and S = P + S_text.
        `tp` is this rank's `TensorParallel` context on a mesh that splits
        weights over its model axis (None: the plain model); the layers'
        collectives sit inside the remat checkpoint, so its recompute
        issues them again, in the same order on every rank.  A weight
        `tp` stores split over batch axes is gathered where it is used:
        a layer's in that layer (`_run_layer`), the others for the pass.
        """
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        with gathered(tp, self, skip=LAYER_STACKS):
            x = embed_tokens(self.embed, tokens, cd, tp)
            if frontend_embeds is not None:
                x = torch.cat([frontend_embeds.to(cd), x], dim=1)
            positions = torch.arange(x.shape[1], device=x.device)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in self.layers:
                if cfg.remat:
                    x, a = regions.checkpoint(_run_layer, layer, x, positions, triangular, tp,
                                              use_reentrant=False, preserve_rng_state=False)
                else:
                    x, a = _run_layer(layer, x, positions, triangular, tp)
                if a is not None:
                    aux = aux + a
            x = self.final_norm(regions.enter("head_loss", x))
            logits = lm_logits(x, self.embed, self.head, cfg.vocab_size, tp)
            return regions.exit("head_loss", logits), aux

    def forward(self, tokens: torch.Tensor, *, frontend_embeds=None,
                triangular: bool = False, tp=None) -> torch.Tensor:
        """tokens: [B, S_text] -> logits [B, S, Vpad] f32 (this rank's
        vocab columns under a vocab-split `tp`)."""
        return self.forward_lm(tokens, frontend_embeds=frontend_embeds,
                               triangular=triangular, tp=tp)[0]


def lm_loss_parts(
    model: TransformerLM,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    frontend_embeds: torch.Tensor | None = None,
    moe_aux_weight: float = 0.01,
    triangular: bool = False,
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy, weighted MoE aux) whose sum is `lm_loss`: the
    first a mean over supervised tokens, the second over dispatch groups
    (zero without experts); under `tp` the cross-entropy is
    vocab-parallel where the vocab is split."""
    logits, aux = model.forward_lm(
        tokens, frontend_embeds=frontend_embeds, triangular=triangular, tp=tp)
    if frontend_embeds is not None:
        # labels only cover text positions; patch positions are unsupervised
        logits = logits[:, frontend_embeds.shape[1]:, :]
    logits = regions.enter("head_loss", logits)
    ce = cross_entropy_loss(logits, labels, vocab_parallel(model.embed, model.head, tp))
    return regions.exit("head_loss", ce), moe_aux_weight * aux


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
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One serve step: (logits [B, 1, Vpad] f32, caches), the caches
    written in place.  With `tp` (a serve step's context) the tokens are
    this rank's batch rows, the weights and caches its shards and slices,
    and the logits its vocab columns where the vocab is split."""
    cfg = model.cfg
    with gathered(tp, model, skip=LAYER_STACKS):
        x = embed_tokens(model.embed, tokens, torch_dtype(cfg.compute_dtype), tp)
        cache_len = cache_len_for(cfg, seq_len)
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        for i, layer in enumerate(model.layers):
            layer_cache = {name: c[i] for name, c in caches.items()}
            with gathered(tp, layer):
                x = layer.decode(x, layer_cache, pos, index, cache_len, tp)
        x = model.final_norm(x)
        return lm_logits(x, model.embed, model.head, cfg.vocab_size, tp), caches


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
