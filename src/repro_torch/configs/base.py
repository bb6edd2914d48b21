"""Model / run configuration dataclasses shared by every architecture.

One `ModelConfig` covers all six families (dense, moe, ssm, hybrid, encdec,
vlm); family-specific fields are ignored elsewhere.  Every assigned
architecture instantiates this with its exact published numbers in
`repro/configs/<id>.py`, and smoke tests shrink via `reduced()`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family

    # -- trunk dimensions ----------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int            # 0 for attention-free (mamba2)
    n_kv_heads: int
    d_ff: int               # dense-MLP hidden (0 = no dense MLP, e.g. mamba2)
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // n_heads

    # -- layer flavor ----------------------------------------------------------
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rms", "ln"] = "rms"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True

    # -- attention -------------------------------------------------------------
    attention: Literal["full", "sliding"] = "full"
    window: int = 1024            # sliding-window width (attention="sliding")
    attn_q_chunk: int = 1024      # online-softmax chunking (memory roofline)
    attn_kv_chunk: int = 1024
    #: checkpoint the attention q-block (recompute online-softmax internals
    #: in backward).  Necessary at large per-device batch; at DP-heavy plans
    #: the residuals are small and the triple-recompute (outer layer remat +
    #: inner) costs more than it saves (§Perf iteration A4).
    attn_remat: bool = True
    #: decode KV-cache layout: "bskd" (natural) or "bksd" (head-major —
    #: matches the decode einsum's batch dims, eliminating cache-sized
    #: transpose copies; §Perf iteration B2).
    cache_layout: str = "bskd"
    #: gather expert weights over the data axis at use (per layer, loop-
    #: invariant) instead of partial-summing [E,C,D] expert activations per
    #: dispatch group over data (§Perf iteration C1).
    moe_weight_gather: bool = False
    #: cast QKV to f32 before the score matmul (baseline).  False keeps
    #: bf16 operands with f32 MXU accumulation (preferred_element_type) —
    #: no materialized f32 copies of cache/activations (§Perf iteration).
    attn_cast_f32: bool = True

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 2048         # tokens per dispatch group (scanned)

    # -- SSM (mamba2 SSD) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # -- encoder-decoder ---------------------------------------------------------
    n_enc_layers: int = 0
    enc_seq_divisor: int = 4      # encoder frames = decoder seq / divisor

    # -- vlm -----------------------------------------------------------------------
    n_patches: int = 256          # stub frontend patch embeddings per sample

    # -- numerics / compilation ------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    remat: bool = True            # activation checkpointing across layers
    scan_layers: bool = True      # lax.scan over stacked layer weights
    #: python-unroll inner loops (attention chunks, MoE groups, SSD chunks)
    #: with IDENTICAL math — used by the dry-run cost extraction, where
    #: XLA's cost analysis counts a while-loop body once.
    unroll_inner: bool = False

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return max(1, self.ssm_d_inner // self.ssm_head_dim)

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode (long_500k) is architecturally sane."""
        return self.family in ("ssm", "hybrid") or self.attention == "sliding"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family (CPU, one step)."""
        return dataclasses.replace(
            self,
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=max(1, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            ssm_chunk=16,
            window=32,
            attn_q_chunk=32,
            attn_kv_chunk=32,
            moe_group=64,
            n_patches=8,
            param_dtype="float32",
            compute_dtype="float32",
            vocab_pad_multiple=32,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment applicability rules; reason recorded when skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention architecture: 512k dense causal attention "
            "is quadratic; skipped per assignment (see DESIGN.md §5)"
        )
    return True, ""
