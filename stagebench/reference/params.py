"""The reference's view of a configuration: its sizes and its parameters.

Everything here is read from a configuration file of the benchmark
(``stagebench/configs/<name>.json``), never from the program.  The
parameter names and shapes are the layout the benchmark's weights are
drawn in; the harness loads the same tensors into the program by name
and refuses to run where the program's parameters differ from it.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Arch", "param_layout"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes of one configuration (the ``model`` group of its file)."""

    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    vocab_pad_multiple: int
    rope_theta: float
    tie_embeddings: bool
    window: int | None
    ssm_state: int
    ssm_expand: int
    ssm_head_dim: int
    ssm_chunk: int
    ssm_conv_width: int
    param_dtype: torch.dtype
    f32_params: tuple[str, ...]
    norm_eps: float

    @classmethod
    def from_config(cls, config: dict) -> "Arch":
        m = config["model"]
        if m.get("act", "swiglu") != "swiglu" or m.get("norm", "rms") != "rms":
            raise ValueError("the reference covers SwiGLU MLPs and RMS norms only")
        if m.get("qkv_bias", False):
            raise ValueError("the reference covers attention without biases only")
        n_heads = m["n_heads"]
        return cls(
            family=config["family"],
            n_layers=m["n_layers"],
            d_model=m["d_model"],
            n_heads=n_heads,
            n_kv_heads=m["n_kv_heads"],
            head_dim=m.get("head_dim") or m["d_model"] // n_heads,
            d_ff=m["d_ff"],
            vocab_size=m["vocab_size"],
            vocab_pad_multiple=m.get("vocab_pad_multiple", 1),
            rope_theta=float(m.get("rope_theta", 10_000.0)),
            tie_embeddings=m.get("tie_embeddings", True),
            window=m["window"] if m.get("attention", "full") == "sliding" else None,
            ssm_state=m.get("ssm_state", 0),
            ssm_expand=m.get("ssm_expand", 2),
            ssm_head_dim=m.get("ssm_head_dim", 64),
            ssm_chunk=m.get("ssm_chunk", 256),
            ssm_conv_width=m.get("ssm_conv_width", 4),
            param_dtype=_DTYPES[m.get("param_dtype", "bfloat16")],
            f32_params=tuple(config.get("f32_params", ())),
            norm_eps=float(config.get("norm_eps", 1e-6)),
        )

    @property
    def hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


def param_layout(arch: Arch) -> list[tuple[str, tuple[int, ...], torch.dtype]]:
    """Every parameter as (name, shape, dtype), in the order the weights
    are drawn.  Weights are [in, out] and applied as ``x @ w``; the
    embedding has the padded vocabulary's rows and is also the head."""
    if arch.family not in ("dense", "hybrid"):
        raise ValueError(f"the reference covers the dense and hybrid families, not {arch.family}")
    if not arch.tie_embeddings:
        raise ValueError("the reference covers tied embeddings only")
    d, hd = arch.d_model, arch.head_dim
    out: list[tuple[str, tuple[int, ...]]] = [("embed", (arch.padded_vocab, d))]
    for i in range(arch.n_layers):
        p = f"layers.{i}."
        out += [
            (p + "attn_norm.scale", (d,)),
            (p + "attn.wq", (d, arch.n_heads * hd)),
            (p + "attn.wk", (d, arch.n_kv_heads * hd)),
            (p + "attn.wv", (d, arch.n_kv_heads * hd)),
            (p + "attn.wo", (arch.n_heads * hd, d)),
        ]
        if arch.hybrid:
            di, n, h = arch.d_inner, arch.ssm_state, arch.ssm_heads
            out += [
                (p + "ssm_norm.scale", (d,)),
                (p + "ssm.in_proj", (d, 2 * di + 2 * n + h)),
                (p + "ssm.conv_w", (arch.ssm_conv_width, di + 2 * n)),
                (p + "ssm.conv_b", (di + 2 * n,)),
                (p + "ssm.A_log", (h,)),
                (p + "ssm.D", (h,)),
                (p + "ssm.dt_bias", (h,)),
                (p + "ssm.out_proj", (di, d)),
                (p + "ssm.gate_norm_scale", (di,)),
                (p + "attn_out_norm.scale", (d,)),
                (p + "ssm_out_norm.scale", (d,)),
            ]
        out += [
            (p + "mlp_norm.scale", (d,)),
            (p + "mlp.wi_gate", (d, arch.d_ff)),
            (p + "mlp.wi_up", (d, arch.d_ff)),
            (p + "mlp.wo", (arch.d_ff, d)),
        ]
    out.append(("final_norm.scale", (d,)))

    def dtype(name: str) -> torch.dtype:
        leaf = name.split(".", 2)[-1] if name.startswith("layers.") else name
        return torch.float32 if leaf in arch.f32_params else arch.param_dtype

    return [(name, shape, dtype(name)) for name, shape in out]
