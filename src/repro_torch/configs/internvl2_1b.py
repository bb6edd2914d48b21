"""internvl2-1b [arXiv:2404.16821; hf] — InternViT stub + InternLM2 backbone.

The InternViT vision tower is a STUB per the assignment: input_specs()
provides precomputed patch embeddings [B, n_patches, d_model] prepended to
the token embeddings of the qwen-style language backbone (GQA kv=2).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    act="swiglu",
    norm="rms",
    qkv_bias=True,
    n_patches=256,
)
