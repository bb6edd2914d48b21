"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1; the early-fusion multimodal frontend is out of the
assigned backbone scope (text backbone only).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    act="swiglu",
    norm="rms",
    tie_embeddings=False,
    n_experts=16,
    top_k=1,
)
