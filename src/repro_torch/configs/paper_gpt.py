"""paper-gpt-125m — the paper's own evaluation workload analogue.

StageFrontier's cluster campaign trains a bf16 transformer under DDP; this
GPT-2-small-scale decoder-only config is the end-to-end driver model for
the examples/benchmarks (quickstart trains it for a few hundred steps).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paper-gpt-125m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50304,
    act="gelu",
    norm="ln",
    qkv_bias=True,
)
