"""gemma-7b [arXiv:2403.08295; hf] — dense GeGLU, head_dim=256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="geglu",
    norm="rms",
)
