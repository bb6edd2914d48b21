"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf] — dense, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    act="swiglu",
    norm="rms",
    qkv_bias=True,
)
