"""hymba-1.5b [arXiv:2411.13676; hf] — hybrid parallel attn+mamba heads.

Sliding-window attention (Hymba uses SWA in all but three layers; we use the
window everywhere, recorded in DESIGN.md) + Mamba-2 SSD heads in parallel,
outputs mean-combined after per-path RMS norms.  Sub-quadratic => runs
long_500k.  Meta-tokens are omitted (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    act="swiglu",
    norm="rms",
    attention="sliding",
    window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
)
