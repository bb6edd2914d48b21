"""whisper-base [arXiv:2212.04356; unverified] — enc-dec, conv frontend stub.

The audio conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (seq/4 frames) for the encoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    norm="ln",
    enc_seq_divisor=4,
)
