"""The port's attention kernel for the card (`causal_attention`) and the
plain version of its arithmetic (`causal_attention_ref`)."""
from .causal import (
    HEAD_DIMS,
    causal_attention,
    causal_attention_ref,
    launches,
    library_flags,
    split_parts,
)

__all__ = [
    "HEAD_DIMS",
    "causal_attention",
    "causal_attention_ref",
    "launches",
    "library_flags",
    "split_parts",
]
