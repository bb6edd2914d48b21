"""Model definitions: the decoder-only families and the encoder-decoder family."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
