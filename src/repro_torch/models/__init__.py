"""Model definitions: the dense decoder-only family."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
