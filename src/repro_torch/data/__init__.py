from .pipeline import PrefetchPipeline, SyntheticTokens
__all__ = ["PrefetchPipeline", "SyntheticTokens"]
