from .adamw import AdamWConfig, OptState, apply_updates, init_opt, lr_at
__all__ = ["AdamWConfig", "OptState", "apply_updates", "init_opt", "lr_at"]
