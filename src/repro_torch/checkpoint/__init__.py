from .ckpt import latest_step, list_steps, restore_checkpoint, save_checkpoint
__all__ = ["latest_step", "list_steps", "restore_checkpoint", "save_checkpoint"]
