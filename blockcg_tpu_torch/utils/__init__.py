"""Utilities."""

from blockcg_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
