"""Checkpointing (port of ``repro/checkpoint``)."""
from .checkpointer import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
