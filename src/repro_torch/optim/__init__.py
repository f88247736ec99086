"""Optimizer (port of ``repro/optim``): AdamW and learning-rate schedules."""
from .adamw import AdamWConfig, AdamWState, global_norm, init, update
from .schedules import cosine_with_warmup, linear_warmup_constant

__all__ = ["AdamWConfig", "AdamWState", "cosine_with_warmup", "global_norm",
           "init", "linear_warmup_constant", "update"]
