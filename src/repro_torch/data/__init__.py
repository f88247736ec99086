"""Deterministic synthetic LM data (a copy of ``repro/data``)."""
from .synthetic import DataConfig, batch_at, iterate

__all__ = ["DataConfig", "batch_at", "iterate"]
