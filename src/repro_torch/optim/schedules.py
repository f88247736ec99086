"""Learning-rate schedules (port of ``repro/optim/schedules.py``): functions
of the 0-d step tensor, computed on its device in float32."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(1, warmup_steps)
        prog = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return sched


def linear_warmup_constant(peak_lr: float, warmup_steps: int):
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        return peak_lr * torch.clamp(s / max(1, warmup_steps), max=1.0)
    return sched
