"""LR schedules (multipliers on the base lr), as the reference's
``repro/optim/schedules.py``: each takes the optimizer's int32 step
tensor and returns a float32 tensor."""

from __future__ import annotations

import math

import torch


def warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    def schedule(step):
        step = step.to(torch.float32)
        warm = step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)
