"""Learning-rate schedules (``src/repro/optim/schedules.py``): functions
of the optimizer's step count, a () int32 tensor on the device, that
return an fp32 device scalar, so no step reads a value to the host."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_decay", "warmup_cosine"]


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = step.to(torch.float32)
        return lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return f


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(step):
        s = torch.clamp(step.to(torch.float32), max=decay_steps)
        cos = 0.5 * (1 + torch.cos(math.pi * s / max(decay_steps, 1)))
        return lr * ((1 - alpha) * cos + alpha)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  alpha: float = 0.1):
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), alpha)

    def f(step):
        warm = lr * (step.to(torch.float32) + 1) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           decay(step - warmup_steps))
    return f
