"""Learning-rate schedules (callable: step -> lr) — port of
`src/repro/optim/schedules.py:7-27` (`constant`, `cosine_decay`,
`linear_warmup_cosine`).

Each takes the optimiser's step count (an int32 tensor, as the
reference's ``jnp`` step) and returns a float32 0-d tensor on the step's
device, computed in float32 in the reference's order of operations.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def f(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))

    return f


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int, floor: float = 0.0):
    def f(step):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)

    return f
