"""LR schedules as pure step -> scale functions.

Counterpart of `repro/optim/schedules.py`: `step` is an integer tensor
(the optimizer's step count) and the scale a float32 tensor on its
device, so a train step never waits on the host for it."""
from __future__ import annotations

import math

import torch


def linear_warmup(step: torch.Tensor, warmup_steps: int) -> torch.Tensor:
    return torch.clamp_max((step + 1) / max(warmup_steps, 1), 1.0)


def cosine_schedule(step: torch.Tensor, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
