"""Learning-rate schedules (``repro/optim/schedule.py``; paper A.2: warmup
0.5k-1.5k steps).  A schedule maps the step count (an int or an integer
tensor) to a float32 scalar tensor, computed in float32 as the reference
computes it."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_constant(peak: float, warmup_steps: int):
    def lr(step):
        s = _f32(step)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return lr


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        s = _f32(step)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return lr
