"""Learning-rate schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_ratio * peak_lr``.  The schedule takes the step as a tensor
    and returns an f32 tensor on its device (no host round trip)."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) /
                        max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
