"""Learning-rate schedules (pure functions of the step counter), twin of
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor * peak_lr``. ``step``: an int,
    a float or a tensor (its device is kept); returns an f32 0-d tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = frac.clamp(0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)
