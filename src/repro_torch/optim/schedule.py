"""LR schedules as f32 tensor arithmetic, the JAX package's formulas."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``. ``step`` is a
    number or a tensor (on any device); the result is a 0-d (or step's
    shape) f32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
