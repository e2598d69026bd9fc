"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    final_frac=0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr``; an f32 tensor on ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1.0 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
