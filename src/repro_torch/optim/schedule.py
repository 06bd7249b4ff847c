"""LR schedules (counterpart of `repro/optim/schedule.py`)."""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1,
                  device=None) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine down to `floor` · peak_lr at
    `total`: a 0-d float32 tensor on `step`'s device when `step` is a tensor,
    else on `device` (the card unless named)."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, device=resolve_device(device))
    step = step.to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup, warm, cos)
