"""Learning-rate schedules as step -> lr functions (port of
``repro.optim.schedules``): ``step`` is an int or an integer tensor (the
train state's device int32 scalar), the lr an f32 tensor on its device."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=_f32(step).device)


def linear_warmup(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        decay = peak_lr + (floor - peak_lr) * torch.clamp(frac, 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, decay)

    return fn


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int, floor_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return fn
