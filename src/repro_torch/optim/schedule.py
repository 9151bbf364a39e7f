"""Learning-rate schedules — twin of :mod:`repro.optim.schedule`.

Computed in float32, as the reference's jnp; a schedule maps a step to a
0-d float32 tensor on the CPU.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "constant_schedule"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup → cosine decay to ``min_ratio * base_lr``."""

    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi) * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return lr


def constant_schedule(base_lr: float):
    """``base_lr`` at every step."""
    return lambda step: _f32(base_lr)
