"""LR schedules (port of ``repro.optim.schedule``): pure functions of
the step counter, in f32 like the reference."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_ratio``.  Returns an lr
    *scale* (0-dim f32 tensor on the step's device)."""
    step = _step(step)
    warm = step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                             * progress))
    return torch.where(step < warmup, warm, cos)


def warmup_constant(step, *, warmup: int = 100) -> torch.Tensor:
    step = _step(step)
    return torch.clamp(step / max(warmup, 1), max=1.0)
