"""LR schedules (paper: base LR 1.0, reciprocal sqrt decay, 10k warmup).
Port of `repro/optim/schedules.py`."""
from __future__ import annotations

import math

import torch

from repro_torch.config import OptimizerConfig


def learning_rate(ocfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (counted from 0), a 0-d f32 tensor on
    the CPU, computed in f32 as the reference computes it."""
    f32 = torch.float32
    t = torch.as_tensor(step, dtype=f32) + 1.0
    w = float(max(ocfg.warmup_steps, 1))
    if ocfg.schedule == "rsqrt":
        return ocfg.learning_rate * torch.minimum(
            1.0 / torch.sqrt(torch.clamp(t, min=w)), t / (w * math.sqrt(w)))
    if ocfg.schedule == "cosine":
        frac = torch.clamp(t / w, max=1.0)
        return ocfg.learning_rate * torch.where(
            t < w, frac, 0.5 * (1 + torch.cos(math.pi * torch.clamp(
                (t - w) / (10.0 * w), max=1.0))))
    return torch.tensor(ocfg.learning_rate, dtype=f32)     # constant
