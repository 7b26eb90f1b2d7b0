"""Learning-rate schedules (warmup + cosine/linear/constant decay).

The reference's f32 arithmetic in the same order: ``schedule(step)`` is a
0-d float32 tensor on the device of ``step`` (the CPU for a Python int).
"""

from __future__ import annotations

import math

import torch

from ..config import OptimizerConfig


def make_schedule(cfg: OptimizerConfig):
    warmup = max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps, warmup + 1)

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.lr * step / warmup
        frac = torch.clamp((step - warmup) / (total - warmup), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            decay = cfg.lr * (1.0 - frac)
        else:
            decay = torch.full_like(frac, cfg.lr)
        return torch.where(step < warmup, warm, decay)

    return schedule
