"""Learning-rate schedules, computed in float32 as the reference computes
them (``repro/optim/schedules.py``): each returns a 0-d float32 tensor on
the host for a step (an int or a tensor), the same operations in the same
order, so the values equal the reference's."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=_F32)


def linear_warmup(step, warmup):
    return torch.clamp((step + 1) / max(1, warmup), max=1.0)


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.1):
    """Warmup -> constant plateau -> linear decay to ``floor_frac``."""
    def f(step):
        step = _step(step)
        warm = linear_warmup(step, warmup)
        in_decay = torch.clamp((step - warmup - stable) / max(1, decay),
                               0.0, 1.0)
        decay_mult = (1.0 - in_decay) + in_decay * floor_frac
        return peak_lr * warm * decay_mult
    return f


def cosine(peak_lr: float, warmup: int, total: int, floor_frac: float = 0.1):
    def f(step):
        step = _step(step)
        warm = linear_warmup(step, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * warm * (floor_frac + (1 - floor_frac) * cos)
    return f


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)
