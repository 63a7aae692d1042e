"""LR schedules: the port of ``repro.optim.schedule``."""

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup: int, total: int,
                       floor: float = 0.1):
    """``lr(step)`` -> a float32 tensor: linear warm-up to ``peak_lr``
    over ``warmup`` steps, then a cosine down to ``floor * peak_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr
