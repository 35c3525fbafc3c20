"""LR schedules (warmup + cosine decay, constant), pure functions of step.

The port's copy of ``repro.optim.schedules``.  A schedule takes the step
as an integer tensor (the optimizer's, on its device) or a number and
returns a 0-d float32 tensor on the step's device.  Divisions are true
divisions on the card too (``device.true_divide``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import true_divide


def _as_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        s = _as_f32(step)
        warm = true_divide(peak_lr * s, max(warmup_steps, 1))
        prog = torch.clamp(true_divide(s - warmup_steps,
                                       max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr


def constant(lr_value: float):
    def lr(step):
        dev = step.device if torch.is_tensor(step) else None
        return torch.full((), lr_value, dtype=torch.float32, device=dev)

    return lr
