"""Learning-rate schedules: functions of the step (an integer tensor)
returning a float32 scalar tensor, as the reference's ``optim/schedule.py``
does.  The float32 arithmetic is the reference's, operation for operation;
``torch.cos`` and XLA's ``cos`` may round one argument differently, so
``cosine`` agrees within one ulp (tests/test_torch_lm_train.py)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * c)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = lr * s / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn
