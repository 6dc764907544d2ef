"""Learning-rate schedules (pure functions of the step index).

Port of ``repro/optim/schedule.py``.  Each schedule returns a float32
0-d tensor on the step's device (the CPU for a Python step), computed in
float32 as the reference's is: ``lr`` times a float32 tensor stays
float32, so the value is the reference's to the last bit up to the
rounding of ``cos``.  ``linear_warmup_cosine`` evaluates both branches,
as ``jnp.where`` does: the cosine branch's step is clipped, not skipped,
and the learning rate at step 0 is 0.
"""
from __future__ import annotations

import math

import torch


def _f32_step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=getattr(step, "device", None))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32_step(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = _f32_step(step)
        warm = lr * step / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn
