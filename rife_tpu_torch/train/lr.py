"""Learning-rate schedules (port of rife_tpu/train/lr.py), as plain
functions of the number of optimizer updates done before.

warmup_cosine_schedule: linear warmup 0 -> peak over 2000 steps (so the lr
of update 0 is 0), then cosine from peak down to floor over the remaining
steps; scaled by world_scale (batch / 64 in the trainer, the reference's
world_size / 4).  cyclic_lr_schedule: the legacy presets' triangular
CyclicLR.  Computed in double precision; the reference computes in f32
(agreement to ~1e-7 relative).
"""
from __future__ import annotations

import math


def cyclic_lr_schedule(*, base: float = 1e-6, peak: float = 1e-3,
                       step_size_up: int = 8000, world_scale: float = 1.0):
    """Linear base -> peak over step_size_up steps, back down over as many,
    repeated."""

    def schedule(step) -> float:
        up = math.fmod(float(step), 2.0 * step_size_up) / step_size_up
        frac = up if up <= 1.0 else 2.0 - up
        return (base + (peak - base) * frac) * world_scale

    return schedule


def warmup_cosine_schedule(total_steps: int, *, peak: float = 3e-4,
                           floor: float = 3e-6, warmup_steps: int = 2000,
                           world_scale: float = 1.0):
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return step / warmup_steps * peak * world_scale
        progress = (step - warmup_steps) / (total_steps - warmup_steps)
        progress = min(max(progress, 0.0), 1.0)
        mul = math.cos(progress * math.pi) * 0.5 + 0.5
        return ((peak - floor) * mul + floor) * world_scale

    return schedule
