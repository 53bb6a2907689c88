"""Learning-rate schedule: exponential decay with an optional linear warmup,
after `efficient_nerf_tpu.train.schedules` (:17-39).

lr = lrate * 0.1^(step / (lrate_decay * 1000)); with --warmup_lr
"start,iters" the lr ramps linearly from `start` to `lrate` over `iters`
steps and the decay clock starts at the end of the warmup. The schedule is a
plain function of the step that returns a Python float, computed in float32
as the JAX package's is; the train step sets it as the optimizer's lr before
each update.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["make_lr_schedule", "parse_warmup"]


def parse_warmup(spec: str) -> Optional[Tuple[float, int]]:
    """'1e-4,2000' -> (1e-4, 2000); '' -> None."""
    if not spec:
        return None
    start, iters = spec.split(",")
    return float(start), int(float(iters))


def make_lr_schedule(lrate: float, lrate_decay: int,
                     warmup: Optional[Tuple[float, int]] = None,
                     decay_rate: float = 0.1) -> Callable[[int], float]:
    f32 = np.float32
    decay_steps = f32(lrate_decay * 1000)

    def schedule(step: int) -> float:
        t = f32(step)
        if warmup is None:
            return float(f32(lrate) * f32(decay_rate) ** (t / decay_steps))
        start_lr, end_iter = warmup
        if t < f32(end_iter):
            return float(f32((lrate - start_lr) / end_iter) * t + f32(start_lr))
        return float(f32(lrate) * f32(decay_rate)
                     ** ((t - f32(end_iter)) / decay_steps))

    return schedule
