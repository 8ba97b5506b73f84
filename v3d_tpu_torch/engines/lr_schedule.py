"""LR schedules (counterpart of v3d_tpu/engines/lr_schedule.py; sgm
lr_scheduler.py): multiplicative factors on the base LR.  V3D uses
LambdaLinearScheduler(warm_up_steps=[1], f_start=[1e-6], f_max=[1.0],
f_min=[1.0]): one warm-up step, then flat.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from v3d_tpu_torch.core.registry import register


@register("lambda_linear_scheduler")
def lambda_linear(warm_up_steps: Sequence[int] = (1,),
                  f_start: Sequence[float] = (1e-6,),
                  f_max: Sequence[float] = (1.0,),
                  f_min: Sequence[float] = (1.0,),
                  cycle_lengths: Sequence[int] = (10**13,)
                  ) -> Callable[[int], float]:
    """lr_scheduler.py:113-134, the first cycle (as the JAX package): linear
    warm-up from f_start to f_max, then linear decay to f_min over the
    cycle."""
    wu = float(warm_up_steps[0])
    cl = float(cycle_lengths[0])

    def schedule(step: int) -> float:
        n = float(step)
        if n < wu:
            return f_start[0] + (f_max[0] - f_start[0]) * n / max(wu, 1.0)
        return f_min[0] + (f_max[0] - f_min[0]) * (cl - n) / cl

    return schedule


@register("lambda_warmup_cosine_scheduler")
def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                         lr_start: float, max_decay_steps: int
                         ) -> Callable[[int], float]:
    """lr_scheduler.py:4-49: linear warm-up, then a half cosine to lr_min."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return lr_start + lr_max * step / max(warm_up_steps, 1)
        t = min(max((step - warm_up_steps)
                    / max(max_decay_steps - warm_up_steps, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule
