"""EMA shadow parameters (counterpart of v3d_tpu/engines/ema.py; sgm
modules/ema.py LitEma): decay ``min(decay, (1 + step) / (10 + step))``.
The shadow is a list of tensors beside the parameters, updated in place.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def ema_init(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of ``params`` that do not alias them."""
    return [p.detach().clone() for p in params]


def ema_decay(step: int, decay: float = 0.9999,
              use_num_updates: bool = True) -> float:
    if not use_num_updates:
        return decay
    return min(decay, (1.0 + step) / (10.0 + step))


@torch.no_grad()
def ema_update_(shadow: List[torch.Tensor], params: Sequence[torch.Tensor],
                step: int, decay: float = 0.9999,
                use_num_updates: bool = True) -> None:
    """shadow <- shadow - (1 - d) (shadow - params), in place."""
    d = ema_decay(step, decay, use_num_updates)
    torch._foreach_lerp_(shadow, [p.detach() for p in params], 1.0 - d)
