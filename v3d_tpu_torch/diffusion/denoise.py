"""EDM-preconditioned denoiser (counterpart of v3d_tpu/diffusion/denoise.py):

    D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``x.dim() == target_ndim``."""
    extra = target_ndim - x.dim()
    if extra < 0:
        raise ValueError(f"x has {x.dim()} dims but target is {target_ndim}")
    return x.reshape(x.shape + (1,) * extra)


@dataclasses.dataclass(frozen=True)
class Denoiser:
    scaling: Callable

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict, **extra) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()))
        model_out = network(x * c_in, c_noise.reshape(sigma.shape), cond, **extra)
        return model_out * c_out + x * c_skip
