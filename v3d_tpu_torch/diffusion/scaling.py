"""EDM denoiser preconditioning (counterpart of v3d_tpu/diffusion/scaling.py).

V3D uses ``VScalingWithEDMcNoise``: V-scaling coefficients with the EDM
``c_noise = 0.25 * log(sigma)`` network time input
(sgm denoiser_scaling.py:51-59).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VScalingWithEDMcNoise:
    def __call__(self, sigma: torch.Tensor) -> Coeffs:
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise
