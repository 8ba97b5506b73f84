"""EDM denoiser preconditioning (counterpart of v3d_tpu/diffusion/scaling.py;
sgm denoiser_scaling.py:15-59): each scaling maps sigma to
``(c_skip, c_out, c_in, c_noise)``.  V3D uses ``VScalingWithEDMcNoise``:
V-scaling coefficients with the EDM ``c_noise = 0.25 * log(sigma)`` network
time input.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from v3d_tpu_torch.core.registry import register

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@register("edm_scaling")
@dataclasses.dataclass(frozen=True)
class EDMScaling:
    sigma_data: float = 0.5

    def __call__(self, sigma: torch.Tensor) -> Coeffs:
        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma**2 + sd2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


@register("eps_scaling")
@dataclasses.dataclass(frozen=True)
class EpsScaling:
    def __call__(self, sigma: torch.Tensor) -> Coeffs:
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


@register("v_scaling")
@dataclasses.dataclass(frozen=True)
class VScaling:
    def __call__(self, sigma: torch.Tensor) -> Coeffs:
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


@register("v_scaling_edm_cnoise")
@dataclasses.dataclass(frozen=True)
class VScalingWithEDMcNoise:
    def __call__(self, sigma: torch.Tensor) -> Coeffs:
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise
