"""Diffusion loss weightings (counterpart of v3d_tpu/diffusion/weighting.py;
sgm loss_weighting.py).  V3D trains with ``EDMWeighting(sigma_data=1.0)``,
which is ``VWeighting``.
"""

from __future__ import annotations

import dataclasses

import torch

from v3d_tpu_torch.core.registry import register


@register("unit_weighting")
@dataclasses.dataclass(frozen=True)
class UnitWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(sigma)


@register("edm_weighting")
@dataclasses.dataclass(frozen=True)
class EDMWeighting:
    sigma_data: float = 0.5

    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2


@register("v_weighting")
@dataclasses.dataclass(frozen=True)
class VWeighting(EDMWeighting):
    sigma_data: float = 1.0


@register("eps_weighting")
@dataclasses.dataclass(frozen=True)
class EpsWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma**-2.0
