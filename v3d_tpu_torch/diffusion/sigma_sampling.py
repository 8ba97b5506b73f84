"""Training-time noise-level samplers (counterpart of
v3d_tpu/diffusion/sigma_sampling.py; sgm sigma_sampling.py).  V3D trains
with ``EDMSampling(p_mean=1.5, p_std=2.0)``: log-normal sigmas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from v3d_tpu_torch.core.registry import register


@register("edm_sigma_sampling")
@dataclasses.dataclass(frozen=True)
class EDMSampling:
    p_mean: float = -1.2
    p_std: float = 1.2

    def __call__(self, n_samples: int, device=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        log_sigma = self.p_mean + self.p_std * torch.randn(
            (n_samples,), device=device, generator=generator)
        return torch.exp(log_sigma)


@register("discrete_sigma_sampling")
@dataclasses.dataclass(frozen=True)
class DiscreteSampling:
    """Uniform over the levels of a fixed discretization
    (sigma_sampling.py:16-30).  ``idx`` is an explicit (n_samples,) index
    draw; without it the indices come from ``generator``."""

    discretization: object = None
    num_idx: int = 1000
    do_append_zero: bool = False
    flip: bool = True

    def __call__(self, n_samples: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        sigmas = torch.as_tensor(self.discretization(
            self.num_idx, do_append_zero=self.do_append_zero, flip=self.flip),
            device=device)
        if idx is None:
            idx = torch.randint(0, self.num_idx, (n_samples,), device=device,
                                generator=generator)
        elif tuple(idx.shape) != (n_samples,):
            raise ValueError(f"idx shape {tuple(idx.shape)} != ({n_samples},)")
        return sigmas[idx.to(sigmas.device)]
