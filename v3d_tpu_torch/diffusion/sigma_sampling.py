"""Training-time noise-level sampler (counterpart of
v3d_tpu/diffusion/sigma_sampling.py; sgm sigma_sampling.py).  V3D trains
with ``EDMSampling(p_mean=1.5, p_std=2.0)``: log-normal sigmas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EDMSampling:
    p_mean: float = -1.2
    p_std: float = 1.2

    def __call__(self, n_samples: int, device=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        log_sigma = self.p_mean + self.p_std * torch.randn(
            (n_samples,), device=device, generator=generator)
        return torch.exp(log_sigma)
