"""EDM Euler sampler (counterpart of v3d_tpu/diffusion/sampling.py).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
over the precomputed sigma schedule.  With ``s_churn = 0`` (V3D) no noise is
drawn and the sampler is deterministic given its initial noise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from v3d_tpu_torch.diffusion.denoise import append_dims

Cond = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EulerEDMSampler:
    """EDM stochastic Euler sampler (sgm sampling.py:85-133, 214-219)."""

    discretization: object = None
    num_steps: Optional[int] = None
    guider: object = None
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0

    def schedule(self, num_steps: Optional[int] = None) -> np.ndarray:
        n = num_steps if num_steps is not None else self.num_steps
        if n is None:
            raise ValueError("num_steps not set")
        return np.asarray(self.discretization(n))  # n + 1 values, ends in 0

    def gammas(self, sigmas: np.ndarray) -> np.ndarray:
        n = len(sigmas)
        g = np.zeros(n - 1, dtype=np.float32)
        for i in range(n - 1):
            if self.s_tmin <= sigmas[i] <= self.s_tmax:
                g[i] = min(self.s_churn / (n - 1), 2**0.5 - 1)
        return g

    def denoise(self, x, denoiser, sigma: torch.Tensor, cond: Cond, uc: Cond):
        s = sigma.to(x.dtype).expand(x.shape[0])
        x_in, s_in, c_in = self.guider.prepare_inputs(x, s, cond, uc)
        return self.guider(denoiser(x_in, s_in, c_in), sigma)

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Cond,
                 uc: Optional[Cond] = None,
                 generator: Optional[torch.Generator] = None,
                 num_steps: Optional[int] = None) -> torch.Tensor:
        uc = cond if uc is None else uc
        sigmas_np = self.schedule(num_steps)
        gammas = self.gammas(sigmas_np)
        sdt = torch.promote_types(x.dtype, torch.float32)
        sigmas = torch.as_tensor(sigmas_np, dtype=sdt, device=x.device)
        x = x * torch.sqrt(1.0 + sigmas[0].to(x.dtype) ** 2)
        for i in range(len(sigmas_np) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            sigma_hat = sigma * (float(gammas[i]) + 1.0)
            if gammas[i] > 0:
                noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                                    generator=generator) * self.s_noise
                x = x + noise * torch.sqrt(sigma_hat**2 - sigma**2).to(x.dtype)
            denoised = self.denoise(x, denoiser, sigma_hat, cond, uc)
            d = (x - denoised) / append_dims(sigma_hat.to(x.dtype), x.dim())
            x = x + (next_sigma - sigma_hat).to(x.dtype) * d
        return x
