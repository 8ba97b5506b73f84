"""Noise-level schedules (counterpart of v3d_tpu/diffusion/discretize.py;
sgm discretizer.py:28-69).

Computed on the host in float64 numpy and handed out as float32, as the
JAX package does.  V3D runs ``EDMDiscretization(sigma_max=700, rho=7)``;
``SlicedDiscretization`` is the truncated schedule of img2img;
``ShiftedFlowDiscretization`` is FLUX.1's rectified-flow time schedule
(no registry name: the JAX package has none).  A schedule also says how
the samplers scale standard-normal noise to its top (``start``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from v3d_tpu_torch.core.registry import register


class Discretization:
    def __call__(self, n: int, do_append_zero: bool = True,
                 flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def start(self, x: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
        """Standard-normal ``x`` scaled to the schedule's top ``sigma0``:
        x sqrt(1 + sigma0^2), the EDM / DDPM latent (sampling.py:50)."""
        return x * torch.sqrt(1.0 + sigma0.to(x.dtype) ** 2)


@register("edm_discretization")
@dataclasses.dataclass(frozen=True)
class EDMDiscretization(Discretization):
    """Karras rho-ramp from sigma_max down to sigma_min."""

    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho
        return sigmas.astype(np.float32)


def make_beta_schedule_linear(n_timestep: int, linear_start: float,
                              linear_end: float) -> np.ndarray:
    """DDPM 'linear' schedule: the squares of a linspace of square roots."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                       dtype=np.float64) ** 2


@register("legacy_ddpm_discretization")
@dataclasses.dataclass(frozen=True)
class LegacyDDPMDiscretization(Discretization):
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    num_timesteps: int = 1000

    def get_sigmas(self, n: int) -> np.ndarray:
        betas = make_beta_schedule_linear(self.num_timesteps, self.linear_start,
                                          self.linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if n < self.num_timesteps:
            timesteps = np.linspace(self.num_timesteps - 1, 0, n,
                                    endpoint=False).astype(int)[::-1]
            alphas_cumprod = alphas_cumprod[timesteps]
        elif n != self.num_timesteps:
            raise ValueError(f"n={n} > num_timesteps={self.num_timesteps}")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        return sigmas[::-1].astype(np.float32)


@register("sliced_discretization")
@dataclasses.dataclass(frozen=True)
class SlicedDiscretization(Discretization):
    """img2img's truncated schedule (sgm inference/helpers.py do_img2img,
    ``sigmas[init_step:]``): the base schedule of ``n + skip`` levels with
    its first ``skip`` dropped."""

    base: Discretization = None
    skip: int = 0

    def get_sigmas(self, n: int) -> np.ndarray:
        return self.base.get_sigmas(n + self.skip)[self.skip:]

    def start(self, x: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
        return self.base.start(x, sigma0)


@dataclasses.dataclass(frozen=True)
class ShiftedFlowDiscretization(Discretization):
    """FLUX.1's schedule (flux ``sampling.py`` ``get_schedule``): n + 1
    times linspace(1, 0) shifted by ``time_shift(mu, 1, t) = e^mu / (e^mu
    + 1/t - 1)``, mu linear in the image's tokens from ``base_shift`` at
    ``base_tokens`` to ``max_shift`` at ``max_tokens``; the last, 0, is
    the appended zero.  The flow starts at the noise itself (t = 1: no
    scaling)."""

    image_tokens: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_tokens: int = 256
    max_tokens: int = 4096

    def mu(self) -> float:
        slope = (self.max_shift - self.base_shift) / (self.max_tokens - self.base_tokens)
        return self.base_shift + slope * (self.image_tokens - self.base_tokens)

    def get_sigmas(self, n: int) -> np.ndarray:
        t = np.linspace(1.0, 0.0, n + 1, dtype=np.float64)[:-1]
        e = math.exp(self.mu())
        return (e / (e + (1.0 / t - 1.0))).astype(np.float32)

    def start(self, x: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
        return x
