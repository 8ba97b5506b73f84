"""Noise-level schedules (counterpart of v3d_tpu/diffusion/discretize.py;
sgm discretizer.py:28-69).

Computed on the host in float64 numpy and handed out as float32, as the
JAX package does.  V3D runs ``EDMDiscretization(sigma_max=700, rho=7)``;
``SlicedDiscretization`` is the truncated schedule of img2img.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class Discretization:
    def __call__(self, n: int, do_append_zero: bool = True,
                 flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError


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


@dataclasses.dataclass(frozen=True)
class SlicedDiscretization(Discretization):
    """img2img's truncated schedule (sgm inference/helpers.py do_img2img,
    ``sigmas[init_step:]``): the base schedule of ``n + skip`` levels with
    its first ``skip`` dropped."""

    base: Discretization = None
    skip: int = 0

    def get_sigmas(self, n: int) -> np.ndarray:
        return self.base.get_sigmas(n + self.skip)[self.skip:]
