"""EDM-preconditioned denoiser (counterpart of v3d_tpu/diffusion/denoise.py;
sgm denoiser.py:11-75):

    D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip

``DiscreteDenoiser`` first moves sigma to the nearest level of a fixed
discretization and hands the network that level's integer index as
``c_noise`` (the UNet's timestep embedding turns it into a float).
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

    def quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict, **extra) -> torch.Tensor:
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()))
        c_noise = self.quantize_c_noise(c_noise.reshape(sigma.shape))
        model_out = network(x * c_in, c_noise, cond, **extra)
        return model_out * c_out + x * c_skip


@dataclasses.dataclass(frozen=True)
class DiscreteDenoiser(Denoiser):
    """Sigma quantized to the nearest of ``num_idx`` levels of
    ``discretization`` (denoiser.py:42-75); ties go to the lower index, as
    ``jnp.argmin`` and ``torch.argmin`` both give them.  The levels are
    built once per device."""

    discretization: object = None
    num_idx: int = 1000
    do_append_zero: bool = False
    quantize_c_noise_flag: bool = True
    flip: bool = True

    def __post_init__(self):
        object.__setattr__(self, "_levels", {})

    def sigmas(self, device=None) -> torch.Tensor:
        key = torch.device(device or "cpu")
        if key not in self._levels:
            self._levels[key] = torch.as_tensor(self.discretization(
                self.num_idx, do_append_zero=self.do_append_zero,
                flip=self.flip), device=key)
        return self._levels[key]

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma[None, :] - self.sigmas(sigma.device)[:, None]
        return torch.argmin(dists.abs(), dim=0).reshape(sigma.shape)

    def quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.sigmas(sigma.device)[self.sigma_to_idx(sigma)]

    def quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        if self.quantize_c_noise_flag:
            return self.sigma_to_idx(c_noise)
        return c_noise
