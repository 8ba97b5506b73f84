"""Noise-level schedules (counterpart of v3d_tpu/diffusion/discretize.py).

Computed on the host in float64 numpy and handed out as float32, as the
JAX package does.  V3D runs ``EDMDiscretization(sigma_max=700, rho=7)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EDMDiscretization:
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

    def __call__(self, n: int, do_append_zero: bool = True,
                 flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas
