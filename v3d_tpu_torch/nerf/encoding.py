"""Input encodings of the SDF / radiance fields (counterpart of
v3d_tpu/nerf/encoding.py).

- ``HashGrid``: multiresolution hash encoding (Instant-NGP): per level the
  trilinear blend of the 8 cell corners' rows of a learned (L, T, F) table.
  All levels' corner rows are fetched with one gather.  The JAX package
  hashes in uint32, where the products wrap; here the products are int64
  (coordinates <= 2^10 times primes < 2^32 stay under 2^63) and
  ``& (T - 1)`` keeps the same low bits, so both pick the same rows.
- ``VanillaFrequency``: NeRF positional encoding with the progressive cosine
  mask (network_utils.py:10-45); no parameters.
- ``progressive_level_mask`` / ``progressive_fd_eps``: the hash grid's
  level annealing and the finite-difference eps tied to it (host side).
- ``composite_with_xyz`` and ``spherical_harmonics_basis``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

# Instant-NGP hashing primes
_PRIMES = (1, 2654435761, 805459861)
# the 8 corners of a cell, bit k of the corner index = offset along axis k
_CORNER_OFFSETS = [[(c >> k) & 1 for k in range(3)] for c in range(8)]


@functools.lru_cache(maxsize=None)
def _corner_offsets(device: torch.device) -> torch.Tensor:
    """_CORNER_OFFSETS on ``device``, made once (a step captured in a CUDA
    graph may not copy from the host)."""
    return torch.tensor(_CORNER_OFFSETS, device=device)


class HashGrid(nn.Module):
    """Multiresolution hash grid.  Input in [0, 1]^3; output (N, L*F)."""

    def __init__(self, n_levels: int = 10, n_features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 32,
                 per_level_scale: float = 1.3195079107728942):
        super().__init__()
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.table = nn.Parameter(torch.empty(
            n_levels, 1 << log2_hashmap_size, n_features_per_level))

    def resolutions(self):
        return [int(np.floor(self.base_resolution * self.per_level_scale ** l))
                for l in range(self.n_levels)]

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """U(-1e-4, 1e-4), as the JAX package initialises the table."""
        self.table.uniform_(-1e-4, 1e-4, generator=gen)

    def forward(self, x: torch.Tensor,
                level_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_levels, size, n_feat = self.table.shape
        offs = _corner_offsets(x.device)                           # (8, 3)
        rows, weights = [], []
        for l, res in enumerate(self.resolutions()):
            xl = x * res
            x0 = torch.floor(xl)
            w = xl - x0                                              # (N, 3)
            c = (x0.long()[..., None, :] + offs).clamp(0, res)       # (N, 8, 3)
            if (res + 1) ** 3 <= size:
                idx = c[..., 0] + (res + 1) * (c[..., 1] + (res + 1) * c[..., 2])
            else:
                idx = ((c[..., 0] * _PRIMES[0]) ^ (c[..., 1] * _PRIMES[1])
                       ^ (c[..., 2] * _PRIMES[2])) & (size - 1)
            rows.append(idx + l * size)
            cw = torch.where(offs.bool(), w[..., None, :], 1.0 - w[..., None, :])
            weights.append(cw[..., 0] * cw[..., 1] * cw[..., 2])     # (N, 8)
        rows = torch.stack(rows, dim=-2)                             # (N, L, 8)
        weights = torch.stack(weights, dim=-2)
        feats = self.table.reshape(n_levels * size, n_feat)[rows.reshape(-1)]
        feats = feats.reshape(rows.shape + (n_feat,))
        out = (weights[..., None] * feats).sum(-2)                   # (N, L, F)
        out = out.reshape(x.shape[:-1] + (n_levels * n_feat,))
        if level_mask is not None:
            out = out * level_mask
        return out


def progressive_level_mask(global_step: int, n_levels: int,
                           n_features_per_level: int, start_level: int,
                           start_step: int, update_steps: int) -> np.ndarray:
    """network_utils.py:58-66: unlock ``start_level`` levels at step 0, one
    more every ``update_steps``."""
    current = min(start_level + max(global_step - start_step, 0) // update_steps,
                  n_levels)
    mask = np.zeros(n_levels * n_features_per_level, np.float32)
    mask[:current * n_features_per_level] = 1.0
    return mask


def progressive_fd_eps(global_step: int, radius: float, base_resolution: int,
                       per_level_scale: float, start_level: int,
                       start_step: int, update_steps: int, n_levels: int) -> float:
    """geometry.py:219-237: finite-difference eps tied to the finest
    unlocked grid resolution."""
    current = min(start_level + max(global_step - start_step, 0) // update_steps,
                  n_levels)
    grid_res = base_resolution * per_level_scale ** (current - 1)
    return 2 * radius / grid_res


def composite_with_xyz(x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """CompositeEncoding include_xyz (xyz_scale=2, xyz_offset=-1)."""
    return torch.cat([x * 2.0 - 1.0, enc], dim=-1)


def spherical_harmonics_basis(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis up to ``degree`` (tcnn SphericalHarmonics): unit
    vectors (N, 3) -> (N, degree^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        xx, yy, zz = x * x, y * y, z * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.31539156525252005 * (2 * zz - xx - yy),
                -1.0925484305920792 * xz, 0.5462742152960396 * (xx - yy)]
    if degree > 3:
        out += [-0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * xy * z,
                -0.4570457994644658 * y * (4 * zz - xx - yy),
                0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
                -0.4570457994644658 * x * (4 * zz - xx - yy),
                1.445305721320277 * z * (xx - yy),
                -0.5900435899266435 * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


class VanillaFrequency:
    """NeRF positional encoding with progressive masking: sin / cos of
    2^k (2x - 1), k < n_frequencies; the geometry encoding of the card's
    recipe (no gathers)."""

    def __init__(self, n_frequencies: int = 10, n_masking_step: int = 0):
        self.n_frequencies = n_frequencies
        self.n_masking_step = n_masking_step
        self.n_output_dims = 3 * 2 * n_frequencies

    def mask(self, global_step: int) -> np.ndarray:
        if self.n_masking_step <= 0:
            return np.ones(self.n_frequencies, np.float32)
        ratio = global_step / self.n_masking_step * self.n_frequencies
        m = (1.0 - np.cos(
            math.pi * np.clip(ratio - np.arange(self.n_frequencies), 0, 1))) / 2
        return m.astype(np.float32)

    def __call__(self, x: torch.Tensor,
                 freq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x * 2.0 - 1.0
        freqs = 2.0 ** torch.arange(self.n_frequencies, device=x.device,
                                    dtype=x.dtype)
        ang = x[..., None] * freqs                                   # (..., 3, F)
        enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        if freq_mask is not None:
            enc = enc * torch.cat([freq_mask, freq_mask])
        return enc.reshape(x.shape[:-1] + (self.n_output_dims,))
