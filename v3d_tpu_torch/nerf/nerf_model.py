"""Plain NeRF density field and renderer (counterpart of
v3d_tpu/nerf/nerf_model.py, itself of mesh_recon/models/nerf.py and
systems/nerf.py): hash encoding -> density (``trunc_exp``) + colour MLP,
volume rendering by fixed-budget stratified marching.  The field of the
3DGS -> mesh distillation (recon/convert_nerf_mesh.py fit_nerf).

The sample jitter is an argument, a (R, S) tensor in [0, 1) or None for the
cell centres, so that a caller can hand in the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from v3d_tpu_torch.nerf.encoding import HashGrid, composite_with_xyz
from v3d_tpu_torch.nerf.fields import VanillaMLP
from v3d_tpu_torch.nerf.occupancy import grid_lookup
from v3d_tpu_torch.nerf.renderer import ray_aabb_intersect


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """models/utils.py trunc_exp: exp of x, with the gradient of exp at x
    clamped to [-15, 15] (the JAX package's custom JVP; not
    ``nerf.fields.trunc_exp``, which clamps the input)."""
    return _TruncExp.apply(x)


class NerfField(nn.Module):
    """Density + colour field (models/nerf.py VolumeDensity-style): a hash
    grid (16 levels x 2 features, 2^19 rows, base 16, scale 1.447) ->
    ``sigma_net`` (1 + feature_dim outputs; density = trunc_exp(h0 - 1)) and
    ``color_net`` on [h, dirs] -> sigmoid RGB."""

    def __init__(self, radius: float = 1.0, n_levels: int = 16,
                 base_resolution: int = 16, per_level_scale: float = 1.447,
                 feature_dim: int = 16, density_bias: float = -1.0):
        super().__init__()
        self.radius = radius
        self.density_bias = density_bias
        self.encoding = HashGrid(n_levels, 2, 19, base_resolution, per_level_scale)
        self.sigma_net = VanillaMLP(3 + self.encoding.n_output_dims, 1 + feature_dim,
                                    64, 1)
        self.color_net = VanillaMLP(1 + feature_dim + 3, 3, 64, 2)

    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's init distributions from ``gen``."""
        self.encoding.init_(gen)
        self.sigma_net.init_(gen)
        self.color_net.init_(gen)

    def density_feature(self, pts):
        x = ((pts + self.radius) / (2 * self.radius)).clamp(0.0, 1.0)
        h = self.sigma_net(composite_with_xyz(x, self.encoding(x)))
        return trunc_exp(h[..., 0] + self.density_bias), h

    def forward(self, pts, dirs):
        density, feat = self.density_feature(pts)
        rgb = torch.sigmoid(self.color_net(torch.cat([feat, dirs], dim=-1)))
        return density, rgb


class NerfRenderOut(NamedTuple):
    comp_rgb: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor
    weights: torch.Tensor
    midpoints: torch.Tensor
    intervals: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NerfRenderer:
    radius: float = 1.0
    num_samples: int = 512

    @property
    def step_size(self) -> float:
        return 1.732 * 2 * self.radius / self.num_samples

    def __call__(self, rays_o, rays_d, field_fn: Callable,
                 occupancy_binary: Optional[torch.Tensor] = None,
                 background_color: Optional[torch.Tensor] = None,
                 jitter: Optional[torch.Tensor] = None) -> NerfRenderOut:
        R, S = rays_o.shape[0], self.num_samples
        t_near, t_far = ray_aabb_intersect(rays_o, rays_d, self.radius)
        s = torch.arange(S, dtype=torch.float32, device=rays_o.device)
        t_mid = t_near[:, None] + (s[None] + (0.5 if jitter is None else jitter)) \
            * self.step_size
        mask = (t_mid < t_far[:, None]) & (t_far > t_near)[:, None]
        pos = rays_o[:, None] + rays_d[:, None] * t_mid[..., None]
        if occupancy_binary is not None:
            mask = mask & grid_lookup(occupancy_binary, pos, self.radius)
        dirs = rays_d[:, None].expand(pos.shape)
        density, rgb = field_fn(pos.reshape(-1, 3), dirs.reshape(-1, 3))
        density = density.reshape(R, S)
        rgb = rgb.reshape(R, S, 3)
        alpha = torch.where(mask, 1.0 - torch.exp(-density * self.step_size), 0.0)
        t_excl = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                          1 - alpha[:, :-1]], 1), 1)
        w = alpha * t_excl
        comp = (w[..., None] * rgb).sum(1)
        opac = w.sum(1)
        depth = (w * t_mid).sum(1)
        if background_color is not None:
            comp = comp + (1 - opac)[:, None] * background_color[None]
        return NerfRenderOut(comp, opac, depth, w, t_mid,
                             torch.full((R, S), self.step_size, device=rays_o.device))
