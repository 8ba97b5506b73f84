"""NeuS volume renderer with fixed-budget ray marching (counterpart of
v3d_tpu/nerf/renderer.py; the nerfacc pipeline of
mesh_recon/models/neus.py:272-351).

Every ray carries ``num_samples`` positions between its AABB entry and exit,
masked by the occupancy grid (uniform sampling) or laid inside the band
where a cheap SDF probe changes sign (coarse-to-fine).  The NeuS alpha
(sigmoid-CDF ratio with cos annealing, neus.py:166-192) is composited front
to back with an exclusive cumulative product.

The sample jitter is an argument: a (R, S) tensor in [0, 1), or None for the
cell centres (0.5), so that a caller can hand in the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from v3d_tpu_torch.nerf.occupancy import grid_lookup


def _safe_normalize(x, eps=1e-10):
    """Normalise with a finite backward at ||x|| = 0."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps * eps)


def ray_aabb_intersect(rays_o, rays_d, radius: float):
    """Slab test against [-radius, radius]^3 -> (t_near >= 0, t_far); rays
    that miss get t_near > t_far."""
    small = torch.where(rays_d >= 0, 1e-10, -1e-10)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-10, small, rays_d)
    t0 = (-radius - rays_o) * inv_d
    t1 = (radius - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return t_near.clamp(min=0.0), t_far


def neus_alpha(sdf, normal, dirs, dists, inv_s, cos_anneal_ratio: float):
    """neus.py:166-192: alpha from the ratio of sigmoid CDFs at the section's
    estimated ends."""
    true_cos = (dirs * normal).sum(-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)


def _reversed_cumsum(x):
    return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod(x, 1)`` whose backward reads nothing back to the host.
    PyTorch's asks the device whether ``x`` holds a zero (and then selects
    by masks of data-dependent size), which a CUDA graph's capture refuses;
    this one takes every case through fixed-shape masks: before a row's
    first zero (the whole row when there is none) the gradient is
    PyTorch's zero-free formula, reversed_cumsum(g * y) / x; at the first
    zero it is the reversed cumsum of g times the product with that entry
    taken as 1; after it, 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, 1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        zeros = torch.cumsum(x == 0, 1)
        before = zeros == 0
        first = (x == 0) & (zeros == 1)
        past_first = torch.cumprod(torch.where(first, 1.0, x), 1)
        return torch.where(before, _reversed_cumsum(g * y) / torch.where(before, x, 1.0),
                           torch.where(first, _reversed_cumsum(g * past_first), 0.0))


def _weights(alpha):
    """alpha * exclusive cumulative product of (1 - alpha) along samples."""
    ones = torch.ones_like(alpha[:, :1])
    return alpha * _Cumprod.apply(torch.cat([ones, 1.0 - alpha[:, :-1]], 1))


class BgRenderResult(NamedTuple):
    comp_rgb: torch.Tensor      # (R, 3)
    opacity: torch.Tensor       # (R,)
    depth: torch.Tensor         # (R,)
    weights: torch.Tensor       # (R, S)
    midpoints: torch.Tensor     # (R, S)
    intervals: torch.Tensor     # (R, S)


@dataclasses.dataclass(frozen=True)
class BgRenderer:
    """Learned-background NeRF pass (neus.py:193-270 forward_bg_): each ray
    marches ``num_samples`` log-spaced t from its exit of the foreground
    AABB (``near_plane`` where it misses) to ``far_plane``."""

    radius: float = 1.0
    num_samples: int = 64
    near_plane: float = 0.1
    far_plane: float = 1e3

    def __call__(self, rays_o, rays_d, density_feature_fn: Callable,
                 rgb_fn: Callable, background_color=None, t_start=None,
                 jitter: Optional[torch.Tensor] = None) -> BgRenderResult:
        """density_feature_fn(points (N, 3)) -> (density (N,), feature
        (N, F)); rgb_fn(feature, dirs) -> (N, 3); ``jitter`` (R, 1) in
        [0, 1) shifts each ray's grid by jitter / S."""
        R, S = rays_o.shape[0], self.num_samples
        if t_start is None:
            _, t_start = ray_aabb_intersect(rays_o, rays_d, self.radius)
        near = t_start.clamp(self.near_plane, self.far_plane * 0.5)
        s = torch.arange(S + 1, dtype=torch.float32, device=rays_o.device) / S
        if jitter is not None:
            s = (s[None, :] + jitter / S).clamp(0.0, 1.0)
        else:
            s = s[None, :].expand(R, S + 1)
        t_edges = near[:, None] * (self.far_plane / near)[:, None] ** s
        t_mid = 0.5 * (t_edges[:, 1:] + t_edges[:, :-1])
        intervals = t_edges[:, 1:] - t_edges[:, :-1]
        positions = rays_o[:, None, :] + rays_d[:, None, :] * t_mid[..., None]
        density, feature = density_feature_fn(positions.reshape(-1, 3))
        alpha = 1.0 - torch.exp(-density.reshape(R, S) * intervals)
        weights = _weights(alpha)
        dirs = rays_d[:, None, :].expand(positions.shape).reshape(-1, 3)
        rgb = rgb_fn(feature, dirs).reshape(R, S, 3)
        comp_rgb = (weights[..., None] * rgb).sum(1)
        opacity = weights.sum(1)
        depth = (weights * t_mid).sum(1)
        if background_color is not None:
            comp_rgb = comp_rgb + (1.0 - opacity)[:, None] * background_color[None]
        return BgRenderResult(comp_rgb, opacity, depth, weights, t_mid, intervals)


class RenderResult(NamedTuple):
    comp_rgb: torch.Tensor      # (R, 3)
    opacity: torch.Tensor       # (R,)
    depth: torch.Tensor         # (R,)
    comp_normal: torch.Tensor   # (R, 3) normalised
    weights: torch.Tensor       # (R, S)
    sdf: torch.Tensor           # (R, S)
    sdf_grad: torch.Tensor      # (R, S, 3)
    midpoints: torch.Tensor     # (R, S)
    intervals: torch.Tensor     # (R, S)
    sample_mask: torch.Tensor   # (R, S) bool
    rays_valid: torch.Tensor    # (R,) bool: any live sample


@dataclasses.dataclass(frozen=True)
class NeusRenderer:
    """``ray_chunk`` > 0 renders the rays in chunks of that size (when it
    divides R); ``coarse_samples`` > 0 switches to coarse-to-fine sampling:
    an SDF-only probe of that many points per ray finds the zero-crossing
    band, and ``num_samples`` are laid inside it (placement carries no
    gradient, as the reference marches under no_grad)."""

    radius: float = 1.0
    num_samples: int = 1024
    ray_chunk: int = 0
    coarse_samples: int = 0
    coarse_margin: float = 2.0   # band padding in coarse-step units

    @property
    def step_size(self) -> float:
        return 1.732 * 2 * self.radius / self.num_samples   # neus.py:115-117

    def sample_points(self, rays_o, rays_d, jitter=None):
        """Uniform steps of ``step_size`` from the AABB entry; samples past
        t_far are masked."""
        R, S = rays_o.shape[0], self.num_samples
        t_near, t_far = ray_aabb_intersect(rays_o, rays_d, self.radius)
        s = torch.arange(S, dtype=torch.float32, device=rays_o.device)
        jitter = 0.5 if jitter is None else jitter
        t_start = t_near[:, None] + s[None, :] * self.step_size
        t_mid = t_start + jitter * self.step_size
        in_range = (t_mid < t_far[:, None]) & (t_far > t_near)[:, None]
        positions = rays_o[:, None, :] + rays_d[:, None, :] * t_mid[..., None]
        dists = torch.full((R, S), self.step_size, device=rays_o.device)
        return positions, t_mid, in_range, dists

    def sample_points_coarse_to_fine(self, rays_o, rays_d, sdf_fn: Callable,
                                     jitter=None):
        """Probe ``coarse_samples`` SDF values per ray, lay the fine budget
        in the band of sign changes; rays without one keep the whole chord."""
        R, Sc = rays_o.shape[0], self.coarse_samples
        dev = rays_o.device
        t_near, t_far = ray_aabb_intersect(rays_o, rays_d, self.radius)
        valid_ray = t_far > t_near
        with torch.no_grad():
            chord = (t_far - t_near).clamp(min=1e-6)
            sc = (torch.arange(Sc, dtype=torch.float32, device=dev) + 0.5) / Sc
            tc = t_near[:, None] + sc[None, :] * chord[:, None]
            pc = rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None]
            sdf_c = sdf_fn(pc.reshape(-1, 3)).reshape(R, Sc)
            sdf_c = torch.where(valid_ray[:, None], sdf_c, 1e3)
            cross = (sdf_c[:, :-1] * sdf_c[:, 1:]) <= 0.0            # (R, Sc-1)
            any_cross = cross.any(1)
            first = cross.int().argmax(1).float()
            last = (Sc - 2) - cross.flip(1).int().argmax(1).float()
            pad = self.coarse_margin / Sc
            lo = (first / Sc - pad).clamp(0.0, 1.0)
            hi = ((last + 2.0) / Sc + pad).clamp(0.0, 1.0)
            lo = torch.where(any_cross, lo, 0.0)
            hi = torch.where(any_cross, hi, 1.0)
            t_lo = t_near + lo * chord
            t_hi = t_near + hi * chord
        S = self.num_samples
        step = (t_hi - t_lo) / S
        s = torch.arange(S, dtype=torch.float32, device=dev)
        jitter = 0.5 if jitter is None else jitter
        t_mid = t_lo[:, None] + (s[None, :] + jitter) * step[:, None]
        in_range = valid_ray[:, None].expand(R, S)
        positions = rays_o[:, None, :] + rays_d[:, None, :] * t_mid[..., None]
        dists = step[:, None].expand(R, S)
        return positions, t_mid, in_range, dists

    def __call__(self, rays_o, rays_d, sdf_grad_feature_fn: Callable,
                 rgb_fn: Callable, inv_s, cos_anneal_ratio: float = 1.0,
                 occupancy_binary=None, background_color=None,
                 jitter: Optional[torch.Tensor] = None,
                 sdf_fn: Optional[Callable] = None) -> RenderResult:
        """sdf_grad_feature_fn(points (N, 3)) -> (sdf (N,), grad (N, 3),
        feature (N, F)); rgb_fn(feature, normal) -> (N, 3); sdf_fn(points)
        -> (N,), the probe of the coarse-to-fine path; ``jitter`` (R, S)."""
        R = rays_o.shape[0]
        if self.ray_chunk and R > self.ray_chunk and R % self.ray_chunk == 0:
            sub = dataclasses.replace(self, ray_chunk=0)
            outs = []
            for s in range(0, R, self.ray_chunk):
                sl = slice(s, s + self.ray_chunk)
                outs.append(sub(rays_o[sl], rays_d[sl], sdf_grad_feature_fn,
                                rgb_fn, inv_s, cos_anneal_ratio,
                                occupancy_binary, background_color,
                                None if jitter is None else jitter[sl],
                                sdf_fn=sdf_fn))
            return RenderResult(*[torch.cat(x) for x in zip(*outs)])
        S = self.num_samples
        if self.coarse_samples > 0:
            if sdf_fn is None:
                raise ValueError("coarse_samples > 0 needs sdf_fn")
            positions, t_mid, mask, dists = self.sample_points_coarse_to_fine(
                rays_o, rays_d, sdf_fn, jitter)
        else:
            positions, t_mid, mask, dists = self.sample_points(rays_o, rays_d,
                                                               jitter)
        if occupancy_binary is not None:
            mask = mask & grid_lookup(occupancy_binary, positions, self.radius)

        sdf, grad, feature = sdf_grad_feature_fn(positions.reshape(-1, 3))
        sdf = sdf.reshape(R, S)
        grad = grad.reshape(R, S, 3)
        normal = _safe_normalize(grad)
        alpha = neus_alpha(sdf, normal, rays_d[:, None, :], dists, inv_s,
                           cos_anneal_ratio)
        alpha = torch.where(mask, alpha, 0.0)
        weights = _weights(alpha)
        rgb = rgb_fn(feature, normal.reshape(-1, 3)).reshape(R, S, 3)
        comp_rgb = (weights[..., None] * rgb).sum(1)
        opacity = weights.sum(1)
        depth = (weights * t_mid).sum(1)
        comp_normal = _safe_normalize((weights[..., None] * normal).sum(1))
        if background_color is not None:
            comp_rgb = comp_rgb + (1.0 - opacity)[:, None] * background_color[None]
        rays_valid = (weights > 0).any(1)
        return RenderResult(comp_rgb, opacity, depth, comp_normal, weights,
                            sdf, grad, t_mid, dists, mask, rays_valid)
