"""SDF geometry / radiance fields of NeuS (counterpart of
v3d_tpu/nerf/fields.py; mesh_recon/models/geometry.py VolumeSDF, texture.py
VolumeRadiance, network_utils.py VanillaMLP, neus.py VarianceNetwork).

Linear layers keep torch's (out, in) weights; ``core.convert`` transposes
the Flax (in, out) kernels.  ``init_(gen)`` fills a module's parameters from
an explicit generator (the JAX package's init distributions).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.nerf.encoding import HashGrid, VanillaFrequency, composite_with_xyz


class WNDense(nn.Module):
    """Weight-normalised linear layer: w = g * v / (||v|| + 1e-12), the norm
    over each output's input weights (the JAX package's WNDense, not
    ``torch.nn.utils.weight_norm``, which has no 1e-12)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_features, in_features))
        self.g = nn.Parameter(torch.empty(out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def weight(self) -> torch.Tensor:
        return self.v * (self.g / (torch.linalg.vector_norm(self.v, dim=1) + 1e-12))[:, None]

    def forward(self, x):
        return F.linear(x, self.weight(), self.bias)


class VanillaMLP(nn.Module):
    """network_utils.py:95-140.  With ``sphere_init``: softplus(beta=100)
    activations and the geometric init of Atzmon & Lipman, so the untrained
    network approximates the SDF of a sphere of ``sphere_init_radius``."""

    def __init__(self, dim_in: int, dim_out: int, n_neurons: int = 64,
                 n_hidden_layers: int = 1, sphere_init: bool = False,
                 sphere_init_radius: float = 0.5, weight_norm: bool = False):
        super().__init__()
        self.sphere_init = sphere_init
        self.sphere_init_radius = sphere_init_radius
        dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]
        cls = WNDense if weight_norm else nn.Linear
        self.layers = nn.ModuleList(cls(a, b) for a, b in zip(dims, dims[1:]))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            w = layer.v if isinstance(layer, WNDense) else layer.weight
            n_out, n_in = w.shape
            if self.sphere_init:
                if i == last:
                    w.normal_(math.sqrt(math.pi) / math.sqrt(n_in), 1e-4,
                              generator=gen)
                    layer.bias.fill_(-self.sphere_init_radius)
                elif i == 0:
                    w.zero_()
                    w[:, :3].normal_(0.0, math.sqrt(2) / math.sqrt(n_out),
                                     generator=gen)
                    layer.bias.zero_()
                else:
                    w.normal_(0.0, math.sqrt(2) / math.sqrt(n_out), generator=gen)
                    layer.bias.zero_()
            else:   # flax kaiming_uniform: U(+-sqrt(6 / fan_in))
                bound = math.sqrt(6.0 / n_in)
                w.uniform_(-bound, bound, generator=gen)
                layer.bias.zero_()
            if isinstance(layer, WNDense):
                layer.g.copy_(torch.linalg.vector_norm(w, dim=1))

    def _act(self, x):
        if self.sphere_init:
            return F.softplus(x, beta=100.0)
        return F.relu(x)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self._act(layer(x))
        return self.layers[-1](x)


@functools.lru_cache(maxsize=None)
def _fd_directions(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """+x, -x, +y, -y, +z, -z as (6, 3), made once on ``device`` (a step
    captured in a CUDA graph may not copy from the host)."""
    return torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], dtype=dtype, device=device)


class VolumeSDF(nn.Module):
    """geometry.py:144-237.  Points in world scale [-radius, radius],
    normalised to [0, 1] for the encoding.  ``forward`` returns (sdf, grad,
    feature[, laplace]); the gradient's modes:

    - ``analytic`` / ``analytic_fwd``: the exact gradient of the SDF by
      ``torch.autograd.grad`` with ``create_graph`` while grad mode is on
      (the training loss differentiates through it: eikonal, normal
      smoothness).  The JAX package computes ``analytic_fwd`` in forward
      mode (a linearization and three tangents); the value is the same.
    - ``finite_difference``: central differences with ``eps``, the six
      points clamped to the cube; ``with_laplace`` adds their Laplacian.
    """

    def __init__(self, radius: float = 1.0, feature_dim: int = 13,
                 encoding_type: str = "hashgrid", n_levels: int = 10,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 32,
                 per_level_scale: float = 1.3195079107728942,
                 n_frequencies: int = 8, grad_type: str = "finite_difference",
                 n_neurons: int = 64, n_hidden_layers: int = 1,
                 sphere_init_radius: float = 0.5):
        super().__init__()
        self.radius = radius
        self.grad_type = grad_type
        if encoding_type == "hashgrid":
            self.encoding = HashGrid(n_levels, n_features_per_level,
                                     log2_hashmap_size, base_resolution,
                                     per_level_scale)
        else:
            self.encoding = VanillaFrequency(n_frequencies)
        self.network = VanillaMLP(3 + self.encoding.n_output_dims, feature_dim,
                                  n_neurons, n_hidden_layers, sphere_init=True,
                                  sphere_init_radius=sphere_init_radius,
                                  weight_norm=True)

    def init_(self, gen: torch.Generator) -> None:
        if isinstance(self.encoding, HashGrid):
            self.encoding.init_(gen)
        self.network.init_(gen)

    def field(self, points_world, level_mask=None):
        """Raw network output (..., feature_dim); [..., 0] is the SDF."""
        x = ((points_world + self.radius) / (2 * self.radius)).clamp(0.0, 1.0)
        return self.network(composite_with_xyz(x, self.encoding(x, level_mask)))

    def sdf(self, points_world, level_mask=None):
        return self.field(points_world, level_mask)[..., 0]

    def forward(self, points_world, eps: float = 1e-3, level_mask=None,
                with_grad: bool = True, with_laplace: bool = False):
        if with_grad and self.grad_type in ("analytic", "analytic_fwd") \
                and not with_laplace:
            create_graph = torch.is_grad_enabled()
            with torch.enable_grad():
                p = points_world
                if not p.requires_grad:
                    p = p.detach().requires_grad_(True)
                out = self.field(p, level_mask)
                (grad,) = torch.autograd.grad(out[..., 0].sum(), p,
                                              create_graph=create_graph)
            if not create_graph:
                out = out.detach()
            return out[..., 0], grad, out
        out = self.field(points_world, level_mask)
        sdf = out[..., 0]
        if not with_grad:
            return sdf, out
        # eps: a number or a 0-d tensor (a captured step's input)
        offsets = _fd_directions(points_world.dtype, points_world.device) * eps
        pd = (points_world[..., None, :] + offsets).clamp(-self.radius, self.radius)
        sdf_d = self.field(pd.reshape(-1, 3), level_mask)[..., 0].reshape(
            points_world.shape[:-1] + (6,))
        grad = 0.5 * (sdf_d[..., 0::2] - sdf_d[..., 1::2]) / eps
        if not with_laplace:
            return sdf, grad, out
        laplace = (sdf_d[..., 0::2] + sdf_d[..., 1::2]
                   - 2 * sdf[..., None]).sum(-1) / (eps ** 2)
        return sdf, grad, out, laplace


class VolumeRadiance(nn.Module):
    """texture.py:11-54 (no view direction): [feature ‖ normal] -> MLP
    (64 x 2) -> sigmoid RGB."""

    def __init__(self, feature_dim: int = 13, n_neurons: int = 64,
                 n_hidden_layers: int = 2):
        super().__init__()
        self.network = VanillaMLP(feature_dim + 3, 3, n_neurons, n_hidden_layers)

    def init_(self, gen: torch.Generator) -> None:
        self.network.init_(gen)

    def forward(self, features, normals):
        return torch.sigmoid(self.network(torch.cat([features, normals], dim=-1)))


def contract_to_unisphere(x: torch.Tensor, radius: float) -> torch.Tensor:
    """nerfacc UN_BOUNDED_SPHERE contraction (geometry.py:123): scale by
    1 / radius, map ||x|| > 1 to (2 - 1/||x||) x/||x||, then the radius-2
    ball to [0, 1]^3."""
    x = x / radius
    norm = torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    contracted = torch.where(norm <= 1.0, x, (2.0 - 1.0 / norm) * x / norm)
    return contracted / 4.0 + 0.5


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of the input clamped to [-15, 15]."""
    return torch.exp(x.clamp(-15.0, 15.0))


class VolumeDensity(nn.Module):
    """Background NeRF geometry (geometry.py:116-140): contracted position
    -> frequency encoding -> MLP -> (density, feature)."""

    def __init__(self, radius: float = 1.0, feature_dim: int = 13,
                 n_frequencies: int = 6, n_neurons: int = 64,
                 n_hidden_layers: int = 2, density_bias: float = -1.0):
        super().__init__()
        self.radius = radius
        self.density_bias = density_bias
        self.encoding = VanillaFrequency(n_frequencies)
        self.network = VanillaMLP(3 + self.encoding.n_output_dims, feature_dim,
                                  n_neurons, n_hidden_layers)

    def init_(self, gen: torch.Generator) -> None:
        self.network.init_(gen)

    def forward(self, points_world):
        x = contract_to_unisphere(points_world, self.radius)
        out = self.network(composite_with_xyz(x, self.encoding(x)))
        return trunc_exp(out[..., 0] + self.density_bias), out


class VolumeRadianceBg(nn.Module):
    """Background texture: [feature ‖ freq(dir)] -> MLP -> sigmoid RGB."""

    def __init__(self, feature_dim: int = 13, n_neurons: int = 64,
                 n_hidden_layers: int = 2, n_dir_frequencies: int = 4):
        super().__init__()
        self.dir_encoding = VanillaFrequency(n_dir_frequencies)
        self.network = VanillaMLP(feature_dim + self.dir_encoding.n_output_dims,
                                  3, n_neurons, n_hidden_layers)

    def init_(self, gen: torch.Generator) -> None:
        self.network.init_(gen)

    def forward(self, features, dirs):
        inp = torch.cat([features, self.dir_encoding(dirs * 0.5 + 0.5)], dim=-1)
        return torch.sigmoid(self.network(inp))


class VarianceNetwork(nn.Module):
    """neus.py:24-46: one learnable s, inv_s = exp(10 s)."""

    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.init_val = init_val
        self.variance = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def init_(self, gen: Optional[torch.Generator] = None) -> None:
        self.variance.fill_(self.init_val)

    def forward(self):
        return torch.exp(10.0 * self.variance)
