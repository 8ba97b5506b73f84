"""Gaussian point cloud (counterpart of v3d_tpu/gs/gaussians.py, itself of
recon/scene/gaussian_model.py:25-166).

Storage (pre-activation, as in the reference):
- xyz      (N, 3)
- f_dc     (N, 1, 3)   SH DC coefficients
- f_rest   (N, M, 3)   higher-order SH (M = (deg+1)^2 - 1)
- scaling  (N, 3)      log-scale
- rotation (N, 4)      unnormalized quaternion (w, x, y, z)
- opacity  (N, 1)      pre-sigmoid logit
- alive    (N,) bool   dead slots are skipped by the rasterizer

Capacity is fixed and slots are rewritten by densify/prune, as in the JAX
package: the trainer's parameters and Adam moments keep one shape for the
whole fit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from v3d_tpu_torch.gs.sh import rgb2sh, sh2rgb

FLOAT_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


@dataclasses.dataclass
class Gaussians:
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion (w,x,y,z) -> rotation matrix
    (recon/utils/general_utils.py build_rotation)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def get_scaling(g: Gaussians) -> torch.Tensor:
    return torch.exp(g.scaling)


def get_opacity(g: Gaussians) -> torch.Tensor:
    return torch.where(g.alive[:, None], torch.sigmoid(g.opacity), 0.0)


def get_features(g: Gaussians) -> torch.Tensor:
    return torch.cat([g.f_dc, g.f_rest], dim=1)


def from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int = 0,
             capacity: Optional[int] = None, device="cuda") -> Gaussians:
    """create_from_pcd (gaussian_model.py:127-166): SH DC from colors, scales
    from sqrt(mean squared 3-NN distance) (simple-knn distCUDA2 equivalent),
    identity rotations, opacity logit of 0.1; slots past the points are dead.
    Built in numpy, then moved to ``device``."""
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    m = (sh_degree + 1) ** 2 - 1

    dist2 = np.maximum(knn_mean_sq_dist(points, k=3), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    op0 = np.log(np.float32(0.1) / (np.float32(1) - np.float32(0.1)))
    arrays = dict(
        xyz=pad(points.astype(np.float32)),
        f_dc=pad(rgb2sh(colors.astype(np.float32))[:, None, :]),
        f_rest=np.zeros((capacity, m, 3), np.float32),
        scaling=pad(scales.astype(np.float32), fill=-10.0),
        rotation=rot,
        opacity=pad(np.full((n, 1), op0, np.float32), fill=-10.0),
        alive=np.arange(capacity) < n)
    dev = torch.device(device)
    return Gaussians(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


def knn_mean_sq_dist(points: np.ndarray, k: int = 3,
                     chunk: int = 4096) -> np.ndarray:
    """Mean squared distance to the k nearest neighbors (excluding self), the
    simple-knn ``distCUDA2`` replacement (gaussian_model.py:20,142): scipy's
    KD-tree, or an exact chunked pairwise computation without scipy."""
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None:
        d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
        return (d[:, 1:].astype(np.float32) ** 2).mean(1)
    n = points.shape[0]
    out = np.empty((n,), np.float32)
    pts = points.astype(np.float32)
    sq = (pts**2).sum(-1)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = sq[s:e, None] + sq[None, :] - 2 * pts[s:e] @ pts.T
        np.fill_diagonal(d2[:, s:e], np.inf)
        d2 = np.maximum(d2, 0.0)
        out[s:e] = np.partition(d2, k, axis=1)[:, :k].mean(1)
    return out


def random_init_pcd(rng: np.random.RandomState, num_pts: int,
                    radius: float = 2.0) -> tuple:
    """VideoNVS random init (dataset_readers.py:485-489): xyz ~ N(0,1) *
    radius/16, uniform SH value 0.2, i.e. RGB = SH2RGB(0.2) ~ 0.556 light
    gray (a dark init drives a global opacity collapse on white-background
    fits)."""
    xyz = rng.randn(num_pts, 3).astype(np.float32) * radius / 16
    colors = np.full((num_pts, 3), float(sh2rgb(0.2)), np.float32)
    return xyz, colors
