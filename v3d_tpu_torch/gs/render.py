"""Differentiable 3D Gaussian Splatting renderer (counterpart of
v3d_tpu/gs/render.py, itself of recon/gaussian_renderer/__init__.py:22-134).

- ``project_gaussians``: EWA projection of all N gaussians (means -> pixels,
  3D covariance -> 2D conic, SH -> colour), elementwise float32 as in the JAX
  code (the 4x4 transforms as broadcast products: the projection needs full
  float32, and no product here goes through a TF32 path).
- ``build_slabs``: the binning.  Fine tiles of 16x16 are grouped into coarse
  cells of ``coarse_factor``^2 tiles, and each cell keeps its Kc
  depth-nearest overlapping gaussians, sorted near to far (a masked top-k);
  a small scene (N <= Kc) shares one global depth sort.
- ``rasterize``: the slab through the compositor (ops/gs_composite.py: T10
  and T11 on the card, the plain version on the CPU or in
  ``reference_mode()``), background blended from acc, tiles untiled.
- ``render``: projection + rasterization.

CUDA semantics throughout: 0.3 px low-pass on the 2D covariance, 1/255 alpha
cutoff, 0.99 alpha clamp, T < 1e-4 stop, SH colour ``max(sh + 0.5, 0)``,
near plane z > 0.2.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from v3d_tpu_torch.gs.gaussians import (
    Gaussians,
    build_rotation,
    get_features,
    get_opacity,
    get_scaling,
)
from v3d_tpu_torch.gs.sh import eval_sh
from v3d_tpu_torch.ops.gs_composite import TILE, composite


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor     # (N, 3) upper-triangular inverse 2D cov (a, b, c)
    depth: torch.Tensor     # (N,) view-space z
    radius: torch.Tensor    # (N,) screen-space 3-sigma radius (pixels)
    color: torch.Tensor     # (N, 3)
    opacity: torch.Tensor   # (N,)
    valid: torch.Tensor     # (N,) bool


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def project_gaussians(g: Gaussians, cam, active_sh_degree: int = 0,
                      scaling_modifier: float = 1.0) -> ProjectedGaussians:
    """EWA splatting projection (the CUDA preprocess step).  ``cam`` carries
    width, height, fovx, fovy and the row-vector matrices
    (``data.cameras.Camera``; the matrices may be numpy or tensors)."""
    W, H = cam.width, cam.height
    tan_fovx = float(np.tan(cam.fovx * 0.5))
    tan_fovy = float(np.tan(cam.fovy * 0.5))
    fx = W / (2.0 * tan_fovx)
    fy = H / (2.0 * tan_fovy)
    xyz = g.xyz
    wvt = _f32(cam.world_view_transform, xyz.device)
    fpt = _f32(cam.full_proj_transform, xyz.device)
    campos = _f32(cam.camera_center, xyz.device)

    def affine4(m):
        return (xyz[:, 0:1] * m[0][None] + xyz[:, 1:2] * m[1][None]
                + xyz[:, 2:3] * m[2][None] + m[3][None])

    p_view = affine4(wvt)
    p_clip = affine4(fpt)
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    ndc = p_clip[:, :3] * p_w[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1.0) * W - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5], dim=-1)

    tz = p_view[:, 2]
    in_front = tz > 0.2
    safe_tz = torch.where(in_front, tz, 1.0)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(p_view[:, 0] / safe_tz, -limx, limx) * safe_tz
    ty = torch.clamp(p_view[:, 1] / safe_tz, -limy, limy) * safe_tz

    # cov2d = M Sigma M^T with Sigma = L L^T (L = R diag(s)): A = M L, then
    # the three unique entries of A A^T, as broadcast products
    R_w2c = wvt[:3, :3].T
    L = build_rotation(g.rotation) * (get_scaling(g) * scaling_modifier)[:, None, :]
    a0 = fx / safe_tz
    c0 = -fx * tx / safe_tz**2
    a1 = fy / safe_tz
    c1 = -fy * ty / safe_tz**2
    m0 = a0[:, None] * R_w2c[0][None] + c0[:, None] * R_w2c[2][None]
    m1 = a1[:, None] * R_w2c[1][None] + c1[:, None] * R_w2c[2][None]
    A0 = m0[:, 0:1] * L[:, 0, :] + m0[:, 1:2] * L[:, 1, :] + m0[:, 2:3] * L[:, 2, :]
    A1 = m1[:, 0:1] * L[:, 0, :] + m1[:, 1:2] * L[:, 1, :] + m1[:, 2:3] * L[:, 2, :]
    c00 = torch.sum(A0 * A0, dim=-1) + 0.3
    c01 = torch.sum(A0 * A1, dim=-1)
    c11 = torch.sum(A1 * A1, dim=-1) + 0.3

    det = c00 * c11 - c01 * c01
    det_ok = det > 0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    dirs = xyz - campos[None]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    color = torch.clamp(eval_sh(active_sh_degree, get_features(g), dirs) + 0.5,
                        min=0.0)
    opacity = get_opacity(g)[:, 0]
    valid = in_front & det_ok & g.alive & (radius > 0)
    return ProjectedGaussians(means2d, conic, tz, radius, color, opacity, valid)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    max_per_tile: int = 256       # depth chunk of the plain compositor (every
    #                               slab gaussian is composited: no truncation)
    tile_chunk: int = 32          # tiles per chunk of the plain compositor
    coarse_factor: int = 8        # coarse cell = coarse_factor^2 fine tiles
    max_per_coarse: int = 4096    # Kc: gaussians preselected per coarse cell
    force_coarse: bool = False    # take the coarse path even when N <= Kc


class RenderOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 3)
    alpha: torch.Tensor   # (H, W)
    depth: torch.Tensor   # (H, W)
    radii: torch.Tensor   # (N,)


class Slabs(NamedTuple):
    slab: torch.Tensor          # (n_cells, Kq, 10)
    live_count: torch.Tensor    # (n_cells,) int32
    cell_of_tile: torch.Tensor  # (n_tiles,) int32
    tile_xy: torch.Tensor       # (n_tiles, 2) int32
    n_tx: int
    n_ty: int


@functools.lru_cache(maxsize=32)
def _tile_layout(n_tx: int, n_ty: int, cf: int, coarse: bool, device):
    """The static tile raster: each tile's coarse cell and pixel origin."""
    n_tiles = n_tx * n_ty
    tx = np.arange(n_tiles) % n_tx
    ty = np.arange(n_tiles) // n_tx
    cell = ((ty // cf) * -(-n_tx // cf) + tx // cf) if coarse else 0 * tx
    xy = np.stack([tx * TILE, ty * TILE], -1)
    return (torch.tensor(cell, dtype=torch.int32, device=device),
            torch.tensor(xy, dtype=torch.int32, device=device))


def build_slabs(proj: ProjectedGaussians, height: int, width: int,
                config: RasterizeConfig,
                screen_offset: Optional[torch.Tensor] = None) -> Slabs:
    """Binning (render.py:340-414): pack each gaussian's attributes
    [m2(2) | conic(3) | color(3) | op | depth] and preselect the
    depth-sorted slab of every coarse cell; invalid gaussians sort last with
    zero opacity (DEAD rows)."""
    means2d = proj.means2d
    if screen_offset is not None:
        means2d = means2d + screen_offset
    N = means2d.shape[0]
    dev = means2d.device
    n_tx, n_ty = -(-width // TILE), -(-height // TILE)

    depth_masked = torch.where(proj.valid, proj.depth, torch.inf)
    op_eff = torch.where(proj.valid, proj.opacity, 0.0)
    packed = torch.cat([means2d, proj.conic, proj.color, op_eff[:, None],
                        proj.depth[:, None]], dim=1)         # (N, 10)

    cf = config.coarse_factor
    Kc = min(config.max_per_coarse, N)
    coarse = cf > 1 and (N > Kc or config.force_coarse)
    if coarse:
        n_cx, n_cy = -(-n_tx // cf), -(-n_ty // cf)
        ctile = TILE * cf
        cid = torch.arange(n_cx * n_cy, device=dev)
        cxs = ((cid % n_cx) * ctile).float()[:, None]
        cys = ((cid // n_cx) * ctile).float()[:, None]
        gx, gy, r = means2d[:, 0].detach(), means2d[:, 1].detach(), proj.radius
        overlap = ((gx + r >= cxs) & (gx - r <= cxs + ctile)
                   & (gy + r >= cys) & (gy - r <= cys + ctile))
        score = torch.where(overlap, depth_masked[None].detach(), torch.inf)
        neg, idx = torch.topk(-score, Kc, dim=1)              # near -> far
        ok = torch.isfinite(neg)
        slab = torch.where(ok[..., None], packed[idx], 0.0)   # (n_coarse, Kc, 10)
        live_count = ok.sum(1, dtype=torch.int32)
    else:
        order = torch.argsort(depth_masked.detach(), stable=True)
        slab = packed[order][None]                            # (1, N, 10)
        live_count = torch.isfinite(depth_masked).sum(dtype=torch.int32)[None]
    cell, xy = _tile_layout(n_tx, n_ty, cf, coarse, dev)
    return Slabs(slab, live_count, cell, xy, n_tx, n_ty)


def untile(x: torch.Tensor, n_tx: int, n_ty: int, height: int,
           width: int) -> torch.Tensor:
    """(n_tiles, 256[, c]) tile-major -> (height, width, c) row-major."""
    c = x.shape[-1] if x.dim() == 3 else 1
    x = x.reshape(n_ty, n_tx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(n_ty * TILE, n_tx * TILE, c)[:height, :width]


def rasterize(proj: ProjectedGaussians, height: int, width: int,
              background: torch.Tensor,
              config: RasterizeConfig = RasterizeConfig(),
              screen_offset: Optional[torch.Tensor] = None) -> RenderOutput:
    """Tile-based alpha compositing.  ``screen_offset`` is the reference's
    screenspace-points trick: a zeros (N, 2) tensor added to means2d whose
    gradient gives the densification statistic."""
    s = build_slabs(proj, height, width, config, screen_offset)
    D = max(1, min(config.max_per_tile, s.slab.shape[1]))
    rgb, acc, dep = composite(s.slab, s.live_count, s.cell_of_tile, s.tile_xy,
                              depth_chunk=D, tile_chunk=config.tile_chunk)
    # sum_i alpha_i T_i + T_final == 1 (also under the stop mask), so the
    # background weight is exactly 1 - acc
    rgb = rgb + (1.0 - acc)[..., None] * background[None, None, :]
    image = untile(rgb, s.n_tx, s.n_ty, height, width)
    alpha = untile(acc, s.n_tx, s.n_ty, height, width)[..., 0]
    depth = untile(dep, s.n_tx, s.n_ty, height, width)[..., 0]
    radii = torch.where(proj.valid, proj.radius, 0.0)
    return RenderOutput(image, alpha, depth, radii)


def render(g: Gaussians, cam, background: torch.Tensor,
           active_sh_degree: int = 0, scaling_modifier: float = 1.0,
           config: RasterizeConfig = RasterizeConfig(),
           screen_offset: Optional[torch.Tensor] = None) -> RenderOutput:
    """Full render (counterpart of recon/gaussian_renderer/__init__.py:22)."""
    proj = project_gaussians(g, cam, active_sh_degree, scaling_modifier)
    return rasterize(proj, cam.height, cam.width, background, config,
                     screen_offset=screen_offset)
