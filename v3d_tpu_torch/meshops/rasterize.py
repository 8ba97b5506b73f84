"""Differentiable triangle rasterizer (counterpart of
v3d_tpu/meshops/rasterize.py, the nvdiffrast replacement for
mesh_recon/refine.py:42,135-178), plain PyTorch: the JAX package runs it as
plain XLA, not as a Pallas kernel.

16x16 pixel tiles each take the K = min(max_per_tile, F) candidate
triangles with the smallest screen-space ``zmin`` among those whose screen
bbox meets the tile (edges included), then evaluate edge functions and
barycentrics per pixel and keep the nearest covering triangle.

- The candidate lists are built by binning (face, tile) pairs: each visible
  face lists the tiles its bbox meets, the pairs are sorted by ``zmin``
  (stable, so ties keep the lower face index) then by tile (stable), and
  each tile keeps its first K.  That is ``jax.lax.top_k`` of ``-score``
  over every face, as the JAX package takes it: the same set in the same
  order, ties towards the lower index.  Slots past a tile's candidates
  hold face 0 and are marked not ok, as top_k's infinite scores are.
- Antialiased coverage (the dr.antialias analog): each candidate adds
  clamp(d + 1/2, 0, 1) with d its signed pixel distance to the triangle's
  boundary; ``alpha`` is the clipped sum, differentiable w.r.t. vertex
  positions; uncovered pixels with alpha > 0 take the soft-nearest
  candidate's clamped barycentric attributes.
- Tiles run ``tile_chunk`` at a time, each chunk under
  ``torch.utils.checkpoint`` when a gradient flows to the vertex positions
  (the JAX package's ``jax.checkpoint`` over ``lax.map``); the chunks
  yield per pixel the chosen faces and barycentrics, and the attributes
  are interpolated for the whole image at once, at the pixels that take
  them, so the attributes' gradient is one scatter per vertex slot and
  not one per chunk.  The
  candidate selection carries no gradient, as top_k's indices carry none.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

TILE = 16


class RasterOut(NamedTuple):
    attr: torch.Tensor    # (H, W, C) interpolated attributes
    mask: torch.Tensor    # (H, W) hard coverage
    depth: torch.Tensor   # (H, W)
    bary: torch.Tensor    # (H, W, 3)
    alpha: torch.Tensor   # (H, W) antialiased coverage (vertex-position grads)


def tile_candidates(xmin, xmax, ymin, ymax, zmin, f_ok, n_tx: int, n_ty: int,
                    k: int) -> torch.Tensor:
    """Per tile the ``k`` faces of least ``zmin`` (ties: lower index first)
    among the ``f_ok`` faces whose bbox meets the tile, by the JAX
    package's test ``xmax >= tx & xmin <= tx + 16`` (and in y) on the tile's
    origin.  (n_tiles, k) int64, -1 where a tile has fewer."""
    dev = xmin.device
    n_tiles = n_tx * n_ty
    finite = ~(xmin.isnan() | xmax.isnan() | ymin.isnan() | ymax.isnan() | zmin.isnan())
    # i*16 <= xmax  and  xmin <= i*16 + 16, exactly (division by 16 is exact)
    i_lo = (torch.ceil(xmin / TILE) - 1).clamp(0, n_tx)
    i_hi = torch.floor(xmax / TILE).clamp(-1, n_tx - 1)
    j_lo = (torch.ceil(ymin / TILE) - 1).clamp(0, n_ty)
    j_hi = torch.floor(ymax / TILE).clamp(-1, n_ty - 1)
    nx = torch.where(f_ok & finite, (i_hi - i_lo + 1).clamp(min=0), 0).long()
    ny = torch.where(f_ok & finite, (j_hi - j_lo + 1).clamp(min=0), 0).long()
    counts = nx * ny
    face = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    r = torch.arange(face.shape[0], device=dev) - first[face]
    tx = i_lo.long()[face] + r % nx[face]
    ty = j_lo.long()[face] + r // nx[face]
    tile = ty * n_tx + tx
    # pairs are in face order; a stable sort by zmin, then by tile
    order = torch.sort(zmin[face], stable=True).indices
    face, tile = face[order], tile[order]
    order = torch.sort(tile, stable=True).indices
    face, tile = face[order], tile[order]
    per_tile = torch.bincount(tile, minlength=n_tiles)
    rank = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(per_tile, 0)
                                                      - per_tile)[tile]
    keep = rank < k
    cand = torch.full((n_tiles, k), -1, dtype=torch.long, device=dev)
    cand[tile[keep], rank[keep]] = face[keep]
    return cand


def _tile_pixels(device) -> torch.Tensor:
    """(256, 2) pixel offsets (x, y) of a tile, row-major."""
    py, px = np.mgrid[0:TILE, 0:TILE]
    return torch.tensor(np.stack([px.reshape(-1), py.reshape(-1)], -1),
                        dtype=torch.float32, device=device)


def _render_tiles(geo, cand, origin, tile_pix):
    """rasterize.py:86-164 on C tiles, up to the attributes: ``geo`` (F, 9)
    the faces' screen x0 y0 x1 y1 x2 y2 and z0 z1 z2, ``cand`` (C, K) face
    ids (-1: none), ``origin`` (C, 2) the tiles' pixel origins.  Returns
    per pixel the covering face and its barycentrics, the soft-nearest face
    and its clamped barycentrics, coverage, depth and alpha."""
    ok = cand >= 0
    idx = cand.clamp(min=0)
    g = geo[idx]                                                  # (C, K, 9)
    X0, Y0, X1, Y1, X2, Y2, Z0, Z1, Z2 = (g[:, None, :, i] for i in range(9))
    pix = tile_pix[None] + origin[:, None, :]                     # (C, P, 2)
    pxx = pix[:, :, None, 0]
    pyy = pix[:, :, None, 1]
    # edge functions (twice signed area)
    area = (X1 - X0) * (Y2 - Y0) - (X2 - X0) * (Y1 - Y0)
    w0 = (X1 - pxx) * (Y2 - pyy) - (X2 - pxx) * (Y1 - pyy)
    w1 = (X2 - pxx) * (Y0 - pyy) - (X0 - pxx) * (Y2 - pyy)
    w2 = (X0 - pxx) * (Y1 - pyy) - (X1 - pxx) * (Y0 - pyy)
    denom = torch.where(area.abs() < 1e-9, 1e-9, area)
    b0 = w0 / denom
    b1 = w1 / denom
    b2 = w2 / denom
    valid_tri = ok[:, None, :] & (area.abs() > 1e-9)
    inside = (((b0 >= 0) & (b1 >= 0) & (b2 >= 0))
              | ((b0 <= 0) & (b1 <= 0) & (b2 <= 0))) & valid_tri
    z = b0 * Z0 + b1 * Z1 + b2 * Z2
    z = torch.where(inside, z, torch.inf)
    best = torch.argmin(z, dim=-1, keepdim=True)                  # (C, P, 1)
    covered = torch.gather(inside, -1, best)[..., 0]
    bb = torch.cat([torch.gather(b, -1, best) for b in (b0, b1, b2)], -1)
    zbest = torch.where(covered, torch.gather(z, -1, best)[..., 0], 0.0)

    # antialiased coverage: b_i scaled by |area| / edge length is the signed
    # pixel distance to edge i
    winding = torch.sign(torch.where(area == 0, 1.0, area))
    len0 = torch.sqrt((X2 - X1) ** 2 + (Y2 - Y1) ** 2) + 1e-9
    len1 = torch.sqrt((X0 - X2) ** 2 + (Y0 - Y2) ** 2) + 1e-9
    len2 = torch.sqrt((X1 - X0) ** 2 + (Y1 - Y0) ** 2) + 1e-9
    d = torch.minimum(torch.minimum(w0 * winding / len0, w1 * winding / len1),
                      w2 * winding / len2)                        # (C, P, K)
    alpha_k = torch.where(valid_tri, torch.clamp(d + 0.5, 0.0, 1.0), 0.0)
    alpha = torch.clamp(alpha_k.sum(-1), max=1.0)                 # (C, P)

    # nearest-triangle attributes for soft (uncovered) edge pixels
    ksoft = torch.argmax(alpha_k, dim=-1, keepdim=True)
    bsoft = torch.cat([torch.gather(b, -1, ksoft) for b in (b0, b1, b2)], -1)
    bsoft = bsoft.clamp(0.0, 1.0)
    bsoft = bsoft / torch.clamp(bsoft.sum(-1, keepdim=True), min=1e-9)
    return (torch.gather(idx, 1, best[..., 0]), bb, torch.gather(idx, 1, ksoft[..., 0]),
            bsoft, covered, zbest, alpha)


@dataclasses.dataclass(frozen=True)
class MeshRasterizer:
    height: int
    width: int
    max_per_tile: int = 256
    tile_chunk: int = 16

    def __call__(self, verts_clip: torch.Tensor, faces: torch.Tensor,
                 attrs: torch.Tensor) -> RasterOut:
        """verts_clip: (V, 4) clip-space positions; faces (F, 3) integer;
        attrs (V, C) per-vertex attributes."""
        H, W = self.height, self.width
        faces = faces.long()
        w_clip = verts_clip[:, 3:4]
        ndc = verts_clip[:, :3] / torch.where(w_clip.abs() < 1e-9, 1e-9, w_clip)
        # OpenGL-style viewport: x right, y up -> flip y for row-major image
        sx = (ndc[:, 0] * 0.5 + 0.5) * W - 0.5
        sy = (-ndc[:, 1] * 0.5 + 0.5) * H - 0.5
        sz = ndc[:, 2]
        visible_v = w_clip[:, 0] > 1e-6
        geo = torch.stack([sx[faces[:, 0]], sy[faces[:, 0]], sx[faces[:, 1]],
                           sy[faces[:, 1]], sx[faces[:, 2]], sy[faces[:, 2]],
                           sz[faces[:, 0]], sz[faces[:, 1]], sz[faces[:, 2]]], -1)
        n_tx, n_ty = -(-W // TILE), -(-H // TILE)
        n_tiles = n_tx * n_ty
        K = min(self.max_per_tile, faces.shape[0])
        with torch.no_grad():
            xs, ys = geo[:, 0:6:2], geo[:, 1:6:2]
            f_ok = visible_v[faces].all(-1)
            cand = tile_candidates(xs.amin(-1), xs.amax(-1), ys.amin(-1),
                                   ys.amax(-1), geo[:, 6:].amin(-1), f_ok,
                                   n_tx, n_ty, K)
        ids = torch.arange(n_tiles, device=geo.device)
        origin = torch.stack([ids % n_tx, ids // n_tx], -1).float() * TILE
        tile_pix = _tile_pixels(geo.device)
        # the geometry, tile_chunk tiles at a time; checkpointed only where
        # a gradient flows to the vertex positions
        want_grad = torch.is_grad_enabled() and geo.requires_grad
        outs = []
        with torch.set_grad_enabled(want_grad):
            for t0 in range(0, n_tiles, self.tile_chunk):
                args = (geo, cand[t0:t0 + self.tile_chunk],
                        origin[t0:t0 + self.tile_chunk], tile_pix)
                outs.append(checkpoint(_render_tiles, *args, use_reentrant=False)
                            if want_grad else _render_tiles(*args))
        f_best, bb, f_soft, bsoft, covered, z, alpha = (torch.cat(p) for p in zip(*outs))

        # the attributes, all pixels at once: the covering face's where the
        # pixel is covered, else the soft-nearest one's where alpha > 0, else
        # 0; gathered only at those pixels, so that no gradient is scattered
        # from the others (all onto face 0's vertices)
        need = covered | (alpha > 0)
        tri = faces[torch.where(covered, f_best, f_soft)[need]]  # (N, 3)
        w = torch.where(covered[..., None], bb, bsoft)[need]
        vals = (w[:, 0:1] * attrs[tri[:, 0]] + w[:, 1:2] * attrs[tri[:, 1]]
                + w[:, 2:3] * attrs[tri[:, 2]])
        attr = vals.new_zeros(need.shape + attrs.shape[1:]).index_put((need,), vals)
        bary = torch.where(covered[..., None], bb, 0.0)

        def untile(x):
            x = x.reshape(n_ty, n_tx, TILE, TILE, -1).permute(0, 2, 1, 3, 4)
            return x.reshape(n_ty * TILE, n_tx * TILE, -1)[:H, :W]

        return RasterOut(untile(attr), untile(covered)[..., 0], untile(z)[..., 0],
                         untile(bary), untile(alpha)[..., 0])


def perspective_from_fov(fov_deg: float, aspect: float = 1.0,
                         znear: float = 0.01, zfar: float = 100.0) -> np.ndarray:
    """Standard OpenGL projection (refine.py uses fovy from the orbit)."""
    f = 1.0 / np.tan(np.deg2rad(fov_deg) / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = f / aspect
    P[1, 1] = f
    P[2, 2] = (zfar + znear) / (znear - zfar)
    P[2, 3] = 2 * zfar * znear / (znear - zfar)
    P[3, 2] = -1.0
    return P


def verts_to_clip(verts: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(V, 3) world verts through a (4, 4) column-vector MVP."""
    v_h = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    return v_h @ mvp.T
