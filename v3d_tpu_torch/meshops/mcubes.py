"""Isosurface extraction (counterpart of v3d_tpu/meshops/mcubes.py, the
replacement for torchmcubes / mcubes of mesh_recon/models/geometry.py:32-113).

Marching tetrahedra on a dense SDF grid: each cube splits into 6 tetrahedra
with a fixed topology, giving watertight meshes with simple tables.  The
C++ core (``v3d_tpu_torch/native``) runs by default and raises if it cannot
be built; the numpy version runs when the caller asks for
``use_native=False``.  ``isosurface`` is the reference's two-pass
coarse -> refined-box extraction.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

# 6 tetrahedra per cube (corner indices in binary z|y|x order)
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], np.int32)

_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)


def marching_tets(sdf: np.ndarray, level: float = 0.0,
                  origin: Tuple[float, float, float] = (-1, -1, -1),
                  spacing: Optional[float] = None, use_native: bool = True):
    """sdf: (N, N, N) -> (vertices (V,3), faces (F,3)).  Vertices are placed
    by linear interpolation along tet edges crossing ``level``.

    ``use_native``: the C++ core (``native/marching_tets.cc``, built on
    first use); the numpy version materialises (cells x 8) tensors, which is
    gigabytes at the reference's 384^3 export resolution."""
    n = sdf.shape[0]
    if spacing is None:
        spacing = 2.0 / (n - 1)
    if use_native:
        from v3d_tpu_torch.native import marching_tets_native

        verts, faces = marching_tets_native(np.asarray(sdf, np.float32), level)
        verts = verts * spacing + np.asarray(origin, np.float32)
        return verts.astype(np.float32), faces.astype(np.int32)
    # cube corner values for all cells: (n-1)^3 x 8
    cells = np.stack(np.meshgrid(*([np.arange(n - 1)] * 3), indexing="ij"),
                     axis=-1).reshape(-1, 3)
    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]       # (C, 8, 3)
    vals = sdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    verts_list = []
    faces_list = []
    v_count = 0
    # loop over the 6 tet types (vectorized over cells)
    for tet in _TETS:
        tv = vals[:, tet] - level                                # (C, 4)
        inside = tv < 0
        n_in = inside.sum(1)
        # cases with a surface crossing: 1, 2 or 3 corners inside
        for case in (1, 2, 3):
            sel = np.nonzero(n_in == case)[0]
            if len(sel) == 0:
                continue
            tvs = tv[sel]
            ins = inside[sel]
            pos = corner_idx[sel][:, tet]                       # (S, 4, 3)
            tris, vcount = _tet_triangles(tvs, ins, pos.astype(np.float64))
            if tris is None:
                continue
            verts_list.append(tris.reshape(-1, 3))
            faces_list.append(
                np.arange(tris.shape[0] * 3).reshape(-1, 3) + v_count)
            v_count += tris.shape[0] * 3

    if not verts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts_list, axis=0)
    faces = np.concatenate(faces_list, axis=0)
    verts, faces = _weld(verts, faces)
    verts = verts * spacing + np.asarray(origin, np.float64)
    return verts.astype(np.float32), faces.astype(np.int32)


def _edge_point(tvs, pos, a, b):
    """Interpolated crossing point on edge (a, b) per row."""
    va = tvs[:, a]
    vb = tvs[:, b]
    t = va / (va - vb + 1e-12)
    return pos[:, a] + t[:, None] * (pos[:, b] - pos[:, a])


def _tet_triangles(tvs, ins, pos):
    """Triangles for a batch of tets sharing the same inside-count.
    Rows may still have different inside-corner *patterns*, so group by
    pattern."""
    out_tris = []
    patterns = ins[:, 0] * 1 + ins[:, 1] * 2 + ins[:, 2] * 4 + ins[:, 3] * 8
    for pat in np.unique(patterns):
        rows = np.nonzero(patterns == pat)[0]
        inside_corners = [i for i in range(4) if (pat >> i) & 1]
        outside_corners = [i for i in range(4) if not (pat >> i) & 1]
        tv = tvs[rows]
        p = pos[rows]
        if len(inside_corners) == 1:
            a = inside_corners[0]
            pts = [_edge_point(tv, p, a, b) for b in outside_corners]
            tri = np.stack([pts[0], pts[1], pts[2]], axis=1)
            out_tris.append(_orient(tri, p[:, a], inward=True))
        elif len(inside_corners) == 3:
            a = outside_corners[0]
            pts = [_edge_point(tv, p, b, a) for b in inside_corners]
            tri = np.stack([pts[0], pts[1], pts[2]], axis=1)
            out_tris.append(_orient(tri, p[:, a], inward=False))
        else:  # 2 inside, 2 outside -> quad = 2 triangles
            i0, i1 = inside_corners
            o0, o1 = outside_corners
            e00 = _edge_point(tv, p, i0, o0)
            e01 = _edge_point(tv, p, i0, o1)
            e10 = _edge_point(tv, p, i1, o0)
            e11 = _edge_point(tv, p, i1, o1)
            centroid_in = 0.5 * (p[:, i0] + p[:, i1])
            t1 = np.stack([e00, e01, e11], axis=1)
            t2 = np.stack([e00, e11, e10], axis=1)
            out_tris.append(_orient(t1, centroid_in, inward=True))
            out_tris.append(_orient(t2, centroid_in, inward=True))
    if not out_tris:
        return None, 0
    tris = np.concatenate(out_tris, axis=0)
    return tris, tris.shape[0]


def _orient(tri, ref_pt, inward: bool):
    """Flip triangles so normals point away from the inside of the surface.
    ``ref_pt`` is an inside point when ``inward`` else an outside point."""
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    to_ref = ref_pt - tri[:, 0]
    dot = np.sum(n * to_ref, axis=1)
    flip = (dot > 0) if inward else (dot < 0)
    tri[flip] = tri[flip][:, ::-1]
    return tri


def _weld(verts, faces, decimals: int = 6):
    """Merge duplicate vertices."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq, inv[faces]


def isosurface(sdf_fn: Optional[Callable[[np.ndarray], np.ndarray]],
               radius: float,
               resolution: int = 256, coarse_resolution: int = 64,
               threshold: float = 0.0, pad: float = 0.1,
               grid_fn: Optional[Callable] = None):
    """Two-pass extraction (geometry.py:83-113): coarse grid finds the
    occupied bounding box, refined grid meshes only that box.

    ``grid_fn(lo, hi, resolution=res) -> (res, res, res)`` evaluates a whole
    regular grid at once when provided (e.g. NeusTrainer.sdf_grid, which
    generates the grid on the device); otherwise ``sdf_fn(points (N,3)) ->
    (N,)`` is called on host-built grids."""
    def grid(lo, hi, res):
        axes = [np.linspace(lo[i], hi[i], res, dtype=np.float32)
                for i in range(3)]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        return g, axes

    def eval_grid(lo, hi, res):
        if grid_fn is not None:
            return np.asarray(grid_fn(lo, hi, resolution=res))
        g, _ = grid(lo, hi, res)
        return sdf_fn(g.reshape(-1, 3)).reshape(g.shape[:3])

    lo = np.array([-radius] * 3)
    hi = np.array([radius] * 3)
    coarse = eval_grid(lo, hi, coarse_resolution)
    occ = coarse < threshold
    if not occ.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    idx = np.nonzero(occ)
    cell = 2 * radius / (coarse_resolution - 1)
    lo2 = np.maximum(lo, np.array([i.min() for i in idx]) * cell - radius - pad)
    hi2 = np.minimum(hi, np.array([i.max() for i in idx]) * cell - radius + pad)
    fine = eval_grid(lo2, hi2, resolution)
    # extract in index space, then rescale per-axis into the refined box
    verts, faces = marching_tets(fine, threshold, origin=(0.0, 0.0, 0.0),
                                 spacing=1.0)
    scale = (hi2 - lo2) / (resolution - 1)
    verts = verts * scale[None, :].astype(np.float32) + lo2[None, :].astype(np.float32)
    return verts.astype(np.float32), faces
