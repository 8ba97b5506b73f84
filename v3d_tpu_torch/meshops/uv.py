"""Chart-based UV atlas unwrap (counterpart of v3d_tpu/meshops/uv.py, a
numpy copy kept here so that the port imports nothing of the JAX package;
the dependency-free replacement for the xatlas call in the reference's kiui
Mesh.auto_uv, mesh_recon/mesh.py:485-523).

Algorithm (numpy, host-side — this runs once per mesh at export time):

1. Bucket faces by dominant normal axis (6 directions) — the classic
   "smart projection" chart seeding.
2. Split each bucket into edge-connected components (union-find) → charts.
3. Project each chart onto its axis plane (sign-aware so textures aren't
   mirrored), normalize to its bounding box.
4. Shelf-pack chart rectangles into the unit square with padding.

Returns the same triple xatlas yields: ``vmapping`` (new-vertex -> old-
vertex), ``ft`` (per-face uv indices), ``vt`` (uv coords).  Vertices on
chart boundaries are duplicated, exactly like a real atlas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _face_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


class _UnionFind:
    def __init__(self, n: int):
        self.p = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        while self.p[root] != root:
            root = self.p[root]
        while self.p[x] != root:
            self.p[x], x = root, self.p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


# (axis, sign) -> the two in-plane axes, ordered so the projection keeps a
# consistent (right-handed, viewed from outside) orientation
_PLANE = {
    (0, +1): (1, 2), (0, -1): (2, 1),
    (1, +1): (2, 0), (1, -1): (0, 2),
    (2, +1): (0, 1), (2, -1): (1, 0),
}


def atlas_unwrap(vertices: np.ndarray, faces: np.ndarray,
                 padding: float = 4.0 / 1024.0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(V,3) float, (F,3) int -> (vmapping (N,), ft (F,3), vt (N,2))."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = _face_normals(v, f)

    # 1. dominant-axis bucket per face
    axis = np.argmax(np.abs(fn), axis=1)                    # (F,)
    sign = np.where(fn[np.arange(len(f)), axis] >= 0, 1, -1)
    bucket = axis * 2 + (sign < 0)                          # 0..5

    # 2. connected components inside each bucket (shared-edge adjacency)
    uf = _UnionFind(len(f))
    edge_owner = {}
    for fi in range(len(f)):
        a, b, c = f[fi]
        for e in ((a, b), (b, c), (c, a)):
            key = (min(e), max(e))
            other = edge_owner.get(key)
            if other is None:
                edge_owner[key] = fi
            elif bucket[other] == bucket[fi]:
                uf.union(other, fi)

    roots = np.array([uf.find(i) for i in range(len(f))])
    chart_ids = {r: i for i, r in enumerate(np.unique(roots))}
    chart_of_face = np.array([chart_ids[r] for r in roots])
    n_charts = len(chart_ids)

    # 3. project each chart; duplicate vertices per (chart, vertex)
    vt_list, vmap_list, ft = [], [], np.zeros_like(f)
    rects = []          # (w, h) per chart in 3D units
    chart_corner = []   # per chart: local uv array start index
    for ci in range(n_charts):
        fsel = np.where(chart_of_face == ci)[0]
        verts = np.unique(f[fsel].ravel())
        local = {vi: k for k, vi in enumerate(verts)}
        ax = axis[fsel[0]]
        sg = sign[fsel[0]]
        u_ax, v_ax = _PLANE[(int(ax), int(sg))]
        uv = v[verts][:, [u_ax, v_ax]]
        uv = uv - uv.min(axis=0, keepdims=True)
        rects.append(uv.max(axis=0))
        chart_corner.append(len(vt_list))
        base = len(vmap_list)
        vmap_list.extend(verts.tolist())
        vt_list.extend(uv.tolist())
        for fi in fsel:
            for j in range(3):
                ft[fi, j] = base + local[f[fi, j]]

    # 4. shelf packing into [0,1]^2
    rects = np.maximum(np.asarray(rects, np.float64), 1e-9)  # (C, 2) w,h
    order = np.argsort(-rects[:, 1])                         # tall first
    total_area = float(np.prod(rects, axis=1).sum())
    scale = 1.0 / max(np.sqrt(total_area) * 1.25, rects.max())
    for _ in range(32):  # shrink until everything fits
        x = y = shelf_h = 0.0
        placed = {}
        ok = True
        for ci in order:
            w, h = rects[ci] * scale
            w_p, h_p = w + 2 * padding, h + 2 * padding
            if x + w_p > 1.0:
                y += shelf_h
                x = shelf_h = 0.0
            if y + h_p > 1.0 or w_p > 1.0:
                ok = False
                break
            placed[ci] = (x + padding, y + padding)
            x += w_p
            shelf_h = max(shelf_h, h_p)
        if ok:
            break
        scale *= 0.9
    else:
        raise RuntimeError("uv packing failed to converge")

    vt = np.asarray(vt_list, np.float64)
    for ci in range(n_charts):
        s = chart_corner[ci]
        e = chart_corner[ci + 1] if ci + 1 < n_charts else len(vt)
        ox, oy = placed[ci]
        vt[s:e] = vt[s:e] * scale + np.asarray([ox, oy])

    vmapping = np.asarray(vmap_list, np.int64)
    return vmapping, ft.astype(np.int32), vt.astype(np.float32)
