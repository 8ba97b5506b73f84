"""Normal supervision for NeuS (counterpart of v3d_tpu/nerf/normals.py
without the DPT predictor, whose weights are not in the repository).

- ``dpt_world_normals``: the coordinate chain of mesh_recon/datasets/
  v3d.py:173-205 applied to DPT outputs (midas -> blender -> OpenCV ->
  world), numpy.
- ``normals_from_mask_distance``: the opt-in weak normals from the
  silhouette's distance transform (``--silhouette-normals``).  The JAX
  package takes OpenCV's path when cv2 imports: ``cv2.distanceTransform(m,
  DIST_L2, 5)``, the 5x5 chamfer distance (weights 1, 1.4, 2.1969, summed
  in float32 by OpenCV 5), then ``cv2.GaussianBlur(d, (7, 7), 0)``, whose
  sigma 0 at size 7 selects OpenCV's fixed 7-tap kernel.  Both are
  computed here in numpy to OpenCV's definition (``chamfer_distance_5x5``,
  ``gaussian_blur_7x7``), so the port needs no cv2.
"""

from __future__ import annotations

import numpy as np


def inv_RT(RT: np.ndarray) -> np.ndarray:
    """Invert a (3,4) or (4,4) pose; returns (3,4) (datasets/ortho.py:81-85)."""
    RT_h = np.concatenate([RT[:3], np.array([[0, 0, 0, 1.0]])], axis=0)
    return np.linalg.inv(RT_h)[:3, :]


def dpt_world_normals(dpt_normals: np.ndarray, fg_masks: np.ndarray,
                      c2w_opengl: np.ndarray) -> np.ndarray:
    """DPT normals (T, H, W, 3) in [0, 1], masks (T, H, W), OpenGL c2w
    (T, 3|4, 4) -> world normals in the reference's packed convention:
    [0,1] -> [-1,1]; axes x (1, -1, -1); zero outside the mask; re-pack to
    [0, 1]; flip to OpenCV on the packed values (as the reference does);
    rotate by the OpenCV c2w rotation."""
    n = np.asarray(dpt_normals, np.float32) * 2.0 - 1.0
    n = n * np.array([1.0, -1.0, -1.0], np.float32)
    masks = np.asarray(fg_masks) > 0.1
    n = np.where(masks[..., None], n, 0.0)
    n = n * 0.5 + 0.5
    flip = np.array([1.0, -1.0, -1.0], np.float32)
    out = []
    for c2w_gl, ni in zip(c2w_opengl, n):
        RT_cv = inv_RT(c2w_gl) * flip[:, None]
        R_c2w_cv = inv_RT(RT_cv)[:3, :3]
        out.append((ni * flip[None, None, :]) @ R_c2w_cv.T)
    return np.stack(out).astype(np.float32)


# the neighbours of OpenCV's first raster pass (distransform.cpp,
# distanceTransform_5x5) with their DIST_L2 mask-5 metrics; the second pass
# uses the mirrored set
_CHAMFER = ((-2, -1, 2.1969), (-2, 1, 2.1969), (-1, -2, 2.1969),
            (-1, -1, 1.4), (-1, 0, 1.0), (-1, 1, 1.4), (-1, 2, 2.1969),
            (0, -1, 1.0))
_FAR = np.finfo(np.float32).max


def _chamfer_pass(t: np.ndarray, mask: np.ndarray) -> None:
    """One raster pass over padded (T, h+4, w+4) float32 distances, in
    place: each pixel takes the least neighbour + metric (float32 sums, as
    OpenCV), zero where ``mask`` is 0.  Pixels run in wavefronts of equal
    3 i + j, which only read earlier fronts."""
    h, w = mask.shape[1:]
    ii, jj = np.mgrid[:h, :w]
    front = (3 * ii + jj).reshape(-1)
    order = np.argsort(front, kind="stable")
    ii, jj = ii.reshape(-1)[order] + 2, jj.reshape(-1)[order] + 2
    cuts = np.flatnonzero(np.diff(front[order])) + 1
    for i, j in zip(np.split(ii, cuts), np.split(jj, cuts)):
        best = t[:, i, j]
        for di, dj, metric in _CHAMFER:
            best = np.minimum(best, t[:, i + di, j + dj] + np.float32(metric))
        t[:, i, j] = np.where(mask[:, i - 2, j - 2], best, np.float32(0))


def chamfer_distance_5x5(masks: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(m, cv2.DIST_L2, 5)`` of each (H, W) mask in
    (T, H, W) (or one (H, W) mask): the distance of each nonzero pixel to
    the nearest zero pixel under the 5x5 chamfer metric, in float32 as
    OpenCV 5 computes it (borders and pixels without a zero start at
    FLT_MAX)."""
    masks = np.asarray(masks)
    single = masks.ndim == 2
    m = (masks[None] if single else masks) != 0
    t = np.full((m.shape[0],) + tuple(s + 4 for s in m.shape[1:]), _FAR, np.float32)
    _chamfer_pass(t, m)
    _chamfer_pass(t[:, ::-1, ::-1], m[:, ::-1, ::-1])
    d = t[:, 2:-2, 2:-2]
    return d[0] if single else d


# getGaussianKernel(7, sigma <= 0): OpenCV's fixed small-kernel table
_GAUSS7 = np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                    0.03125], np.float32)


def _blur_axis(x: np.ndarray, axis: int) -> np.ndarray:
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (3, 3)
    xp = np.pad(x, pad, mode="reflect")

    def tap(k):
        return np.take(xp, np.arange(k, k + n), axis=axis)

    out = _GAUSS7[3] * tap(3)
    for k in (2, 1, 0):
        out = out + _GAUSS7[k] * (tap(k) + tap(6 - k))
    return out


def gaussian_blur_7x7(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (7, 7), 0)`` of float32 (..., H, W) images:
    the separable 7-tap kernel (symmetric taps summed in pairs), rows then
    columns, reflect-101 borders."""
    img = np.asarray(img, np.float32)
    return _blur_axis(_blur_axis(img, img.ndim - 1), img.ndim - 2)


def normals_from_mask_distance(masks: np.ndarray, c2ws: np.ndarray) -> np.ndarray:
    """Weak per-frame normals: the gradient of the blurred silhouette
    distance, lifted to world space by each camera.  (T, H, W) masks ->
    (T, H, W, 3) world normals, zero outside the mask."""
    m_all = (np.asarray(masks) > 0.5).astype(np.uint8)
    dists = gaussian_blur_7x7(chamfer_distance_5x5(m_all))
    out = []
    for m, dist, c2w in zip(m_all, dists, c2ws):
        gy, gx = np.gradient(dist)
        n_cam = np.stack([-gx, gy, np.ones_like(gx) * 0.5], axis=-1)
        n_cam = n_cam / (np.linalg.norm(n_cam, axis=-1, keepdims=True) + 1e-9)
        n_world = n_cam @ c2w[:3, :3].T
        out.append(np.where(m[..., None] > 0, n_world, 0.0))
    return np.stack(out).astype(np.float32)
