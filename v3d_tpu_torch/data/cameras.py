"""Orbit cameras in the 3DGS convention (numpy, host side).

A copy of the JAX package's ``data/cameras.py`` (:18-166): orbit pose
generation (z-up look-at, OpenCV convention with optional OpenGL flip),
world2view / perspective projection as in the 3DGS code, the per-pixel
ray directions and world rays of NeuS, and the orthographic rays of the
Wonder3D views (:169-189).  Matrices are stored transposed (row-vector
convention) and handed to the renderer as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


def c2w_from_up_and_look_at(up: np.ndarray, look_at: np.ndarray,
                            pos: np.ndarray, opengl: bool = False) -> np.ndarray:
    """camera_utils.py:100-126: z = forward (OpenCV); y = -up; x = y x z."""
    up = up / np.linalg.norm(up)
    z = look_at - pos
    z = z / np.linalg.norm(z)
    y = -up
    x = np.cross(y, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.zeros((4, 4), dtype=np.float32)
    c2w[:3, 0] = x
    c2w[:3, 1] = y
    c2w[:3, 2] = z
    c2w[:3, 3] = pos
    c2w[3, 3] = 1.0
    if opengl:
        c2w[..., 1:3] *= -1
    return c2w


def get_uniform_poses(num_frames: int, radius: float, elevation: float,
                      opengl: bool = False) -> np.ndarray:
    """camera_utils.py:128-151: c2w poses on a z-up orbit.
    azimuths = linspace(0, 360, T+1)[:T]; V3D uses radius 2.0, elevation 0."""
    T = num_frames
    azimuths = np.deg2rad(np.linspace(0, 360, T + 1)[:T])
    elev = np.deg2rad(elevation)
    campos = np.stack([
        radius * np.cos(elev) * np.cos(azimuths),
        radius * np.cos(elev) * np.sin(azimuths),
        np.full_like(azimuths, radius * np.sin(elev)),
    ], axis=-1)
    center = np.zeros(3, dtype=np.float32)
    up = np.array([0, 0, 1], dtype=np.float32)
    return np.stack([
        c2w_from_up_and_look_at(up, center, campos[t], opengl=opengl)
        for t in range(T)
    ], axis=0)


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world2view(R: np.ndarray, t: np.ndarray,
               translate: np.ndarray = np.zeros(3),
               scale: float = 1.0) -> np.ndarray:
    """graphics_utils.py:38-49 (getWorld2View2): w2c from the 3DGS (R, T)
    convention — R is c2w rotation, t the w2c translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """graphics_utils.py:51-71: 3DGS perspective matrix (z in [0, zfar])."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """3DGS camera (recon/scene/cameras.py:17-57): row-vector convention —
    matrices are stored transposed, points transform as p_hom @ M."""

    width: int
    height: int
    fovx: float
    fovy: float
    world_view_transform: np.ndarray  # (4,4) = w2c^T
    full_proj_transform: np.ndarray   # (4,4) = (proj @ w2c)^T
    camera_center: np.ndarray         # (3,)
    znear: float = 0.01
    zfar: float = 100.0
    image: Optional[np.ndarray] = None  # (H, W, 3) in [0,1]

    @staticmethod
    def from_c2w(c2w: np.ndarray, fov_deg: float, width: int, height: int,
                 image: Optional[np.ndarray] = None,
                 znear: float = 0.01, zfar: float = 100.0) -> "Camera":
        """Build from an OpenCV-convention c2w pose (dataset_readers.py:458-477:
        R = w2c[:3,:3].T, T = w2c[:3,3])."""
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        fovx = math.radians(fov_deg)
        fovy = focal2fov(fov2focal(fovx, width), height)
        wvt = world2view(R, T).T
        proj = projection_matrix(znear, zfar, fovx, fovy).T
        full = wvt @ proj
        cam_center = np.linalg.inv(wvt)[3, :3]
        return Camera(width=width, height=height, fovx=fovx, fovy=fovy,
                      world_view_transform=wvt.astype(np.float32),
                      full_proj_transform=full.astype(np.float32),
                      camera_center=cam_center.astype(np.float32),
                      znear=znear, zfar=zfar, image=image)


def orbit_cameras(num_frames: int = 18, radius: float = 2.0,
                  elevation: float = 0.0, fov_deg: float = 60.0,
                  resolution: int = 512, images=None) -> list:
    """The V3D orbit camera set (dataset_readers.py:447-489)."""
    poses = get_uniform_poses(num_frames, radius, elevation)
    return [
        Camera.from_c2w(poses[i], fov_deg, resolution, resolution,
                        image=None if images is None else images[i])
        for i in range(num_frames)
    ]


def get_ray_directions(height: int, width: int, focal: float,
                       center: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Per-pixel camera-space ray directions (H, W, 3), OpenGL convention
    (+x right, +y up, -z forward), through the pixel centres
    (mesh_recon/models/ray_utils.py:9-38)."""
    cx = width / 2 if center is None else center[0]
    cy = height / 2 if center is None else center[1]
    i, j = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5,
                       indexing="xy")
    dirs = np.stack([(i - cx) / focal, -(j - cy) / focal,
                     -np.ones_like(i)], axis=-1)
    return dirs.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """(ray_origins, ray_dirs) in world space; dirs normalized
    (ray_utils.py:40-56)."""
    rays_d = directions @ c2w[:3, :3].T
    rays_d = rays_d / (np.linalg.norm(rays_d, axis=-1, keepdims=True) + 1e-12)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return np.ascontiguousarray(rays_o, dtype=np.float32), rays_d.astype(np.float32)


def get_ortho_ray_directions(height: int, width: int, scale: float = 1.0):
    """Orthographic rays (mesh_recon/models/ray_utils.py ortho path, used by
    the Wonder3D-style 6-view systems; the JAX package's cameras.py:169-180):
    per-pixel origins on the image plane, all directions -z (OpenGL)."""
    i, j = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5,
                       indexing="xy")
    origins = np.stack([(i / width - 0.5) * 2 * scale,
                        -(j / height - 0.5) * 2 * scale,
                        np.zeros_like(i)], axis=-1).astype(np.float32)
    dirs = np.zeros_like(origins)
    dirs[..., 2] = -1.0
    return origins, dirs


def get_ortho_rays(origins: np.ndarray, directions: np.ndarray,
                   c2w: np.ndarray):
    """Orthographic rays to world space (cameras.py:183-189)."""
    o = origins @ c2w[:3, :3].T + c2w[:3, 3]
    d = directions @ c2w[:3, :3].T
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12)
    return o.astype(np.float32), d.astype(np.float32)
