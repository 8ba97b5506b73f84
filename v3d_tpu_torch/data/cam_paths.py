"""Camera path tooling (counterpart of v3d_tpu/data/cam_paths.py, a copy
kept here so that the port imports nothing of the JAX package; itself of
sgm/data/cam_utils.py: quaternion slerp :514, interpolated orbit paths
:190, auto_orient_and_center_poses :924).

Used for scene-level training data (CO3D/MVImageNet) and for rendering
smooth spiral paths from fitted scenes."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def matrix_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation (cam_utils.py:514)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = np.dot(q0, q1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)


def interpolate_poses(c2w0: np.ndarray, c2w1: np.ndarray, t: float) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    q = slerp(quat_from_matrix(c2w0[:3, :3]), quat_from_matrix(c2w1[:3, :3]), t)
    out[:3, :3] = matrix_from_quat(q)
    out[:3, 3] = (1 - t) * c2w0[:3, 3] + t * c2w1[:3, 3]
    return out


def get_interpolated_path(poses: np.ndarray, steps_per_transition: int = 10,
                          closed: bool = True) -> np.ndarray:
    """Smooth path through the given c2w poses (cam_utils.py:190)."""
    n = len(poses)
    pairs = n if closed else n - 1
    out = []
    for i in range(pairs):
        a, b = poses[i], poses[(i + 1) % n]
        for s in range(steps_per_transition):
            out.append(interpolate_poses(a, b, s / steps_per_transition))
    return np.stack(out)


def auto_orient_and_center_poses(
        poses: np.ndarray, method: str = "up",
        center_method: str = "poses") -> Tuple[np.ndarray, np.ndarray]:
    """cam_utils.py:924: recenter camera cloud and align mean up with +z.
    Returns (oriented poses, applied 3x4 transform)."""
    origins = poses[:, :3, 3]
    if center_method == "poses":
        center = origins.mean(0)
    elif center_method == "focus":
        center = _focus_of_attention(poses)
    else:
        center = np.zeros(3)
    translation = -center

    if method == "up":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        rot = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        rot = np.eye(3)
    transform = np.concatenate([rot, (rot @ translation)[:, None]], axis=1)
    out = poses.copy()
    out[:, :3, 3] = (rot @ (origins + translation).T).T
    out[:, :3, :3] = np.einsum("ij,njk->nik", rot, poses[:, :3, :3])
    return out.astype(np.float32), transform.astype(np.float32)


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    v = np.cross(a, b)
    c = np.dot(a, b)
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1 + c)


def _focus_of_attention(poses: np.ndarray) -> np.ndarray:
    """Least-squares intersection point of the camera forward rays."""
    dirs = -poses[:, :3, 2]  # OpenGL forward
    origins = poses[:, :3, 3]
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, d in zip(origins, dirs):
        P = np.eye(3) - np.outer(d, d)
        A += P
        b += P @ o
    return np.linalg.solve(A + 1e-8 * np.eye(3), b)


def normalize_scene_poses(c2ws: np.ndarray, target_radius: float = 1.5
                          ) -> Tuple[np.ndarray, float]:
    """GObjaverse pose normalization (sgm/data/objaverse.py:390-396):
    scale = target_radius / mean camera distance."""
    radius = np.linalg.norm(c2ws[:, :3, 3], axis=1).mean()
    scale = target_radius / radius
    out = c2ws.copy()
    out[:, :3, 3] *= scale
    return out, float(scale)
