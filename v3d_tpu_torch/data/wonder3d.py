"""Wonder3D 6-view ortho predictions loader — the real on-disk format
consumed by the reference's ortho-NeuS system
(mesh_recon/datasets/ortho.py:88-200 ``load_a_prediction`` +
configs/neuralangelo-ortho-wmask.yaml); a port of the JAX package's
``data/wonder3d.py``, numpy on the host.

Layout (a Wonder3D/mvdiffusion output directory)::

    root/<object>/normals_000_<view>.png        RGBA normal maps
    root/<object>/rgb_000_<view>.png            color predictions
    root/<object>/masked_colors/rgb_000_<view>.png  RGBA (alpha = color mask)
    cam_pose_dir/000_<view>_RT.txt              (3,4) world2cam, OpenGL
    views: front, front_right, right, back, left, front_left
    view_weights: [1.0, 0.8, 0.2, 1.0, 0.4, 0.7]  (config :14)

The fixed poses ship with Wonder3D; ``make_fixed_pose`` regenerates them
(orbit radius 1.3, z-up, OpenGL w2c) for tests and defaults — verified
against the reference's datasets/fixed_poses values.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np

from v3d_tpu_torch.nerf.normals import inv_RT

VIEW_TYPES = ("front", "front_right", "right", "back", "left", "front_left")
VIEW_WEIGHTS = (1.0, 0.8, 0.2, 1.0, 0.4, 0.7)
VIEW_AZIMUTHS = {"front": 0.0, "front_right": 45.0, "right": 90.0,
                 "back_right": 135.0, "back": 180.0, "back_left": 225.0,
                 "left": 270.0, "front_left": 315.0}

_FLIP = np.array([1.0, -1.0, -1.0], np.float32)


def make_fixed_pose(view: str, distance: float = 1.3) -> np.ndarray:
    """(3,4) world2cam OpenGL matrix of Wonder3D's fixed ortho cameras
    (datasets/fixed_poses/000_<view>_RT.txt, reproduced to float32): z-up,
    elevation 0, looking at the origin — camera centers on the CORNERS of a
    square of half-size ``distance`` (diagonal views are at distance*sqrt(2),
    matching the shipped txt files)."""
    a = np.deg2rad(VIEW_AZIMUTHS[view])
    c = distance * np.array([np.round(np.sin(a)), np.round(-np.cos(a)), 0.0])
    z = c / np.linalg.norm(c)               # camera looks along -z
    x = np.cross([0.0, 0.0, 1.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    r = np.stack([x, y, z])                  # w2c rotation rows
    t = -r @ c
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


def rt_opengl2opencv(RT: np.ndarray) -> np.ndarray:
    """ortho.py:54-70: flip the y/z camera axes."""
    return (RT[:3] * _FLIP[:, None]).astype(np.float32)


def load_wonder3d_views(root_dir: str, object_name: str,
                        im_size: int = 1024,
                        cam_pose_dir: Optional[str] = None,
                        view_types: Sequence[str] = VIEW_TYPES,
                        normal_system: str = "front") -> Dict[str, np.ndarray]:
    """load_a_prediction (ortho.py:88-200) with load_color=True.

    Returns dict with images (V,H,W,3) [0,1], masks (V,H,W), color_masks,
    normals_world (V,H,W,3), c2ws/w2cs (V,3,4) OpenCV, view_weights (V,).
    """
    from PIL import Image

    def read_rt(view: str) -> np.ndarray:
        if cam_pose_dir is None:
            return make_fixed_pose(view)
        cand = glob.glob(os.path.join(cam_pose_dir, f"*_{view}_RT.txt"))
        if not cand:
            raise FileNotFoundError(f"no RT for view {view} in {cam_pose_dir}")
        return np.loadtxt(cand[0]).astype(np.float32).reshape(3, 4)

    rt_front_cv = rt_opengl2opencv(read_rt("front"))
    obj = os.path.join(root_dir, object_name)
    images, masks, color_masks = [], [], []
    normals_world, c2ws, w2cs = [], [], []
    for view in view_types:
        nrm_img = np.asarray(Image.open(
            os.path.join(obj, f"normals_000_{view}.png"))
            .resize((im_size, im_size)), np.float32)
        mask = nrm_img[:, :, 3]
        normal = nrm_img[:, :, :3] / 255.0 * 2.0 - 1.0   # img2normal
        normal[mask == 0] = 0.0
        mask = mask > 0.5 * 255

        rgb = np.asarray(Image.open(
            os.path.join(obj, f"rgb_000_{view}.png")).convert("RGB")
            .resize((im_size, im_size)), np.float32) / 255.0
        # color-mask chain (ortho.py:113-119): masked_colors alpha, except
        # pixels that are white in the rgb (background leak)
        cmask_img = np.asarray(Image.open(
            os.path.join(obj, "masked_colors", f"rgb_000_{view}.png"))
            .resize((im_size, im_size)), np.float32)
        invalid_color = cmask_img[:, :, 3] < 255 * 0.5
        white = np.all(rgb * 255.0 > 250, axis=-1)
        color_mask = ~(invalid_color & white)

        rt = read_rt(view)
        rt_cv = rt_opengl2opencv(rt)
        c2ws.append(inv_RT(rt_cv))
        w2cs.append(rt_cv)

        normal_cv = normal * _FLIP[None, None]          # normal_opengl2opencv
        ref_rt = rt_front_cv if normal_system == "front" else rt_cv
        rot = inv_RT(ref_rt)[:3, :3]
        normals_world.append(normal_cv @ rot.T)

        images.append(rgb)
        masks.append(mask)
        color_masks.append(color_mask)

    return {
        "images": np.stack(images).astype(np.float32),
        "masks": np.stack(masks).astype(np.float32),
        "color_masks": np.stack(color_masks).astype(np.float32),
        "normals_world": np.stack(normals_world).astype(np.float32),
        "c2ws": np.stack(c2ws).astype(np.float32),
        "w2cs": np.stack(w2cs).astype(np.float32),
        "view_weights": np.asarray(
            [VIEW_WEIGHTS[VIEW_TYPES.index(v)] if v in VIEW_TYPES else 1.0
             for v in view_types], np.float32),
    }
