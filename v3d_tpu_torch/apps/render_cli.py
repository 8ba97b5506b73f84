"""Re-render a trained 3DGS scene (counterpart of v3d_tpu/apps/render_cli.py,
itself of recon/render_spiral.py, render.py, render_depth.py and
render_points.py): load a point_cloud.ply and render an orbit or a smooth
spiral through the orbit's 18 views.

    python -m v3d_tpu_torch.apps.render_cli --ply scene/point_cloud.ply \\
        --output renders/ [--mode spiral|orbit|depth|points]

Modes: "spiral" interpolates ``num_frames // 18`` poses between each pair of
the 18 orbit views (60 -> 54 frames, as the JAX CLI); "orbit" and "depth"
take ``num_frames`` orbit views; "points" is the orbit with the gaussians
shrunk to dots (scaling modifier 0.1).  The frames go to ``output/<mode>.mp4``
(mp4v at 10 fps, as the JAX CLI writes them; cv2 needed) and as PNG files
under ``output/<mode>/`` (in "depth" mode the turbo-coloured depth, which
the JAX CLI's depth.mp4 holds).  ``export_blender_cameras`` writes the
orbit's transforms.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch


def _write_pngs(folder: str, frames: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(folder, f"{i:04d}.png"))


def render_scene(ply_path: str, output: str, mode: str = "spiral",
                 num_frames: int = 60, resolution: int = 512,
                 radius: float = 2.0, elevation: float = 0.0,
                 fov: float = 60.0, white_background: bool = True,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Render the PLY's gaussians on ``device`` (the card unless the caller
    passes another) and write the frames; returns the float rgb (N, H, W,
    3) and depth (N, H, W) renders."""
    from v3d_tpu_torch.data.cam_paths import get_interpolated_path
    from v3d_tpu_torch.data.cameras import Camera, get_uniform_poses
    from v3d_tpu_torch.data.video_io import write_video
    from v3d_tpu_torch.gs.gaussians import Gaussians
    from v3d_tpu_torch.gs.ply import load_ply
    from v3d_tpu_torch.gs.render import render
    from v3d_tpu_torch.utils.colormaps import apply_depth_colormap

    dev = torch.device(device)
    g = Gaussians(**{k: torch.tensor(v, device=dev)
                     for k, v in load_ply(ply_path).items()})
    sh_degree = int(np.sqrt(1 + g.f_rest.shape[1])) - 1
    if mode == "spiral":
        base = get_uniform_poses(18, radius, elevation)
        poses = get_interpolated_path(base, max(1, num_frames // 18))
    else:
        poses = get_uniform_poses(num_frames, radius, elevation)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    # "points": gaussians shrunk to dots (recon/render_points.py:31)
    scaling_mod = 0.1 if mode == "points" else 1.0
    rgbs, depths = [], []
    with torch.no_grad():
        for pose in poses:
            cam = Camera.from_c2w(pose, fov, resolution, resolution)
            out = render(g, cam, bg, active_sh_degree=sh_degree,
                         scaling_modifier=scaling_mod)
            rgbs.append(out.image.cpu().numpy())
            depths.append(out.depth.cpu().numpy())
    rgbs, depths = np.stack(rgbs), np.stack(depths)
    if mode == "depth":
        frames = np.stack([apply_depth_colormap(d) for d in depths])
    else:
        frames = np.clip(rgbs, 0, 1)
    frames = (frames * 255).astype(np.uint8)
    _write_pngs(os.path.join(output, mode), frames)
    write_video(os.path.join(output, f"{mode}.mp4"), frames, fps=10)
    print(f"rendered {len(poses)} views to {os.path.join(output, mode)} and "
          f"{mode}.mp4")
    return rgbs, depths


def export_blender_cameras(output: str, num_frames: int = 18,
                           radius: float = 2.0, elevation: float = 0.0,
                           fov_deg: float = 60.0) -> str:
    """recon/convert_to_blender.py: a transforms.json with the orbit cameras
    (OpenGL convention) for external tooling; returns its path."""
    from v3d_tpu_torch.data.cameras import get_uniform_poses

    poses = get_uniform_poses(num_frames, radius, elevation, opengl=True)
    meta = {
        "camera_angle_x": float(np.deg2rad(fov_deg)),
        "frames": [{"file_path": f"r_{i}",
                    "transform_matrix": poses[i].tolist()}
                   for i in range(num_frames)],
    }
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "transforms.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ply", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default="spiral",
                   choices=["spiral", "orbit", "depth", "points"])
    p.add_argument("--num-frames", type=int, default=60)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    render_scene(args.ply, args.output, args.mode, args.num_frames,
                 args.resolution, device=args.device)


if __name__ == "__main__":
    main()
