"""Wonder3D 6-view ortho-NeuS reconstruction CLI (counterpart of
v3d_tpu/apps/recon_neus_ortho.py, itself of mesh_recon/launch.py with
configs/neuralangelo-ortho-wmask.yaml + datasets/ortho.py, the Wonder3D
pipeline's mesh stage).

    python -m v3d_tpu_torch.apps.recon_neus_ortho \\
        --root wonder3d_outputs/ --object owl --output mesh_out/ [--device cpu]

Loss recipe = neuralangelo-ortho-wmask.yaml:83-94 (rgb_mse 0.5, mask 1.0,
eikonal 0.2, normal 1.0, 3d-normal-smooth 1.0, sparsity 0.5) with the
per-view weights [1.0, 0.8, 0.2, 1.0, 0.4, 0.7] of config :14.  The field
follows the device as ``apps.recon_neus`` does (the JAX CLI's backend
switch, recon_neus_ortho.py:45-59): on the card the frequency encoding with
its mask over the first half of the steps, the exact gradient and a 128 x 4
MLP; on the CPU the hash grid, finite differences, a 64 x 1 MLP and the
occupancy lookup.  Output: ``mesh.obj`` with vertex colours.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from v3d_tpu_torch.data.cameras import get_ortho_ray_directions
from v3d_tpu_torch.data.wonder3d import load_wonder3d_views
from v3d_tpu_torch.meshops.mcubes import isosurface
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.nerf.system import NeusConfig, NeusTrainer


def ortho_config(device, max_steps: int = 3000, radius: float = 1.0,
                 num_samples: int = 1024, train_num_rays: int = 256) -> NeusConfig:
    """neuralangelo-ortho-wmask.yaml's losses with the field of ``device``."""
    on_card = torch.device(device).type == "cuda"
    return NeusConfig(
        radius=radius, num_samples_per_ray=num_samples,
        train_num_rays=train_num_rays, max_steps=max_steps,
        lambda_rgb_mse=0.5, lambda_mask=1.0, lambda_eikonal=0.2,
        lambda_normal=1.0, lambda_3d_normal_smooth=1.0,
        lambda_sparsity=0.5, lambda_distortion=0.0, lambda_opaque=0.0,
        geometry_encoding="frequency" if on_card else "hashgrid",
        grad_type="analytic_fwd" if on_card else "finite_difference",
        geo_neurons=128 if on_card else 64,
        geo_hidden_layers=4 if on_card else 1,
        freq_masking_steps=max_steps // 2 if on_card else 0,
        use_occ_lookup=not on_card,
        ray_chunk=128 if on_card else 0)


def ortho_trainer(views: dict, im_size: int, cfg: NeusConfig, seed: int = 0,
                  device="cuda") -> NeusTrainer:
    """A NeusTrainer on ``load_wonder3d_views``'s output: orthographic rays
    (per-pixel origins, directions -z), the OpenCV c2ws turned OpenGL, the
    world normals and the per-view weights."""
    t = views["images"].shape[0]
    origins, dirs = get_ortho_ray_directions(im_size, im_size)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    # ortho.py poses are OpenCV c2w; NeusTrainer expects OpenGL -> flip y/z
    c2ws[:, :3, :4] = views["c2ws"]
    c2ws[:, :, 1:3] *= -1
    return NeusTrainer(views["images"], views["masks"], dirs, c2ws,
                       normals=views["normals_world"], origins=origins,
                       view_weights=views["view_weights"], config=cfg,
                       seed=seed, device=device)


def reconstruct_ortho(root: str, object_name: str, output: str,
                      max_steps: int = 3000, im_size: int = 512,
                      radius: float = 1.0, num_samples: int = 1024,
                      train_num_rays: int = 256, mc_resolution: int = 256,
                      cam_pose_dir: str = None, seed: int = 0,
                      log_every: int = 100, log_fn=None, train_steps: int = None,
                      device="cuda", config_overrides=None):
    """Fit the six views and export ``output/mesh.obj`` with vertex colours.
    The schedules follow ``max_steps``; ``train_steps`` (default
    ``max_steps``) cuts the run; ``log_fn(stats)`` runs every ``log_every``
    steps (default: print the losses).  Returns (trainer, mesh)."""
    views = load_wonder3d_views(root, object_name, im_size=im_size,
                                cam_pose_dir=cam_pose_dir)
    cfg = ortho_config(device, max_steps, radius, num_samples, train_num_rays)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    trainer = ortho_trainer(views, im_size, cfg, seed, device)

    def print_stats(stats):
        print(f"step {trainer.global_step} " + " ".join(
            f"{k}={float(v):.4f}" for k, v in stats.items() if k != "num_rays"),
            flush=True)

    trainer.train(max_steps if train_steps is None else train_steps,
                  log_every=log_every, log_fn=log_fn or print_stats)
    os.makedirs(output, exist_ok=True)
    verts, faces = isosurface(None, radius=radius, resolution=mc_resolution,
                              grid_fn=trainer.sdf_grid)
    mesh = Mesh(verts, faces)
    if len(verts) == 0:
        print("WARNING: the isosurface is empty (no SDF zero crossing); no mesh "
              "written", flush=True)
        return trainer, mesh
    mesh = mesh.auto_normal()
    mesh.vertex_colors = trainer.vertex_colors(verts)
    obj_path = os.path.join(output, "mesh.obj")
    mesh.write_obj(obj_path)
    print(f"saved {obj_path} ({len(verts)} verts)", flush=True)
    return trainer, mesh


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True,
                   help="Wonder3D outputs dir (contains <object>/)")
    p.add_argument("--object", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-steps", type=int, default=3000)
    p.add_argument("--im-size", type=int, default=512)
    p.add_argument("--mc-resolution", type=int, default=256)
    p.add_argument("--cam-pose-dir", default=None,
                   help="dir of 000_<view>_RT.txt poses (default: the built-in "
                        "Wonder3D fixed poses)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    reconstruct_ortho(args.root, args.object, args.output, args.max_steps,
                      im_size=args.im_size, mc_resolution=args.mc_resolution,
                      cam_pose_dir=args.cam_pose_dir, device=args.device)


if __name__ == "__main__":
    main()
