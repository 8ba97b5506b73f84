"""Scene reconstruction CLI (counterpart of v3d_tpu/apps/recon_scene.py,
itself of recon/train_scene.py for 3DGS on posed captures and
mesh_recon/systems/neus_pinhole.py + datasets/videonvs_co3d.py:212 for
pinhole-scene NeuS).

Fits 3DGS or NeuS to a posed multi-view scene instead of the fixed V3D
orbit.  Layouts: blender / videonvs ``transforms_*.json``, a COLMAP
workspace, DTU ``cameras.npz``, or a CO3D category / sequence directory.

    python -m v3d_tpu_torch.apps.recon_scene --scene data/lego \\
        --format blender --method gs --output out/
    python -m v3d_tpu_torch.apps.recon_scene --scene co3d/ --format co3d \\
        --category hydrant --method neus --output out/ [--device cpu]

3DGS goes through ``GSTrainer`` (on the card: the compositor kernels K4 /
K5 at the scene's own size; sides need not be multiples of 16).  NeuS
picks its recipe from the device as ``apps.recon_neus`` does: on the card
the frequency encoding, the exact SDF gradient, 64 coarse + 256 fine
samples; on the CPU the hash grid, finite differences and 1024 uniform
samples.  Both fits run chunks of steps between log points
(``GSTrainer.train``, ``NeusTrainer.train(n, chunk)``).  Outputs:
``point_cloud.ply`` (gs) or ``mesh.obj`` (neus).
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np
import torch

from v3d_tpu_torch.data import scene_datasets as sd


def load_scene(args) -> sd.SceneFrames:
    if args.format == "blender":
        return sd.load_blender_scene(args.scene, args.split)
    if args.format == "videonvs":
        return sd.load_videonvs_scene(args.scene)
    if args.format == "colmap":
        return sd.load_colmap_scene(args.scene)
    if args.format == "dtu":
        return sd.load_dtu_scene(args.scene)
    if args.format == "co3d":
        return sd.load_co3d_scene(args.scene, args.category, args.sequence,
                                  reso=args.reso, num_frames=args.num_frames)
    raise SystemExit(f"unknown scene format: {args.format}")


def scene_cameras(scene: sd.SceneFrames) -> list:
    """SceneFrames -> 3DGS Cameras: per-frame FoV from K (the principal
    point is taken as centred: true of blender / videonvs renders and the
    box-cropped CO3D frames; dataset_readers.py:458-477)."""
    from v3d_tpu_torch.data.cameras import Camera

    cams = []
    h, w = scene.images.shape[1:3]
    for i in range(scene.num_frames):
        c2w = scene.c2ws[i].copy()
        if scene.opengl:
            c2w[:, 1:3] *= -1  # OpenGL -> OpenCV for the GS camera stack
        fov_deg = math.degrees(2 * math.atan(w / (2 * scene.intrinsics[i][0, 0])))
        img = scene.images[i]
        if scene.fg_masks is not None:
            # composite to white like the orbit pipeline (train_from_vid)
            m = scene.fg_masks[i][..., None]
            img = img * m + (1 - m)
        cams.append(Camera.from_c2w(c2w, fov_deg, w, h, image=img))
    return cams


def run_gs(scene: sd.SceneFrames, args, log_fn=None):
    """Fit gaussians (the transient-free recipe by default) and write
    ``point_cloud.ply``.  ``log_fn(stats)`` replaces the default log (the
    loss and view 0's PSNR) every ``log_every`` iterations."""
    from v3d_tpu_torch.gs.losses import psnr
    from v3d_tpu_torch.gs.ply import save_ply
    from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer

    cams = scene_cameras(scene)
    cfg = GSTrainConfig(iterations=args.iterations,
                        lambda_dssim=args.lambda_dssim,
                        max_per_coarse=args.kc,
                        max_per_tile=args.max_per_tile,
                        tile_chunk=args.tile_chunk,
                        opacity_reset_mode=args.opacity_reset_mode,
                        opacity_decay=args.opacity_decay)
    trainer = GSTrainer(cams, cfg, num_pts=args.num_pts, seed=args.seed,
                        radius=args.init_radius, device=args.device)

    def print_stats(stats):
        p = float(psnr(trainer.render_view(0).image, trainer.images[0]))
        print(f"iter {stats['iter']} loss {float(stats['loss']):.4f} "
              f"psnr {p:.2f}", flush=True)

    trainer.train(args.iterations, log_every=args.log_every,
                  log_fn=log_fn or print_stats)
    os.makedirs(args.output, exist_ok=True)
    ply_path = os.path.join(args.output, "point_cloud.ply")
    save_ply(ply_path, trainer.gaussians_np())
    print(f"saved {ply_path}", flush=True)
    return trainer


def neus_scene_config(device, iterations: int, rays: int, masked: bool):
    """The JAX CLI's pinhole-scene recipe (recon_scene.py:108-124): the
    frequency encoding with the exact gradient, fixed ray count, no
    occupancy lookup; 64 coarse + 256 fine samples on the card, 1024
    uniform ones on the CPU; the mask loss where the scene has masks, a
    learned background where it has none."""
    from v3d_tpu_torch.nerf.system import NeusConfig

    on_card = torch.device(device).type == "cuda"
    return NeusConfig(
        max_steps=iterations,
        geometry_encoding="frequency", grad_type="analytic_fwd",
        dynamic_ray_sampling=False,
        train_num_rays=rays, max_train_num_rays=rays,
        use_occ_lookup=False, lambda_normal=0.0,
        coarse_to_fine_samples=64 if on_card else 0,
        num_samples_per_ray=256 if on_card else 1024,
        ray_chunk=min(rays, 128),
        learned_background=not masked,
        lambda_mask=1.0 if masked else 0.0,
        background_color="white")


def neus_directions(scene: sd.SceneFrames) -> np.ndarray:
    """Camera-space ray directions: one (H, W, 3) set when every frame has
    the same K, else one per frame, (N, H, W, 3) (neus_pinhole.py:89-94)."""
    from v3d_tpu_torch.data.cameras import get_ray_directions

    h, w = scene.images.shape[1:3]
    Ks = scene.intrinsics
    if np.allclose(Ks, Ks[:1], atol=1e-4):
        return get_ray_directions(h, w, float(Ks[0][0, 0]),
                                  (float(Ks[0][0, 2]), float(Ks[0][1, 2])))
    return np.stack([get_ray_directions(h, w, float(K[0, 0]),
                                        (float(K[0, 2]), float(K[1, 2])))
                     for K in Ks])


def run_neus(scene: sd.SceneFrames, args, log_fn=None):
    """Pinhole NeuS on the scene's own intrinsics, then the marching-tets
    mesh at ``mc_resolution`` written as ``mesh.obj``.  Returns (trainer,
    mesh)."""
    from v3d_tpu_torch.meshops.mcubes import isosurface
    from v3d_tpu_torch.meshops.mesh import Mesh
    from v3d_tpu_torch.nerf.system import NeusTrainer

    masks = (scene.fg_masks if scene.fg_masks is not None
             else np.ones(scene.images.shape[:3], np.float32))
    cfg = neus_scene_config(args.device, args.iterations, args.rays,
                            masked=scene.fg_masks is not None)
    trainer = NeusTrainer(scene.images, masks, neus_directions(scene), scene.c2ws,
                          config=cfg, seed=args.seed, device=args.device)

    def print_stats(stats):
        print(f"step {trainer.global_step} loss {float(stats['loss']):.4f}",
              flush=True)

    # the JAX CLI's loop (recon_scene.py:134-136): chunks of up to 50 steps
    # per log interval (CUDA graph replays on the card)
    for start in range(0, args.iterations, args.log_every):
        n = min(args.log_every, args.iterations - start)
        stats = trainer.train(n, chunk=min(50, n))
        (log_fn or print_stats)(stats)
    os.makedirs(args.output, exist_ok=True)
    verts, faces = isosurface(None, radius=cfg.radius,
                              resolution=args.mc_resolution,
                              grid_fn=trainer.sdf_grid)
    mesh = Mesh(verts, faces)
    if len(verts) == 0:
        print("WARNING: the isosurface is empty (no SDF zero crossing); no "
              "mesh written", flush=True)
        return trainer, mesh
    mesh = mesh.auto_normal()
    obj_path = os.path.join(args.output, "mesh.obj")
    mesh.write_obj(obj_path)
    print(f"saved {obj_path} ({len(verts)} verts, {len(faces)} faces)", flush=True)
    return trainer, mesh


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scene", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--format", default="blender",
                   choices=["blender", "videonvs", "colmap", "dtu", "co3d"])
    p.add_argument("--method", default="gs", choices=["gs", "neus"])
    p.add_argument("--split", default="train")
    p.add_argument("--category", default="hydrant")
    p.add_argument("--sequence", default=None)
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--num-frames", type=int, default=0)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--num-pts", type=int, default=100_000)
    p.add_argument("--init-radius", type=float, default=1.5)
    p.add_argument("--lambda-dssim", type=float, default=0.2)
    p.add_argument("--kc", type=int, default=4096)
    p.add_argument("--max-per-tile", type=int, default=256,
                   help="per-tile depth-slab size of the GS rasterizer")
    p.add_argument("--tile-chunk", type=int, default=32)
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--mc-resolution", type=int, default=128)
    p.add_argument("--opacity-reset-mode", default="none",
                   choices=["none", "hard"],
                   help="'none' (default): the transient-free recipe; 'hard': "
                        "the reference's reset schedule")
    p.add_argument("--opacity-decay", type=float, default=0.995)
    p.add_argument("--log-every", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    return p


def main(argv=None, log_fn=None) -> Optional[object]:
    """Parse ``argv``, load the scene, fit; returns the trainer (``run_gs``)
    or (trainer, mesh) (``run_neus``)."""
    args = parser().parse_args(argv)
    scene = load_scene(args)
    print(f"scene: {scene.num_frames} frames "
          f"{scene.images.shape[1]}x{scene.images.shape[2]}", flush=True)
    if args.method == "gs":
        return run_gs(scene, args, log_fn)
    return run_neus(scene, args, log_fn)


if __name__ == "__main__":
    main()
