"""NeuS mesh reconstruction CLI (counterpart of v3d_tpu/apps/recon_neus.py,
itself of mesh_recon/launch.py with the v3d dataset and the videonvs-neus
system): fits an SDF field to the 18 generated frames on the fixed orbit
(radius 2, elevation 0, FOV 60, OpenGL poses), extracts the marching-tets
mesh and colours its vertices from the radiance field.

    python -m v3d_tpu_torch.apps.recon_neus --frames FRAMES --output DIR

``FRAMES`` is an ``.mp4`` (as ``apps.generate`` writes it), a folder of
PNG frames (sorted by name) or an ``.npy`` of (T, H, W, 3) frames.
Outputs: ``DIR/mesh.obj``, ``DIR/mesh.glb``, ``DIR/config.json`` and
``DIR/snapshot/`` (config, git state, sources: ``utils.snapshot``); an
empty isosurface (a degenerate fit) writes no mesh.

Normal supervision, first found: ``--normals`` (world normals), the DPT
predictor's normals from ``--dpt-weights`` or ``$V3D_TPU_DPT_WEIGHTS`` (the
Omnidata .ckpt or the JAX package's .npz; the reference's default), the
silhouette's weak normals with ``--silhouette-normals``, else none.

The recipe follows the JAX CLI's backend switch (recon_neus.py:81-97).  On
the card: frequency encoding with its mask over the first half of the
steps, the exact SDF gradient, a 128 x 4 geometry MLP, 64 coarse probes
then max(64, num_samples // 4) fine samples, no occupancy lookup, rays in
chunks of 128.  On the CPU: the reference's hash grid, finite differences,
a 64 x 1 MLP, uniform samples and the occupancy lookup.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from v3d_tpu_torch.apps.recon_gs import read_frames
from v3d_tpu_torch.data.cameras import fov2focal, get_ray_directions, get_uniform_poses
from v3d_tpu_torch.meshops.mcubes import isosurface
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.nerf.system import NeusConfig, NeusTrainer
from v3d_tpu_torch.utils.snapshot import snapshot_run
from v3d_tpu_torch.utils.trace import stage


def foreground_masks(frames: np.ndarray, threshold: float = 0.95) -> np.ndarray:
    """Per-frame masks: every pixel that is not near-white (V3D renders on
    white).  The JAX CLI uses its U2Net port when the weights are present."""
    return (~np.all(frames > threshold, axis=-1)).astype(np.float32)


def neus_config(device, max_steps: int = 3000, radius: float = 1.0,
                num_samples: int = 1024, train_num_rays: int = 256,
                with_normals: bool = False) -> NeusConfig:
    """The shipped recipe for ``device``: the accelerator branch on the
    card, the reference branch on the CPU."""
    on_card = torch.device(device).type == "cuda"
    return NeusConfig(
        radius=radius,
        num_samples_per_ray=max(64, num_samples // 4) if on_card else num_samples,
        coarse_to_fine_samples=64 if on_card else 0,
        train_num_rays=train_num_rays, max_steps=max_steps,
        lambda_normal=1.0 if with_normals else 0.0,
        geometry_encoding="frequency" if on_card else "hashgrid",
        grad_type="analytic_fwd" if on_card else "finite_difference",
        geo_neurons=128 if on_card else 64,
        geo_hidden_layers=4 if on_card else 1,
        freq_masking_steps=max_steps // 2 if on_card else 0,
        use_occ_lookup=not on_card,
        ray_chunk=128 if on_card else 0)


def reconstruct(frames: np.ndarray, output: str, max_steps: int = 3000,
                radius: float = 1.0, num_samples: int = 1024,
                train_num_rays: int = 256, fov: float = 60.0,
                cam_radius: float = 2.0, elevation: float = 0.0,
                mc_resolution: int = 384,
                normals: Union[None, str, np.ndarray] = None,
                dpt_weights: Optional[str] = None,
                silhouette_normals: bool = False, seed: int = 0,
                log_every: int = 100, log_fn: Optional[Callable[[Dict], None]] = None,
                train_steps: Optional[int] = None, device="cuda",
                config_overrides: Optional[Dict] = None):
    """Fit NeuS to ``frames`` (T, H, W, 3), uint8 or float in [0, 1], and
    export the mesh under ``output``.  ``normals``: (T, H, W, 3) world
    normals or an .npy of them; else ``dpt_weights`` (default
    ``$V3D_TPU_DPT_WEIGHTS``): the DPT predictor's normals on ``device``,
    lifted to world space; else ``silhouette_normals``: the weak normals
    of ``nerf.normals.normals_from_mask_distance``.  The schedules
    follow ``max_steps``; ``train_steps`` (default ``max_steps``) cuts
    the run.  ``log_fn(stats)`` runs every ``log_every`` steps (default:
    print the losses).  Returns (trainer, mesh, seconds per stage)."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    frames = frames.astype(np.float32)
    t, h, w = frames.shape[:3]
    fg = foreground_masks(frames)
    poses = get_uniform_poses(t, cam_radius, elevation, opengl=True)
    if isinstance(normals, str):
        normals = np.load(normals)
    elif normals is None and (dpt_weights or os.environ.get("V3D_TPU_DPT_WEIGHTS")):
        # the reference's default: DPT Omnidata normals -> world frame
        # (mesh_recon/datasets/v3d.py:173-205)
        from v3d_tpu_torch.nerf.normals import (
            dpt_world_normals,
            load_dpt_normal_predictor,
        )

        predict = load_dpt_normal_predictor(dpt_weights, device=device)
        if predict is None:
            raise FileNotFoundError(f"no DPT weights at "
                                    f"{dpt_weights or os.environ['V3D_TPU_DPT_WEIGHTS']}")
        normals = dpt_world_normals(predict(frames), fg, poses)
        del predict   # the DPT's weights and activations leave the card
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    elif normals is None and silhouette_normals:
        from v3d_tpu_torch.nerf.normals import normals_from_mask_distance

        normals = normals_from_mask_distance(fg, poses)
    dirs = get_ray_directions(h, w, fov2focal(np.deg2rad(fov), w))
    cfg = neus_config(device, max_steps, radius, num_samples, train_num_rays,
                      with_normals=normals is not None)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    trainer = NeusTrainer(frames, fg, dirs, poses, normals=normals, config=cfg,
                          seed=seed, device=device)

    def print_stats(stats):
        print(f"step {trainer.global_step} " + " ".join(
            f"{k}={float(v):.4f}" for k, v in stats.items() if k != "num_rays"),
            flush=True)

    timings = {}
    with stage("recon_neus.train", timings, "train_s", trainer.device):
        trainer.train(max_steps if train_steps is None else train_steps,
                      log_every=log_every, log_fn=log_fn or print_stats)

    os.makedirs(output, exist_ok=True)
    with open(os.path.join(output, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    # run-reproducibility snapshot (reference utils/callbacks.py:52-95)
    snapshot_run(output, config=cfg)
    with stage("recon_neus.export", timings, "export_s"):
        verts, faces = isosurface(None, radius=radius, resolution=mc_resolution,
                                  grid_fn=trainer.sdf_grid)
    if len(verts) == 0:
        # a degenerate fit: the SDF has no zero crossing; no mesh is written
        print("WARNING: the isosurface is empty (no SDF zero crossing); "
              "no mesh written", flush=True)
        return trainer, Mesh(verts, faces), timings
    with stage("recon_neus.colors", timings, "colors_s"):
        mesh = Mesh(verts, faces).auto_normal()
        mesh.vertex_colors = trainer.vertex_colors(verts)
    with stage("recon_neus.write", timings, "write_s"):
        obj_path = os.path.join(output, "mesh.obj")
        mesh.write_obj(obj_path)
        mesh.write_glb(os.path.join(output, "mesh.glb"))
    print(f"saved {obj_path} ({len(verts)} verts, {len(faces)} faces)", flush=True)
    return trainer, mesh, timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", "--video", required=True,
                   help="an .mp4, a folder of PNG frames, or an .npy of (T, H, W, 3)")
    p.add_argument("--output", required=True)
    p.add_argument("--max-steps", type=int, default=3000)
    p.add_argument("--mc-resolution", type=int, default=384)
    p.add_argument("--normals", default=None,
                   help="optional (T,H,W,3) world-space normals .npy")
    p.add_argument("--dpt-weights", default=None,
                   help="Omnidata DPT .ckpt or converted .npz for normal "
                        "supervision (default: $V3D_TPU_DPT_WEIGHTS)")
    p.add_argument("--silhouette-normals", action="store_true",
                   help="opt-in weak normals from the silhouette distance "
                        "transform (no DPT weights needed)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    reconstruct(read_frames(args.frames), args.output, args.max_steps,
                mc_resolution=args.mc_resolution, normals=args.normals,
                dpt_weights=args.dpt_weights,
                silhouette_normals=args.silhouette_normals, device=args.device)


if __name__ == "__main__":
    main()
