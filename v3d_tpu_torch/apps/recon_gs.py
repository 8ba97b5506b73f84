"""3DGS reconstruction CLI (counterpart of v3d_tpu/apps/recon_gs.py, itself
of recon/train_from_vid.py): fits gaussians to the 18 generated frames on the
fixed VideoNVS orbit (radius 2, elevation 0, FOV 60) and writes a
reference-compatible ply and the re-rendered orbit.

    python -m v3d_tpu_torch.apps.recon_gs --frames FRAMES --output DIR

``FRAMES`` is the ``.mp4`` or the folder of PNG frames (sorted by name)
that ``v3d_tpu_torch.apps.generate`` writes, or an ``.npy`` file of
(T, H, W, 3) frames, uint8 or float in [0, 1].  Outputs:
``DIR/point_cloud.ply`` and ``DIR/orbit.npy`` (the T re-rendered views,
uint8); from an ``.mp4`` also ``DIR/spiral.mp4`` (those views, 3 fps) and
``DIR/snapshot/`` (config, git state, sources), as the JAX CLI's
``train_from_video`` writes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from v3d_tpu_torch.data.cameras import orbit_cameras
from v3d_tpu_torch.data.video_io import read_video, write_video
from v3d_tpu_torch.gs.losses import psnr
from v3d_tpu_torch.gs.ply import save_ply
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
from v3d_tpu_torch.metrics.lpips import load_lpips
from v3d_tpu_torch.utils.snapshot import snapshot_run


def train_from_frames(frames: np.ndarray, output: str, iterations: int = 4000,
                      num_pts: int = 100_000, lambda_dssim: float = 1.0,
                      lambda_lpips: float = 0.0, radius: float = 2.0, elevation: float = 0.0,
                      fov: float = 60.0, white_background: bool = True,
                      test_every: int = 1000, seed: int = 0,
                      opacity_reset_mode: str = "none",
                      opacity_decay: float = 0.995, capacity: int = 300_000,
                      device="cuda", config_overrides: Optional[Dict] = None,
                      log_fn: Optional[Callable[[Dict], None]] = None,
                      snapshot: bool = False) -> GSTrainer:
    """Fit ``frames`` (T, H, W, 3) on the orbit and write the ply and the
    re-rendered orbit under ``output``.  The defaults are the shipped
    transient-free recipe at the reference operating point: 100k random
    points in 300k slots, SSIM weight 1, no opacity resets, per-step opacity
    decay 0.995.  ``lambda_lpips`` > 0 adds LPIPS (``metrics.lpips``,
    weights from ``$V3D_TPU_LPIPS_WEIGHTS``; without them the term is left
    out with a note, as the JAX CLI does: V3D's readme step 4 uses 2.0).
    ``config_overrides`` replaces fields of the GSTrainConfig;
    ``log_fn(stats)`` runs every ``test_every`` iterations (default: print
    the loss, view 0's PSNR and, at densify events, the alive count); the
    steps between run as chunks of ``chunk_size`` (``GSTrainer.train``).
    ``snapshot`` writes ``output/snapshot/`` (``utils.snapshot``) first."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    frames = frames.astype(np.float32)
    t, h, w = frames.shape[:3]
    if h != w:
        raise ValueError(f"the orbit cameras are square; frames are {h}x{w}")
    cams = orbit_cameras(t, radius=radius, elevation=elevation, fov_deg=fov,
                         resolution=h, images=list(frames))
    cfg = GSTrainConfig(iterations=iterations, lambda_dssim=lambda_dssim,
                        lambda_lpips=lambda_lpips,
                        white_background=white_background,
                        opacity_reset_mode=opacity_reset_mode,
                        opacity_decay=opacity_decay)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    lpips_fn = None
    if lambda_lpips > 0:
        lpips_fn = load_lpips(device=device)
        if lpips_fn is None:
            print("LPIPS weights not found ($V3D_TPU_LPIPS_WEIGHTS): fitting "
                  "without the LPIPS term", flush=True)
    trainer = GSTrainer(cams, cfg, num_pts=num_pts, capacity=capacity,
                        seed=seed, radius=radius, lpips_fn=lpips_fn, device=device)
    os.makedirs(output, exist_ok=True)
    if snapshot:
        snapshot_run(output, config=cfg)

    def print_stats(stats):
        p = float(psnr(trainer.render_view(0).image, trainer.images[0]))
        alive = int(stats["num_alive"]) if "num_alive" in stats else "-"
        print(f"iter {stats['iter']} loss {float(stats['loss']):.4f} "
              f"psnr {p:.2f} alive {alive}", flush=True)

    trainer.train(iterations, log_every=test_every, log_fn=log_fn or print_stats)
    ply_path = os.path.join(output, "point_cloud.ply")
    save_ply(ply_path, trainer.gaussians_np())
    renders = torch.stack([trainer.render_view(i).image for i in range(t)])
    orbit = torch.round(renders.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    np.save(os.path.join(output, "orbit.npy"), orbit)
    return trainer


def train_from_video(video_path: str, output: str, iterations: int = 4000,
                     **kwargs) -> GSTrainer:
    """``train_from_frames`` on the frames of an mp4 (the JAX CLI's entry
    point, recon_gs.py:18-87) with the run's snapshot, then the re-rendered
    orbit written as ``output/spiral.mp4`` (3 fps) beside ``orbit.npy``."""
    trainer = train_from_frames(read_video(video_path), output, iterations,
                                snapshot=True, **kwargs)
    write_video(os.path.join(output, "spiral.mp4"),
                np.load(os.path.join(output, "orbit.npy")), fps=3)
    return trainer


def read_frames(path: str) -> np.ndarray:
    """An .mp4, a folder of PNG frames (sorted by name) or an .npy file ->
    (T, H, W, 3)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.lower().endswith(".mp4"):
        return read_video(path)
    from PIL import Image

    names = sorted(n for n in os.listdir(path) if n.lower().endswith(".png"))
    if not names:
        raise FileNotFoundError(f"no PNG frames in {path}")
    return np.stack([np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                     for n in names])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", "--video", required=True,
                   help="an .mp4, a folder of PNG frames, or an .npy of (T, H, W, 3)")
    p.add_argument("--output", required=True)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--num-pts", type=int, default=100_000)
    p.add_argument("--capacity", type=int, default=300_000,
                   help="gaussian slots (densification headroom)")
    p.add_argument("--lambda-dssim", type=float, default=1.0)
    p.add_argument("--lambda-lpips", type=float, default=0.0,
                   help="LPIPS weight (V3D's readme: 2.0); needs "
                        "$V3D_TPU_LPIPS_WEIGHTS")
    p.add_argument("--radius", type=float, default=2.0)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--opacity-reset-mode", default="none",
                   choices=["none", "hard"],
                   help="'none': the shipped transient-free recipe; 'hard': "
                        "the reference's reset schedule")
    p.add_argument("--opacity-decay", type=float, default=0.995)
    p.add_argument("--test-every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    kwargs = dict(num_pts=args.num_pts, lambda_dssim=args.lambda_dssim,
                  lambda_lpips=args.lambda_lpips, radius=args.radius,
                  elevation=args.elevation, fov=args.fov, test_every=args.test_every,
                  seed=args.seed, opacity_reset_mode=args.opacity_reset_mode,
                  opacity_decay=args.opacity_decay, capacity=args.capacity,
                  device=args.device)
    if args.frames.lower().endswith(".mp4"):
        train_from_video(args.frames, args.output, args.iterations, **kwargs)
    else:
        train_from_frames(read_frames(args.frames), args.output, args.iterations,
                          **kwargs)
    print(f"saved {os.path.join(args.output, 'point_cloud.ply')} and "
          f"{os.path.join(args.output, 'orbit.npy')}")


if __name__ == "__main__":
    main()
