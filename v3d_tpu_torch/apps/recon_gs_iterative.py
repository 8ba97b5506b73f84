"""Iterative diffusion-guided 3DGS refinement (counterpart of
v3d_tpu/apps/recon_gs_iterative.py; recon/train_iterative.py:82-128).

Generates the 18-view orbit from the input image, fits 3D Gaussians to it
(the transient-free recipe: no opacity resets, per-step opacity decay
0.995), and every ``resample_period`` iterations after ``resample_start``:
renders the gaussians on the orbit cameras, VAE-encodes the renders,
perturbs the latents as ``sqrt(1 - sigma^2) z + sigma eps`` and runs the
diffusion sampler with them as its initial noise (the sampler's
``prepare`` scales them by sqrt(1 + sigma_max^2), as in the JAX package
and the reference); the decoded views replace the training images.

    python -m v3d_tpu_torch.apps.recon_gs_iterative --input image.png \\
        --checkpoint V3D_512.safetensors --output scene/

Writes ``scene/point_cloud.ply``.  Each resample's draws (the encoder's
latent sample, eps, ``encode_image``'s two) are a ``ResampleDraws``; by
default they come from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from v3d_tpu_torch.apps.generate import sample_one
from v3d_tpu_torch.data.cameras import orbit_cameras
from v3d_tpu_torch.gs.ply import save_ply
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
from v3d_tpu_torch.utils.trace import span, stage


class ResampleDraws(NamedTuple):
    """One resample's standard-normal draws (recon_gs_iterative.py:52-64)."""

    enc: torch.Tensor        # (t, h, w, 4): the renders' latent sample
    eps: torch.Tensor        # (t, h, w, 4): the perturbation
    cond_enc: torch.Tensor   # (1, h, w, 4): encode_image's latent sample
    cond_aug: torch.Tensor   # (1, h, w, 4): encode_image's cond-aug noise


def generator_draws(gen: torch.Generator, t: int, h: int, w: int
                    ) -> Iterator[ResampleDraws]:
    dev = gen.device
    while True:
        yield ResampleDraws(*(torch.randn(shape, generator=gen, device=dev)
                              for shape in ((t, h, w, 4), (t, h, w, 4),
                                            (1, h, w, 4), (1, h, w, 4))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_iterative(input_image: str, output: str, checkpoint: str = None,
                    iterations: int = 4000, resample_period: int = 500,
                    resample_start: int = 1000, resample_sigma: float = 0.1,
                    num_pts: int = 100_000, seed: int = 0, device="cuda",
                    draws: Optional[Iterable[ResampleDraws]] = None
                    ) -> Tuple[GSTrainer, Dict]:
    """The refinement on ``device`` (the card unless the caller asks for
    the CPU); returns the trainer and the seconds of each stage
    (``generate_s``, ``fit_s`` for the fit steps alone, ``resample_s`` one
    per resample), each a span (``utils/trace.py``) that ends on the
    device."""
    from PIL import Image

    dev = torch.device(device)
    timings: Dict = {}
    with stage("recon_gs_iterative.generate", timings, "generate_s"):
        frames, engine, _ = sample_one(np.asarray(Image.open(input_image)),
                                       checkpoint=checkpoint, device=dev)
    timings["resample_s"] = []
    frames_f = frames.astype(np.float32) / 255.0
    t, h = frames.shape[0], frames.shape[1]
    cams = orbit_cameras(t, resolution=h, images=list(frames_f))
    # the transient-free shipped recipe (apps/recon_gs.py): resampling
    # perturbs the targets every resample_period anyway, so reset shocks
    # would compound
    trainer = GSTrainer(cams, GSTrainConfig(iterations=iterations,
                                            opacity_reset_mode="none",
                                            opacity_decay=0.995),
                        num_pts=num_pts, seed=seed, device=dev)
    ed = engine.device
    lh, lw = engine.latent_shape(h, h)[1:3]
    if draws is None:
        draws = generator_draws(torch.Generator(device=ed).manual_seed(seed),
                                t, lh, lw)
    draws = iter(draws)
    image = torch.from_numpy(frames_f[0:1] * 2 - 1)

    with stage("recon_gs_iterative.fit", timings, "fit_s", dev):
        for i in range(iterations):
            trainer.train_iter()
            if i > resample_start and i % resample_period == 0:
                _sync(dev)
                with span("recon_gs_iterative.resample", iteration=i) as resample:
                    d = next(draws)
                    views = torch.stack([trainer.render_view(k).image for k in range(t)])
                    z = engine.encode_first_stage(
                        views * 2 - 1, noise=d.enc) / engine.scale_factor
                    noisy = (math.sqrt(1 - resample_sigma**2) * z
                             + d.eps.to(z.device) * resample_sigma)
                    clip_emb, cond_frames = engine.encode_image(
                        image, 0.02, d.cond_enc, d.cond_aug)
                    c, uc = engine.build_cond(clip_emb, cond_frames, 1, 300, 0.02)
                    z_new = engine.sample_latents(c, uc, h, h, noise=noisy)
                    trainer.images = engine.decode_latents(z_new, decoding_t=6).to(dev)
                    _sync(dev)
                timings["resample_s"].append(resample.seconds)
                print(f"iter {i}: resampled {t} views via diffusion", flush=True)
    timings["fit_s"] -= sum(timings["resample_s"])

    os.makedirs(output, exist_ok=True)
    save_ply(os.path.join(output, "point_cloud.ply"), trainer.gaussians_np())
    return trainer, timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="V3D / SVD checkpoint (.ckpt, .pt, .safetensors); "
                        "default: seeded random weights")
    p.add_argument("--output", required=True)
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--resample-period", type=int, default=500)
    p.add_argument("--resample-start", type=int, default=1000)
    p.add_argument("--resample-sigma", type=float, default=0.1)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    _, timings = train_iterative(args.input, args.output, args.checkpoint,
                                 args.iterations, args.resample_period,
                                 args.resample_start, args.resample_sigma,
                                 device=args.device)
    print(f"saved {os.path.join(args.output, 'point_cloud.ply')} (generate "
          f"{timings['generate_s']:.2f} s, fit {timings['fit_s']:.2f} s, "
          f"resamples {[round(s, 2) for s in timings['resample_s']]} s)")


if __name__ == "__main__":
    main()
