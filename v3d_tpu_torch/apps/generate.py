"""Generation CLI (counterpart of v3d_tpu/apps/generate.py; scripts/pub/
V3D_512.py sample_one): image -> preprocess -> CLIP / VAE conditioning ->
25 EDM Euler steps of the VideoUNet under per-frame linear CFG -> temporal
VAE decode -> 18 orbit frames.

    python -m v3d_tpu_torch.apps.generate --input image.png

``--checkpoint`` loads a V3D / SVD checkpoint (.ckpt, .pt or .safetensors,
sgm key names) into the engine.  Without it the engine runs on seeded random
weights (the output is noise; the path is real).  Each run writes its
frames to ``<output-folder>/<n:06d>.mp4`` (mp4v, 3 fps, as the JAX CLI
does; cv2 needed) and as PNG files under ``<output-folder>/<n:06d>/``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from v3d_tpu_torch.core.checkpoint import load_v3d_params
from v3d_tpu_torch.data.preprocess import preprocess_image
from v3d_tpu_torch.data.video_io import write_video
from v3d_tpu_torch.engines.builder import build_tiny_engine, build_v3d_engine
from v3d_tpu_torch.utils.trace import UNET_FORWARD, span, stage


def sample_one(image: np.ndarray, engine=None, num_frames: int = 18,
               num_steps: int = 25, fps_id: int = 1,
               motion_bucket_id: int = 300, cond_aug: float = 0.02,
               seed: int = 23, decoding_t: int = 18,
               border_ratio: float = 0.3, min_guidance_scale: float = 3.5,
               max_guidance_scale: float = 3.5, sigma_max: float = 700.0,
               ignore_alpha: bool = False, bf16: bool = True,
               device="cuda", resolution: int = 512,
               weights_seed: int = 0, enc_noise=None, aug_noise=None,
               noise=None, checkpoint: str = None):
    """(H, W, 3|4) uint8 image -> (frames uint8 (T, res, res, 3), engine,
    timings in seconds).

    Without ``engine``, builds the V3D-512 engine on ``device`` (the card
    unless the caller passes ``device="cpu"``) with seeded random weights,
    bf16-resident when ``bf16``, and loads ``checkpoint`` into it when one
    is given.  The noise comes from a generator seeded
    with ``seed`` (latent sample, cond aug, initial latent, in that order)
    unless given explicitly.  The timings are the durations of the
    request's stage spans (``generate.cond``, ``generate.sample``,
    ``generate.decode``, inside ``generate.request``; ``utils/trace.py``),
    each ending on the device: the first two synchronise, the decode's
    frames come to the host."""
    if engine is None:
        engine = build_v3d_engine(
            num_frames=num_frames, num_steps=num_steps,
            min_scale=min_guidance_scale, max_scale=max_guidance_scale,
            sigma_max=sigma_max, device=device,
            dtype=torch.bfloat16 if bf16 else torch.float32, seed=weights_seed)
        if checkpoint:
            load_v3d_params(checkpoint, engine)
    dev = engine.device
    timings = {}
    with span("generate.request"):
        img = preprocess_image(image, border_ratio=border_ratio,
                               resolution=resolution, ignore_alpha=ignore_alpha,
                               device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with stage("generate.cond", timings, "cond_s", dev):
            clip_emb, cond_frames = engine.encode_image(
                torch.from_numpy(img)[None], cond_aug, enc_noise, aug_noise, gen)
            c, uc = engine.build_cond(clip_emb, cond_frames, fps_id,
                                      motion_bucket_id, cond_aug)
        with stage("generate.sample", timings, "sample_s", dev):
            z = engine.sample_latents(c, uc, resolution, resolution, noise, gen)
        with stage("generate.decode", timings, "decode_s"):
            frames = engine.decode_latents(z, decoding_t=decoding_t)
            if not torch.isfinite(frames).all():
                raise FloatingPointError("generation produced non-finite frames")
            frames_u8 = torch.round(frames * 255.0).to(torch.uint8).cpu().numpy()
    return frames_u8, engine, timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="V3D / SVD checkpoint (.ckpt, .pt, .safetensors); "
                        "default: seeded random weights")
    p.add_argument("--num-steps", type=int, default=25)
    p.add_argument("--num-frames", type=int, default=18)
    p.add_argument("--fps-id", type=int, default=1)
    p.add_argument("--motion-bucket-id", type=int, default=300)
    p.add_argument("--cond-aug", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--decoding-t", type=int, default=6)
    p.add_argument("--border-ratio", type=float, default=0.3)
    p.add_argument("--min-cfg", type=float, default=3.5)
    p.add_argument("--max-cfg", type=float, default=3.5)
    p.add_argument("--sigma-max", type=float, default=700.0)
    p.add_argument("--output-folder", default="outputs/v3d_512")
    p.add_argument("--ignore-alpha", action="store_true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--tiny", action="store_true",
                   help="the scaled-down engine of the same topology (tests, "
                        "dry runs; its checkpoints have the same key names)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    from PIL import Image

    if not args.checkpoint:
        print("WARNING: seeded random weights (output is noise; pipeline test)")
    engine = None
    if args.tiny:
        engine = build_tiny_engine(num_frames=args.num_frames,
                                   num_steps=args.num_steps, device=args.device)
        if args.checkpoint:
            load_v3d_params(args.checkpoint, engine)
    frames, _, timings = sample_one(
        np.asarray(Image.open(args.input)), engine=engine,
        num_frames=args.num_frames,
        num_steps=args.num_steps, fps_id=args.fps_id,
        motion_bucket_id=args.motion_bucket_id, cond_aug=args.cond_aug,
        seed=args.seed, decoding_t=args.decoding_t,
        border_ratio=args.border_ratio, min_guidance_scale=args.min_cfg,
        max_guidance_scale=args.max_cfg, sigma_max=args.sigma_max,
        ignore_alpha=args.ignore_alpha, device=args.device,
        resolution=args.resolution, checkpoint=args.checkpoint)
    os.makedirs(args.output_folder, exist_ok=True)
    base = sum(os.path.isdir(os.path.join(args.output_folder, n))
               for n in os.listdir(args.output_folder))
    out_dir = os.path.join(args.output_folder, f"{base:06d}")
    os.makedirs(out_dir)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(out_dir, f"{i:02d}.png"))
    write_video(out_dir + ".mp4", frames, fps=3)
    print(f"generated {len(frames)} frames (cond {timings['cond_s']:.2f} s, "
          f"sample {timings['sample_s']:.2f} s, decode {timings['decode_s']:.2f}"
          f" s; {UNET_FORWARD['forwards']} UNet forwards of {UNET_FORWARD['rows']}"
          f" rows) -> {out_dir}.mp4 and {out_dir}/")


if __name__ == "__main__":
    main()
