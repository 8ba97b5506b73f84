"""Video-diffusion fine-tuning CLI (counterpart of
v3d_tpu/apps/train_diffusion.py): the V3D-512 VideoUNet, f32 master weights
under bf16 compute with gradient checkpointing, AdamW + LambdaLinear + EMA,
on pre-encoded latent orbits, on one card.

    python -m v3d_tpu_torch.apps.train_diffusion --data synthetic --max-steps 10
    python -m v3d_tpu_torch.apps.train_diffusion --data /path/to/latent_orbits

``--data`` is a directory of ``<object>/latents.npy`` + ``clip_emb.npy``
(``data.objaverse.OrbitRenderDataset``) or ``synthetic``: 64 seeded latent
orbits with seeded CLIP embeddings.  ``--checkpoint`` loads a V3D / SVD
checkpoint (sgm key names) into the engine; without it the UNet starts from
seeded random weights.  One JSON line of stats per logged step.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from v3d_tpu_torch.core.checkpoint import load_v3d_params
from v3d_tpu_torch.data.objaverse import (
    OrbitItemConfig,
    OrbitRenderDataset,
    SyntheticOrbitDataset,
)
from v3d_tpu_torch.engines.builder import build_v3d_engine
from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig


def build_train_engine(num_frames: int = 18, device="cuda",
                       checkpoint: Optional[str] = None):
    """The V3D-512 engine for training (train_diffusion.py:47): f32
    parameters on ``device``, seeded or loaded from ``checkpoint``, the UNet
    computing in bf16 with its blocks checkpointed."""
    engine = build_v3d_engine(
        num_frames=num_frames, device=device, dtype=torch.float32, seed=0,
        unet_overrides=dict(compute_dtype=torch.bfloat16, use_checkpoint=True))
    if checkpoint:
        load_v3d_params(checkpoint, engine)
    return engine


def make_dataset(data: str, num_frames: int, clip_dim: int):
    """``synthetic``: the JAX CLI's 64 orbits of 64^2 latents, with seeded
    CLIP embeddings; else a directory of pre-encoded orbits."""
    if data == "synthetic":
        return SyntheticOrbitDataset(num_objects=64, num_frames=num_frames,
                                     clip_dim=clip_dim)
    return OrbitRenderDataset(data, OrbitItemConfig(num_frames=num_frames))


def batches(engine, dataset, batch_size: int, num_frames: int
            ) -> Iterator[Dict]:
    """``{"latents": ((b t), h, w, 4), "cond": {...}}`` on the engine's
    device, from a dataset of pre-encoded latents and CLIP embeddings."""
    for batch in dataset.iter_batches(batch_size):
        if np.ndim(batch["cond_frames_without_noise"]) not in (2, 3):
            raise ValueError("training items need a CLIP embedding (clip_emb.npy); "
                             "front views are not encoded on the way in")
        latents = torch.as_tensor(batch["latents"], device=engine.device)
        yield {"latents": latents,
               "cond": engine.training_cond(batch, num_frames=num_frames)}


def train(data: str = "synthetic", batch_size: int = 1, num_frames: int = 18,
          max_steps: int = 100_000, lr: float = 1e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 5000,
          log_every: int = TrainConfig.log_every, device="cuda", engine=None,
          log_fn: Callable[[Dict], None] = print,
          checkpoint: Optional[str] = None) -> DiffusionTrainer:
    """Fine-tune ``engine`` (by default the full-width V3D-512 training
    engine on ``device``, from ``checkpoint`` when given) for ``max_steps``
    steps; returns the trainer."""
    engine = engine or build_train_engine(num_frames=num_frames, device=device,
                                          checkpoint=checkpoint)
    trainer = DiffusionTrainer(
        engine, TrainConfig(base_learning_rate=lr, max_steps=max_steps,
                            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            log_every=log_every),
        num_frames=num_frames)
    dataset = make_dataset(data, num_frames, engine.unet.context_dim)
    trainer.fit(batches(engine, dataset, batch_size, num_frames),
                log_fn=log_fn)
    return trainer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", required=True,
                   help="root of <object>/latents.npy + clip_emb.npy dirs, "
                        "or 'synthetic'")
    p.add_argument("--checkpoint", default=None,
                   help="V3D / SVD checkpoint (.ckpt, .pt, .safetensors); "
                        "default: seeded random weights")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-frames", type=int, default=18)
    p.add_argument("--max-steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ckpt-dir", default="ckpts_out")
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.checkpoint:
        print("WARNING: training from random init (no checkpoint)")
    train(args.data, args.batch_size, args.num_frames, args.max_steps, args.lr,
          args.ckpt_dir, args.ckpt_every, device=args.device,
          log_fn=lambda s: print(json.dumps(s), flush=True),
          checkpoint=args.checkpoint)


if __name__ == "__main__":
    main()
