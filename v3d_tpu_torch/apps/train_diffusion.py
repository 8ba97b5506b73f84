"""Video-diffusion fine-tuning CLI (counterpart of
v3d_tpu/apps/train_diffusion.py): the V3D-512 VideoUNet, f32 master weights
under bf16 compute with gradient checkpointing, AdamW + LambdaLinear + EMA,
on orbits of rendered PNG frames or of pre-encoded latents, on one card or,
launched by torchrun, data-parallel over several.

    python -m v3d_tpu_torch.apps.train_diffusion --data synthetic --max-steps 10
    python -m v3d_tpu_torch.apps.train_diffusion --data /path/to/orbits --log-dir logs
    python -m torch.distributed.run --nproc-per-node 4 \
        -m v3d_tpu_torch.apps.train_diffusion --data synthetic --batch-size 4

Under torchrun every rank joins the ("data", "model") mesh of
``--model-axis`` (``parallel.mesh.make_mesh``): the parameters are
replicated, each rank reads the same seeded stream of global batches of
``--batch-size`` videos and keeps its slice along "data" before the encode,
and the gradients are averaged over "data" each step; the ranks of one
model row compute the same step (the tensor-parallel forward is not ported).
The log, the snapshot and the checkpoints are the first rank's.

``--data`` is a directory of objects (``data.objaverse.OrbitRenderDataset``):
each ``<object>/*.png`` (a rendered orbit, encoded on the way in by the VAE,
its front view embedded by CLIP) or ``<object>/latents.npy``, with an
optional ``clip_emb.npy``; or ``synthetic``: 64 seeded latent orbits with
seeded CLIP embeddings.  ``--checkpoint`` loads a V3D / SVD checkpoint (sgm
key names) into the engine; without it the weights are seeded random.  The
data's host side (decode, collate) runs in a background thread one batch
ahead.  One JSON line of stats per logged step, with ``launches``: this
process's launches of the hand-written kernels so far, by kernel; the same
rows, without the launches, in ``<log-dir>/metrics.csv``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Iterator, Optional

import torch

from v3d_tpu_torch.core.checkpoint import load_v3d_params
from v3d_tpu_torch.data.objaverse import (
    OrbitItemConfig,
    OrbitRenderDataset,
    SyntheticOrbitDataset,
)
from v3d_tpu_torch.data.prefetch import device_prefetch
from v3d_tpu_torch.engines.builder import build_v3d_engine
from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
from v3d_tpu_torch.models.clip_vit import clip_preprocess
from v3d_tpu_torch.ops import LAUNCHES
from v3d_tpu_torch.parallel.mesh import (
    data_block,
    init_distributed,
    is_first_rank,
    make_mesh,
    shard_batch,
)
from v3d_tpu_torch.utils.logging import ExperimentLogger
from v3d_tpu_torch.utils.snapshot import snapshot_run


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
    CLIP embeddings; else a directory of orbits (PNG frames or latents)."""
    if data == "synthetic":
        return SyntheticOrbitDataset(num_objects=64, num_frames=num_frames,
                                     clip_dim=clip_dim)
    return OrbitRenderDataset(data, OrbitItemConfig(num_frames=num_frames))


@torch.no_grad()
def prepare_batch(engine, batch: Dict, num_frames: int,
                  generator: Optional[torch.Generator] = None, mesh=None) -> Dict:
    """The device stage of one ``video_collate`` batch, on the engine's
    device (train_diffusion.py:75-93): pixel orbits are encoded, the frames
    to ``latents`` and the noised front views to ``cond_frames``, both by
    ``encode_first_stage`` (scaled by scale_factor, as the JAX CLI does,
    where inference's ``encode_image`` is not: ROADMAP C13), each sample's
    noise drawn from ``generator`` in that order; a front view given as
    pixels becomes its CLIP embedding.  Under ``mesh`` the batch is this
    rank's slice along "data" and each noise its block of the draw at the
    global batch's shape.  -> ``{"latents", "cond"}``."""
    dev = engine.device
    batch = dict(batch)
    block = {} if mesh is None else {"block": data_block(mesh)}
    if "latents" in batch:
        latents = torch.as_tensor(batch["latents"], device=dev)
    else:
        latents = engine.encode_first_stage(
            torch.as_tensor(batch["frames"], device=dev), generator=generator, **block)
        batch["cond_frames"] = engine.encode_first_stage(
            torch.as_tensor(batch["cond_frames"], device=dev), generator=generator,
            **block)
    front = torch.as_tensor(batch["cond_frames_without_noise"], device=dev)
    if front.dim() == 4:
        if front.shape[-1] != 3:
            raise ValueError("a latent front view has no CLIP embedding: the "
                             "item needs clip_emb.npy")
        emb = engine.clip(clip_preprocess(front.float()).permute(0, 3, 1, 2)).float()
        batch["cond_frames_without_noise"] = emb[:, None] if emb.dim() == 2 else emb
    return {"latents": latents,
            "cond": engine.training_cond(batch, num_frames=num_frames)}


def batches(engine, dataset, batch_size: int, num_frames: int,
            generator: Optional[torch.Generator] = None,
            mesh=None) -> Iterator[Dict]:
    """``{"latents": ((b t), h, w, 4), "cond": {...}}`` on the engine's
    device: the batches of ``dataset`` assembled in a background thread and
    copied to the device one ahead (``data.prefetch.device_prefetch``), then
    each through ``prepare_batch`` here, on the consumer's thread and in
    batch order, its draws from ``generator`` (by default one seeded with 1
    as the JAX CLI's key), so the draws do not depend on the prefetch.
    Under ``mesh`` each global batch of ``batch_size`` videos is cut to this
    rank's slice on the host stage (``shard_batch``), before its copy and
    its encode."""
    generator = generator or torch.Generator(device=engine.device).manual_seed(1)
    shard = {} if mesh is None else {"put_fn": lambda b: shard_batch(b, mesh)}
    src = device_prefetch(dataset.iter_batches(batch_size), device=engine.device, **shard)
    try:
        for batch in src:
            yield prepare_batch(engine, batch, num_frames, generator, mesh=mesh)
    finally:
        src.close()


def train(data: str = "synthetic", batch_size: int = 1, num_frames: int = 18,
          max_steps: int = 100_000, lr: float = 1e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 5000,
          log_every: int = TrainConfig.log_every, device="cuda", engine=None,
          log_fn: Callable[[Dict], None] = print,
          checkpoint: Optional[str] = None,
          log_dir: Optional[str] = None,
          snapshot_config: Optional[Dict] = None, mesh=None) -> DiffusionTrainer:
    """Fine-tune ``engine`` (by default the full-width V3D-512 training
    engine on ``device``, from ``checkpoint`` when given) for ``max_steps``
    steps on ``batches`` of ``data``; each logged step goes to ``log_fn``
    and, with ``log_dir``, to an ``ExperimentLogger`` there, where
    ``snapshot_config`` (the CLI's arguments) is written with the run's
    snapshot (``utils.snapshot``).  Under ``mesh`` (every rank calls it)
    data-parallel over "data"; the log and snapshot are the first rank's.
    Returns the trainer."""
    engine = engine or build_train_engine(num_frames=num_frames, device=device,
                                          checkpoint=checkpoint)
    trainer = DiffusionTrainer(
        engine, TrainConfig(base_learning_rate=lr, max_steps=max_steps,
                            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            log_every=log_every),
        num_frames=num_frames, mesh=mesh)
    if log_dir and is_first_rank(mesh):
        logger, show = ExperimentLogger(log_dir), log_fn
        if snapshot_config is not None:
            # run-reproducibility snapshot (reference utils/callbacks.py:52-95)
            snapshot_run(log_dir, config=snapshot_config)

        def log_fn(stats):
            show(stats)
            logger.log(stats, stats.get("step"))
    data_iter = batches(engine, make_dataset(data, num_frames, engine.unet.context_dim),
                        batch_size, num_frames, mesh=mesh)
    try:
        # ``batches`` has cut each batch to this rank's slice on its host stage
        trainer.fit(data_iter, log_fn=log_fn, put_fn=lambda batch: batch)
    finally:
        data_iter.close()
    return trainer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", required=True,
                   help="root of <object>/ dirs of rendered PNG frames or "
                        "latents.npy (+ clip_emb.npy), or 'synthetic'")
    p.add_argument("--checkpoint", default=None,
                   help="V3D / SVD checkpoint (.ckpt, .pt, .safetensors); "
                        "default: seeded random weights")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-frames", type=int, default=18)
    p.add_argument("--max-steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ckpt-dir", default="ckpts_out")
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--log-every", type=int, default=TrainConfig.log_every,
                   help="steps between logged lines")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model-axis", type=int, default=1,
                   help="TP axis size of the device mesh")
    args = p.parse_args(argv)
    device, mesh = args.device, None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # launched by torchrun
        device = init_distributed(args.device)
        mesh = make_mesh(model=args.model_axis, device=args.device)
    elif args.model_axis != 1:
        p.error(f"--model-axis {args.model_axis}: mesh 0x{args.model_axis} != 1 "
                "devices (launch under torch.distributed.run)")
    if not args.checkpoint and is_first_rank(mesh):
        print("WARNING: training from random init (no checkpoint)")
    try:
        train(args.data, args.batch_size, args.num_frames, args.max_steps, args.lr,
              args.ckpt_dir, args.ckpt_every, log_every=args.log_every, device=device,
              log_fn=lambda s: print(json.dumps(dict(s, launches={
                  k: v for k, v in LAUNCHES.items() if v})), flush=True),
              checkpoint=args.checkpoint, log_dir=args.log_dir,
              snapshot_config=vars(args), mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
