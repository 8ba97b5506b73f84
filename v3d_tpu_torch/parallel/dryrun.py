"""Multi-rank dry run: the stages of the JAX package's
``__graft_entry__.dryrun_multichip`` that the port runs, each held to one
process on the same inputs.

    python -m v3d_tpu_torch.parallel.dryrun --nproc 2                  # 2 cards, NCCL
    python -m v3d_tpu_torch.parallel.dryrun --nproc 2 --backend gloo   # ranks sharing a card
    python -m v3d_tpu_torch.parallel.dryrun --nproc 4 --device cpu --rung small

The launcher spawns ``--nproc`` ranks (rank r on ``cuda:r % cards``, or on
the CPU over gloo) joined on a ("data", "model") mesh at the graft's rule
(:166-169): model = 2 where nproc is even and at least 4, else 1; data =
nproc / model.  Every stage splits over "data" as the graft does:

(a) the fine-tune step at the graft's shape (:171-207).  At model = 1, one
    step of the tiny engine's ``DiffusionTrainer``: one video of t = 2 data
    frames, 2 frames a rank (the UNet forward frame-parallel,
    ``parallel/frames.py``), against one process's step on the whole
    video: the loss, and each gradient's cosine with the single process's.
    At model = 2, the tensor-parallel step (``tp_train_step``): the tiny
    engine with t = max(2 data, 2) frames over "data", its UNet cut by
    ``parallel.tensor.tp_shard_``, one ``training_loss`` and one AdamW
    step (optax.adamw's defaults at 1e-4) on the local shards, gradients
    averaged over "data" only, against one process's step: the loss, each
    gathered gradient's cosine, the gathered updated parameters;
(s) the sampling parity stage (graft :217-254): the tiny engine with t =
    max(2 data, 2) frames, 3 Euler steps at 64^2, c ones and uc zeros,
    seeded noise, sampled with the CFG-doubled 2t frames over "data"
    (``sample_latents(mesh=)``; at model = 2 the UNet tensor-parallel)
    against one process's sample: max abs <= 1e-2, the JAX dry run's bound;
(b) the data-parallel recon stage (graft :257-363): one 3DGS step with the
    cameras over "data" (each rank's mean loss, gradients averaged; the
    gaussians made anisotropic and rotated, as in (c)) and one
    NeuS step with the rays over "data" (frequency SDF, 32 samples, the
    graft's loss), each against the single-process step;
(f) the full-size stage (graft :531-587): on every rank the V3D-512 UNet
    built on the meta device and cut at its mesh coordinate, and the
    denoise step's forward on meta tensors of the graft's shapes (36 CFG
    frames at 64^2 latents, bf16, x's rows over "data"): every output
    shape, the global parameter count, each rank's local parameter bytes,
    and the collectives a forward would run, with their bytes (the JAX stage
    compiles the step; nothing here is compiled, and no value computed);
(c) the refpoint stage (graft :366-): one tile-sharded 3DGS step
    (``gs.render.rasterize_sharded``, DSSIM on the gathered image) and one
    ray-parallel NeuS step at the rung asked for ("full": 300k gaussians at
    512^2, Kc 4096, 4096 rays x 64 samples; the gaussians made anisotropic
    and rotated), against one process on rank 0 (every rank holds the
    same render and gradients): the render, the loss and every gradient;
    and each rank's K4 / K5 launches.

Each stage prints one OK line on rank 0, or fails its rank; any failed or
hung rank makes the launcher exit non-zero.  ``--out`` writes every rank's
numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

# (gaussians, resolution, max_per_tile, tile_chunk, Kc, rays, samples), the
# graft's ladder (__graft_entry__.py:395-402); a smaller rung only runs where
# the caller asks for it
RUNGS = {
    "full": (300_000, 512, 256, 32, 4096, 4096, 64),
    "reduced": (150_000, 256, 128, 16, 2048, 2048, 48),
    "small": (60_000, 256, 128, 16, 1024, 1024, 32),
}

# Bounds, each against one process on the same inputs
TRAIN_LOSS_REL = 1e-3     # (a) |loss - single| <= 1e-3 |single| (phase 8's)
TRAIN_MIN_COS = 0.999     # (a) cosine of each gradient with the single one
ZERO_GRAD_REL = 1e-6      # (a) ... whose norm is at least this of the largest
DP_LOSS_REL = 1e-5        # (b), (c) losses: the same sums in another order
GS_GRAD_REL = 1e-3        # 3DGS gradients: max abs <= 1e-3 max |single| per
#                           field (K5's float atomics; chip_smoke phase 6's)
NEUS_GRAD_REL = 1e-4      # NeuS gradients: max abs <= 1e-4 max |single| per
#                           tensor (reduction order over rays)
RENDER_MAX_ABS = 2e-5     # (c) tile-sharded image / alpha against one render

SAMPLE_MAX_ABS = 1e-2     # (s) the graft's bound (__graft_entry__.py:251)
TP_LR = 1e-4              # (a) at model 2: optax.adamw(1e-4) (graft :178)
TP_WEIGHT_DECAY = 1e-4    # ... and optax.adamw's default decay
TP_PARAM_MAX_ABS = 2 * TP_LR   # (a) gathered updated parameters against one
#                           process: Adam's first step moves an element by
#                           about lr, a misplaced shard by its weight's size
TP_SEED = 2               # (a) the draws' generator (the graft's PRNGKey(2))

TRAIN_HW = 8              # (a) the tiny engine's latents are TRAIN_HW^2
SAMPLE_RES = 64           # (s) pixels (8^2 latents)
SAMPLE_STEPS = 3


def spawn_ranks(fn: Callable, nprocs: int, args: Sequence = (),
                timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; a rank that
    raises or dies fails all of them, and ranks still running after
    ``timeout_s`` are killed and raise TimeoutError."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{nprocs} ranks did not finish in {timeout_s:.0f} s")


def _say(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(msg, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gather_counts(counts: Dict[str, int], dev) -> List[Dict[str, int]]:
    """Every rank's launch counts (one all_gather)."""
    import torch.distributed as dist

    keys = sorted(counts)
    mine = torch.tensor([counts[k] for k in keys], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [dict(zip(keys, p.tolist())) for p in parts]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b) / (na * nb)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def mesh_shape(nproc: int) -> tuple:
    """(data, model) of the graft's mesh over ``nproc`` devices (:166-169)."""
    model = 2 if nproc % 2 == 0 and nproc >= 4 else 1
    return nproc // model, model


def stage_train(mesh, dev, n: int) -> Dict:
    """(a) at model 1: the step on each rank's 2 frames of one video of 2n
    against one process's step on the whole video; both draw from step 0's
    generator at the global shape."""
    from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import shard_batch

    t = 2 * n
    engine = build_tiny_engine(num_frames=t, device=dev)
    ds = SyntheticOrbitDataset(1, t, TRAIN_HW, clip_dim=engine.unet.context_dim)
    host = next(ds.iter_batches(1))
    batch = {"latents": torch.as_tensor(host["latents"], device=dev),
             "cond": engine.training_cond(host, num_frames=t)}
    local = shard_batch(batch, mesh)
    trainer = DiffusionTrainer(engine, TrainConfig(), num_frames=t, mesh=mesh)
    reset_launch_counts()
    stats = trainer.train_step(local["latents"], local["cond"])
    _sync(dev)
    counts = dict(LAUNCHES)
    single = DiffusionTrainer(build_tiny_engine(num_frames=t, device=dev),
                              TrainConfig(), num_frames=t)
    ref = single.train_step(batch["latents"], batch["cond"])
    # a tensor whose gradient is rounding noise (< 1e-6 of the largest norm:
    # the true gradient is 0, e.g. a conv bias right before a GroupNorm) has
    # no direction to hold
    pairs = [(p.grad, q.grad) for p, q in zip(trainer.params, single.params)
             if q.grad is not None]
    top = max(float(q.norm()) for _, q in pairs)
    held = [(a, b) for a, b in pairs if float(b.norm()) >= ZERO_GRAD_REL * top]
    cos = min(_cosine(a, b) for a, b in held)
    loss_rel = abs(stats["loss"] - ref["loss"]) / abs(ref["loss"])
    _check(math.isfinite(stats["loss"]) and loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_MIN_COS,
           f"DP fine-tune step: loss {stats['loss']} vs single {ref['loss']} "
           f"(rel {loss_rel:.2e}), least gradient cosine {cos:.6f}")
    launches = _gather_counts(counts, dev)
    _say(f"dryrun DP fine-tune: mesh {n}x1, 1 video x t={t} at {TRAIN_HW}^2 latents, "
         f"2 frames a rank, loss {stats['loss']:.6f} vs single {ref['loss']:.6f} (rel "
         f"{loss_rel:.2e} <= {TRAIN_LOSS_REL}), grad norm {stats['grad_norm']:.6f} vs "
         f"{ref['grad_norm']:.6f}, least gradient cosine {cos:.6f} (>= {TRAIN_MIN_COS}; "
         f"{len(pairs) - len(held)} of {len(pairs)} tensors with no gradient), "
         f"launches per rank {[{k: v for k, v in c.items() if v} for c in launches]} OK")
    return {"loss": stats["loss"], "loss_single": ref["loss"], "loss_rel": loss_rel,
            "grad_norm": stats["grad_norm"], "grad_norm_single": ref["grad_norm"],
            "min_cos": cos, "no_grad_tensors": len(pairs) - len(held),
            "launches": counts}


def tp_train_step(engine, latents: torch.Tensor, cond: Dict, num_frames: int,
                  mesh=None, sigmas=None, noise=None, generator=None) -> Dict:
    """One ``training_loss`` and one AdamW step (lr TP_LR, optax.adamw's
    betas, eps and decay) of ``engine``'s UNet on the whole batch
    ``latents`` / ``cond`` ((b t) rows).  With ``mesh``: the UNet cut over
    "model" (``tp_shard_``), this rank's rows of the batch over "data", the
    loss and the local gradients averaged over "data" only; the gradients
    and updated parameters returned are gathered whole.  The draws are
    ``sigmas`` / ``noise`` (the whole batch's) or ``generator``'s at the
    whole batch's shape."""
    from v3d_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_mean_, data_block, shard_batch
    from v3d_tpu_torch.parallel.tensor import tp_gather, tp_shard_

    unet = engine.unet.train().requires_grad_(True)
    batch = {"latents": latents, "cond": cond}
    if mesh is not None:
        tp_shard_(unet, mesh)
        batch = shard_batch(batch, mesh)
    names, params = zip(*unet.named_parameters())
    opt = torch.optim.AdamW(params, lr=TP_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=TP_WEIGHT_DECAY)
    loss = engine.training_loss(batch["latents"], batch["cond"], num_frames=num_frames,
                                sigmas=sigmas, noise=noise, generator=generator,
                                block=data_block(mesh), mesh=mesh)
    loss.backward()
    grads = [p.grad for p in params]
    loss = loss.detach().reshape(1).clone()
    if mesh is not None:
        all_reduce_mean_(grads + [loss], mesh, DATA_AXIS)
    grads = dict(zip(names, (g.clone() for g in grads)))
    opt.step()
    whole = lambda named: named if mesh is None else tp_gather(unet, named)  # noqa: E731
    return {"loss": float(loss), "grads": whole(grads),
            "params": whole({k: v.detach().clone() for k, v in unet.state_dict().items()})}


def stage_tp_train(mesh, dev, n: int) -> Dict:
    """(a) at model 2: the tensor-parallel step of the tiny engine on t =
    max(2n, 2) frames over the n ranks of "data" against one process's step
    on the whole batch, both drawing from one generator at the batch's
    shape: the loss, each gathered gradient's cosine, the gathered updated
    parameters."""
    from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size

    t = max(2 * n, 2)
    model = axis_size(mesh, MODEL_AXIS)
    engine = build_tiny_engine(num_frames=t, device=dev)
    ds = SyntheticOrbitDataset(1, t, TRAIN_HW, clip_dim=engine.unet.context_dim)
    host = next(ds.iter_batches(1))
    latents = torch.as_tensor(host["latents"], device=dev)
    cond = engine.training_cond(host, num_frames=t)

    def gen():
        return torch.Generator(device=dev).manual_seed(TP_SEED)

    reset_launch_counts()
    got = tp_train_step(engine, latents, cond, t, mesh=mesh, generator=gen())
    _sync(dev)
    counts = dict(LAUNCHES)
    ref = tp_train_step(build_tiny_engine(num_frames=t, device=dev), latents, cond, t,
                        generator=gen())
    grads = ref["grads"]
    top = max(float(g.norm()) for g in grads.values())
    held = [k for k, g in grads.items() if float(g.norm()) >= ZERO_GRAD_REL * top]
    cos = min(_cosine(got["grads"][k], grads[k]) for k in held)
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    param_diff = max(float((got["params"][k] - v).abs().max()) for k, v in ref["params"].items())
    _check(math.isfinite(got["loss"]) and loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_MIN_COS
           and param_diff <= TP_PARAM_MAX_ABS,
           f"TP fine-tune step: loss {got['loss']} vs single {ref['loss']} (rel "
           f"{loss_rel:.2e}), least gradient cosine {cos:.6f}, updated parameters max abs "
           f"{param_diff:.2e}")
    launches = _gather_counts(counts, dev)
    _say(f"dryrun TP fine-tune: mesh {n}x{model}, t={t} at {TRAIN_HW}^2 latents over "
         f"data={n}, UNet tensor-parallel over model={model}, AdamW {TP_LR:g}: loss "
         f"{got['loss']:.6f} vs single {ref['loss']:.6f} (rel {loss_rel:.2e} <= "
         f"{TRAIN_LOSS_REL}), least gathered gradient cosine {cos:.6f} (>= {TRAIN_MIN_COS}; "
         f"{len(grads) - len(held)} of {len(grads)} tensors with no gradient), updated "
         f"parameters max abs {param_diff:.2e} (<= {TP_PARAM_MAX_ABS:g}), launches per rank "
         f"{[{k: v for k, v in c.items() if v} for c in launches]} OK")
    return {"loss": got["loss"], "loss_single": ref["loss"], "loss_rel": loss_rel,
            "min_cos": cos, "no_grad_tensors": len(grads) - len(held),
            "param_max_abs": param_diff, "launches": counts}


def fullsize_forward(mesh, frames: int = 18, hw: int = 64) -> Dict:
    """The full-size V3D-512 denoise step on meta tensors (bf16 UNet, x's
    2 ``frames`` CFG rows at hw^2 latents over "data", the UNet cut over
    "model" at this rank's coordinate): the output's shape, the global
    parameter count (before the cut, and of the gathered state), this
    rank's parameter bytes, and the collectives of one forward."""
    from v3d_tpu_torch.engines.builder import build_v3d_engine
    from v3d_tpu_torch.engines.wrappers import make_unet_network_fn
    from v3d_tpu_torch.ops._dispatch import meta_shapes
    from v3d_tpu_torch.parallel import frames as fr
    from v3d_tpu_torch.parallel import tensor as tp
    from v3d_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

    engine = build_v3d_engine(num_frames=frames, device="meta", dtype=torch.bfloat16)
    unet = engine.unet
    n_params = sum(p.numel() for p in unet.parameters())
    full_bytes = tp.local_param_bytes(unet)
    tp.tp_shard_(unet, mesh)
    rows = 2 * frames // axis_size(mesh, DATA_AXIS)

    def meta(*shape):
        return torch.zeros(shape, device="meta")

    x = meta(rows, hw, hw, 4)
    cond = {"crossattn": meta(rows, 1, unet.context_dim), "concat": meta(rows, hw, hw, 4),
            "vector": meta(rows, 768)}
    network = make_unet_network_fn(unet, frames, mesh=mesh, rows_local=True)
    tp.reset_traffic()
    fr.reset_traffic()
    with torch.no_grad(), meta_shapes():
        out = engine.denoiser(network, x, meta(rows), cond,
                              image_only_indicator=meta(2, frames))
    traffic = {"model": dict(tp.TRAFFIC), "frames": dict(fr.TRAFFIC)}
    names = dict(unet.named_parameters())
    gathered = sum(v.numel() for k, v in tp.tp_gather(unet).items() if k in names)
    return {"out_shape": list(out.shape), "want_shape": [rows, hw, hw, 4],
            "out_device": out.device.type, "params": n_params, "params_gathered": gathered,
            "full_bytes": full_bytes, "local_bytes": tp.local_param_bytes(unet),
            "traffic": traffic}


def stage_fullsize(mesh, dev, data: int, model: int) -> Dict:
    """(f): ``fullsize_forward`` on every rank; the graft's skip where the
    ranks of "data" do not divide the 36 CFG frames."""
    import torch.distributed as dist

    frames = 18
    if (2 * frames) % data:
        _say(f"dryrun AOT full-size: skipped (36 frames % data={data} != 0)")
        return {"skipped": True}
    t0 = time.perf_counter()
    r = fullsize_forward(mesh, frames)
    seconds = time.perf_counter() - t0
    _check(r["out_shape"] == r["want_shape"] and r["out_device"] == "meta"
           and r["params_gathered"] == r["params"],
           f"full-size stage: output {r['out_shape']} (want {r['want_shape']}), "
           f"{r['params_gathered']} gathered parameters of {r['params']}")
    mine = torch.tensor([r["local_bytes"], r["traffic"]["model"]["all_reduce"],
                         r["traffic"]["model"]["all_gather"], r["traffic"]["model"]["bytes"],
                         r["traffic"]["frames"]["exchanges"],
                         r["traffic"]["frames"]["bytes"]], dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    every = [e.tolist() for e in every]
    _say(f"dryrun AOT full-size: V3D-512 UNet ({r['params'] / 1e9:.2f}B params, "
         f"{r['params']:,}; the gathered state {r['params_gathered']:,}) on the meta device "
         f"on a {data}x{model} mesh, bf16, x {r['want_shape']} a rank of the 36 CFG frames: "
         f"denoised {r['out_shape']}; parameter bytes per rank {[e[0] for e in every]} of "
         f"{r['full_bytes']} whole; a forward's collectives per rank over model "
         f"{[(e[1], e[2]) for e in every]} (all_reduce, all_gather) of "
         f"{[e[3] for e in every]} bytes, frame exchanges over data "
         f"{[e[4] for e in every]} of {[e[5] for e in every]} bytes; {seconds:.1f} s OK")
    r["seconds"] = seconds
    return r


def stage_sampling(mesh, dev, n: int) -> Dict:
    """(s): the tiny engine's sample with the CFG-doubled 2t frames over the
    n ranks of "data" (the UNet cut over "model" where it has 2 ranks)
    against one process's sample on the same noise (every rank makes both:
    the one-process sample is tiny)."""
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size
    from v3d_tpu_torch.parallel.tensor import tp_shard_

    t = max(2 * n, 2)
    model = axis_size(mesh, MODEL_AXIS)
    engine = build_tiny_engine(num_frames=t, num_steps=SAMPLE_STEPS, device=dev)
    hw = SAMPLE_RES // engine.downscale
    ctx = engine.unet.context_dim
    c = {"crossattn": torch.ones((t, 1, ctx), device=dev),
         "concat": torch.ones((t, hw, hw, 4), device=dev),
         "vector": torch.ones((t, 768), device=dev)}
    uc = {k: torch.zeros_like(v) for k, v in c.items()}
    noise = torch.from_numpy(np.random.RandomState(3).randn(t, hw, hw, 4)
                             .astype(np.float32)).to(dev)
    ref = engine.sample_latents(c, uc, SAMPLE_RES, SAMPLE_RES, noise=noise)
    tp_shard_(engine.unet, mesh)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.sample_latents(c, uc, SAMPLE_RES, SAMPLE_RES, noise=noise, mesh=mesh)
    _sync(dev)
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    diff = float((out - ref).abs().max())
    _check(bool(torch.isfinite(out).all()) and diff <= SAMPLE_MAX_ABS,
           f"sharded sampling: max|diff| {diff:.2e} from one process")
    launches = _gather_counts(counts, dev)
    how = "frame-sharded" if model == 1 else f"frame-sharded and tensor-parallel over model={model}"
    _say(f"dryrun sampling parity: t={t}, {2 * t} CFG frames over data={n} "
         f"({2 * t // n} a rank), {SAMPLE_STEPS} steps at {SAMPLE_RES}^2, {how} vs "
         f"one process max|diff|={diff:.2e} (<= {SAMPLE_MAX_ABS}), {seconds:.2f} s, launches "
         f"per rank {[{k: v for k, v in c_.items() if v} for c_ in launches]} OK")
    return {"t": t, "max_abs": diff, "seconds": seconds, "launches": counts}


def _gs_scene(n_points: int, radius: float, dev, anisotropic: bool = False):
    """The graft's random init (``random_init_pcd`` in a ball of ``radius``);
    ``anisotropic``: scales and rotations perturbed from a seeded numpy
    draw, as chip_smoke's phase 6 does: at the isotropic init the rotation
    gradient is 0 up to rounding, and rounding is not what is compared."""
    from v3d_tpu_torch.gs.gaussians import FLOAT_FIELDS, from_pcd, random_init_pcd

    rng = np.random.RandomState(0)
    xyz, colors = random_init_pcd(rng, n_points, radius=radius)
    g = from_pcd(xyz, colors, capacity=n_points, device=dev)
    if anisotropic:
        rs = np.random.RandomState(3)
        for k, scale in (("scaling", 0.3), ("rotation", 1.0)):
            p = getattr(g, k)
            p += torch.from_numpy(scale * rs.randn(*p.shape).astype(np.float32)).to(dev)
    return rng, g, FLOAT_FIELDS


def _leaf_fields(g, fields):
    return {k: getattr(g, k).detach().clone().requires_grad_(True) for k in fields}


def _neus(dev, n_frequencies: int, n_neurons: int, n_hidden_layers: int,
          seed: int):
    from v3d_tpu_torch.nerf.fields import VarianceNetwork, VolumeRadiance, VolumeSDF

    gen = torch.Generator().manual_seed(seed)
    geo = VolumeSDF(radius=1.0, encoding_type="frequency", n_frequencies=n_frequencies,
                    grad_type="analytic", n_neurons=n_neurons,
                    n_hidden_layers=n_hidden_layers)
    tex, var = VolumeRadiance(), VarianceNetwork()
    for m in (geo, tex, var):
        m.init_(gen)
    return geo.to(dev), tex.to(dev), var.to(dev), gen


def _rays(n_rays: int, gen, dev):
    d = torch.randn((n_rays, 3), generator=gen) * 0.2 + torch.tensor([0.0, 0.0, 1.0])
    rays_d = d / d.norm(dim=-1, keepdim=True)
    rays_o = torch.tensor([[0.0, 0.0, -2.0]]).expand(n_rays, 3).contiguous()
    return rays_o.to(dev), rays_d.to(dev)


def _neus_loss(renderer, geo, tex, var, rays_o, rays_d):
    """The graft's NeuS loss (:325-336): colour MSE against 0.5 grey,
    0.1 x eikonal, binary cross-entropy of the opacity against all-ones
    foreground."""
    inv_s = var().clamp(1e-6, 1e6)
    out = renderer(rays_o, rays_d, lambda p: geo(p), lambda f, nrm: tex(f, nrm), inv_s,
                   background_color=torch.ones(3, device=rays_o.device))
    rgb = ((out.comp_rgb - 0.5) ** 2).sum(-1).mean()
    gn = torch.sqrt((out.sdf_grad ** 2).sum(-1) + 1e-12)
    eik = ((gn - 1.0) ** 2).mean()
    opac = out.opacity.clamp(1e-3, 1 - 1e-3)
    mask = (-torch.log(opac)).mean()
    return rgb + 0.1 * eik + mask


def _neus_step(mesh, dev, geo, tex, var, renderer, rays_o, rays_d, dp: bool):
    """Loss and gradients of one NeuS step, on this rank's block of the rays
    (gradients and loss averaged over "data") or on all of them."""
    from v3d_tpu_torch.parallel.mesh import all_reduce_mean_, shard_block

    params = [p for m in (geo, tex, var) for p in m.parameters()]
    for p in params:
        p.grad = None
    if dp:
        block = shard_block(rays_o.shape[0], mesh)
        rays_o, rays_d = rays_o[block], rays_d[block]
    loss = _neus_loss(renderer, geo, tex, var, rays_o, rays_d)
    loss.backward()
    grads = [p.grad for p in params]
    loss = loss.detach().reshape(1).clone()
    if dp:
        all_reduce_mean_(grads + [loss], mesh)
    return float(loss), [g.clone() for g in grads]


def _held(what: str, loss, grads, loss_ref, grads_ref, grad_rel) -> Dict:
    loss_rel = abs(loss - loss_ref) / max(abs(loss_ref), 1e-12)
    worst = max(_rel(a, b) for a, b in zip(grads, grads_ref)
                if b is not None and b.numel())
    _check(math.isfinite(loss) and loss_rel <= DP_LOSS_REL and worst <= grad_rel,
           f"{what}: loss {loss} vs single {loss_ref} (rel {loss_rel:.2e}), gradients "
           f"max abs / max |single| {worst:.2e} (bound {grad_rel})")
    return {"loss": loss, "loss_single": loss_ref, "loss_rel": loss_rel, "grad_rel": worst}


def stage_recon_dp(mesh, dev, n: int) -> Dict:
    """(b): a 3DGS step with the cameras over "data" and a NeuS step with the
    rays over "data", each against the single-process step."""
    from v3d_tpu_torch.data.cameras import Camera, get_uniform_poses
    from v3d_tpu_torch.gs.gaussians import Gaussians
    from v3d_tpu_torch.gs.render import RasterizeConfig, render
    from v3d_tpu_torch.nerf.renderer import NeusRenderer
    from v3d_tpu_torch.parallel.mesh import all_reduce_mean_, shard_block

    res, n_cams = 32, 2 * n
    rng, g, fields = _gs_scene(256, 0.6, dev, anisotropic=True)
    cams = [Camera.from_c2w(p, 60.0, res, res)
            for p in get_uniform_poses(n_cams, 2.0, 10.0, opengl=False)]
    targets = torch.tensor(rng.rand(n_cams, res, res, 3).astype(np.float32), device=dev)
    rcfg = RasterizeConfig(max_per_tile=64, tile_chunk=4)
    bg = torch.ones(3, device=dev)

    def gs_step(cam_ids, dp: bool):
        leaves = _leaf_fields(g, fields)
        gg = Gaussians(alive=g.alive, **leaves)
        loss = torch.stack([(render(gg, cams[i], bg, config=rcfg).image - targets[i])
                            .abs().mean() for i in cam_ids]).mean()
        loss.backward()
        grads = [leaves[k].grad for k in fields]
        loss = loss.detach().reshape(1).clone()
        if dp:
            all_reduce_mean_(grads + [loss], mesh)
        return float(loss), grads

    mine = range(n_cams)[shard_block(n_cams, mesh)]
    gs = _held("DP 3DGS step", *gs_step(mine, True), *gs_step(range(n_cams), False),
               GS_GRAD_REL)

    geo, tex, var, gen = _neus(dev, 4, 32, 2, seed=5)
    rays_o, rays_d = _rays(32 * n, gen, dev)
    renderer = NeusRenderer(radius=1.0, num_samples=32)
    ne = _held("DP NeuS step",
               *_neus_step(mesh, dev, geo, tex, var, renderer, rays_o, rays_d, True),
               *_neus_step(mesh, dev, geo, tex, var, renderer, rays_o, rays_d, False),
               NEUS_GRAD_REL)
    _say(f"dryrun recon DP: GS loss {gs['loss']:.6f} vs single {gs['loss_single']:.6f} "
         f"({n_cams} cams, {len(mine)} a rank; gradients {gs['grad_rel']:.2e} of the "
         f"largest), NeuS loss {ne['loss']:.6f} vs single {ne['loss_single']:.6f} "
         f"({32 * n} rays; gradients {ne['grad_rel']:.2e}) OK")
    return {"gs": gs, "neus": ne}


def stage_refpoint(mesh, dev, n: int, rung: str) -> Dict:
    """(c): the tile-sharded 3DGS step and the ray-parallel NeuS step at
    ``rung`` on every rank, then, on rank 0, the same steps in one process
    and the comparison."""
    import torch.distributed as dist

    from v3d_tpu_torch.data.cameras import Camera, get_uniform_poses
    from v3d_tpu_torch.gs.gaussians import Gaussians
    from v3d_tpu_torch.gs.losses import ssim
    from v3d_tpu_torch.gs.render import (RasterizeConfig, project_gaussians, rasterize,
                                         rasterize_sharded)
    from v3d_tpu_torch.nerf.renderer import NeusRenderer
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import DATA_AXIS

    N, res, max_per_tile, tile_chunk, kc, n_rays, n_samples = RUNGS[rung]
    _say(f"dryrun refpoint: rung '{rung}': GS {N} gaussians @{res}^2 Kc={kc}, NeuS "
         f"{n_rays} rays x {n_samples} samples")
    rng, g, fields = _gs_scene(N, 2.0, dev, anisotropic=True)
    cam = Camera.from_c2w(get_uniform_poses(18, 2.0, 0.0, opengl=False)[0], 60.0, res, res)
    cfg = RasterizeConfig(max_per_tile=max_per_tile, tile_chunk=tile_chunk,
                          coarse_factor=8, max_per_coarse=kc)
    bg = torch.ones(3, device=dev)
    target = torch.tensor(rng.rand(res, res, 3).astype(np.float32), device=dev)

    def gs_step(sharded: bool):
        leaves = _leaf_fields(g, fields)
        proj = project_gaussians(Gaussians(alive=g.alive, **leaves), cam)
        out = (rasterize_sharded(proj, res, res, bg, mesh, DATA_AXIS, cfg) if sharded
               else rasterize(proj, res, res, bg, cfg))
        loss = 1.0 - ssim(out.image, target)    # lambda_dssim 1 (readme step 4)
        loss.backward()
        _sync(dev)
        return float(loss.detach()), [leaves[k].grad for k in fields], out

    geo, tex, var, gen = _neus(dev, 8, 64, 1, seed=7)
    rays_o, rays_d = _rays(n_rays, gen, dev)
    renderer = NeusRenderer(radius=1.0, num_samples=n_samples, ray_chunk=512)

    def neus_step(dp: bool):
        return _neus_step(mesh, dev, geo, tex, var, renderer, rays_o, rays_d, dp)

    def timed(fn, *args):
        """fn's result and ms; on the card after a warm-up call (the
        process's first at these shapes).  On the CPU the work is the
        point, and it is not repeated."""
        if dev.type == "cuda":
            fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        return out, 1e3 * (time.perf_counter() - t0)

    if dev.type == "cuda":
        gs_step(True)
    reset_launch_counts()
    t0 = time.perf_counter()
    l_sh, g_sh, o_sh = gs_step(True)
    gs = {"ms_sharded": 1e3 * (time.perf_counter() - t0), "launches": dict(LAUNCHES)}
    launches = _gather_counts(gs["launches"], dev)
    sh, ms_sh = timed(neus_step, True)
    ne = {"ms_sharded": ms_sh}
    if dist.get_rank() != 0:
        # every rank holds the same render and gradients (gathered, summed):
        # rank 0 holds them to one process, with no collective left to wait on
        return {"rung": rung, "gs": gs, "neus": ne}

    (l_ref, g_ref, o_ref), gs["ms_single"] = timed(gs_step, False)
    render_err = max(float((o_sh.image - o_ref.image).detach().abs().max()),
                     float((o_sh.alpha - o_ref.alpha).detach().abs().max()))
    _check(render_err <= RENDER_MAX_ABS,
           f"tile-sharded render: max abs {render_err:.2e} from one render")
    gs.update(_held("tile-sharded 3DGS step", l_sh, g_sh, l_ref, g_ref, GS_GRAD_REL),
              render_max_abs=render_err)
    _say(f"dryrun GS refpoint [{rung}]: {N} gaussians @{res}^2, {(-(-res // 16)) ** 2} tiles "
         f"sharded over data={n}, render max abs {render_err:.2e} (<= {RENDER_MAX_ABS}), "
         f"loss {l_sh:.6f} vs single {l_ref:.6f}, gradients {gs['grad_rel']:.2e} of the "
         f"largest (<= {GS_GRAD_REL}), launches per rank "
         f"{[{k: v for k, v in c.items() if v} for c in launches]} (single "
         f"{gs['ms_single']:.0f} ms, sharded {gs['ms_sharded']:.0f} ms) OK")
    ref, ne["ms_single"] = timed(neus_step, False)
    ne.update(_held("ray-parallel NeuS step", *sh, *ref, NEUS_GRAD_REL))
    _say(f"dryrun NeuS refpoint [{rung}]: {n_rays} rays x {n_samples} samples DP over "
         f"data={n}, loss {sh[0]:.6f} vs single {ref[0]:.6f}, gradients "
         f"{ne['grad_rel']:.2e} of the largest (single {ne['ms_single']:.0f} ms, "
         f"sharded {ne['ms_sharded']:.0f} ms) OK")
    return {"rung": rung, "gs": gs, "neus": ne}


def _rank(index: int, nproc: int, store: str, opts: Dict, out_dir: str) -> None:
    import torch.distributed as dist

    from v3d_tpu_torch.parallel.mesh import init_distributed, make_mesh

    device = opts["device"]
    if device == "cpu":      # the ranks share the host's cores ($OMP_NUM_THREADS)
        torch.set_num_threads(max(1, torch.get_num_threads() // nproc))
    if device == "cuda":
        device = f"cuda:{index % torch.cuda.device_count()}" if torch.cuda.is_available() \
            else "cuda"
    dev = init_distributed(device, timeout_s=opts["timeout"], backend=opts["backend"],
                           init_method=f"file://{store}", rank=index, world_size=nproc)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        data, model = mesh_shape(nproc)
        mesh = make_mesh(data=data, model=model, device=dev.type)
        t0 = time.perf_counter()
        result = {"rank": index, "device": str(dev), "mesh": [data, model],
                  "backend": dist.get_backend()}
        result["train"] = (stage_train(mesh, dev, data) if model == 1
                           else stage_tp_train(mesh, dev, data))
        result["sampling"] = stage_sampling(mesh, dev, data)
        result["recon_dp"] = stage_recon_dp(mesh, dev, data)
        result["fullsize"] = stage_fullsize(mesh, dev, data, model)
        result["refpoint"] = stage_refpoint(mesh, dev, data, opts["rung"])
        result["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{index}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def run(nproc: int, device: str = "cuda", backend=None, rung: str = "full",
        timeout_s: float = 300.0, join_timeout_s: float = 1200.0) -> Dict:
    """Spawn the ranks and return every rank's numbers; raises where a
    stage fails or a rank hangs."""
    if rung not in RUNGS:
        raise ValueError(f"rung {rung!r}: one of {sorted(RUNGS)}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device; pass --device cpu")
    t0 = time.perf_counter()
    opts = dict(device=device, backend=backend, rung=rung, timeout=timeout_s)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank, nproc, (nproc, os.path.join(tmp, "store"), opts, tmp),
                    timeout_s=join_timeout_s)
        ranks = []
        for r in range(nproc):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    print(f"dryrun({nproc}): ALL STAGES DONE in {seconds:.0f} s", flush=True)
    return {"nproc": nproc, "device": device, "backend": ranks[0]["backend"],
            "rung": rung, "seconds": seconds, "ranks": ranks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--rung", default="full", choices=sorted(RUNGS))
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a collective may take before its rank fails")
    p.add_argument("--join-timeout", type=float, default=1200.0,
                   help="seconds before the launcher kills the ranks")
    p.add_argument("--out", default=None, help="write every rank's numbers here (JSON)")
    args = p.parse_args(argv)
    report = run(args.nproc, args.device, args.backend, args.rung, args.timeout,
                 args.join_timeout)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
