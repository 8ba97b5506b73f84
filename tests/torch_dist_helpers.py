"""Rank functions of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_dp_train.py, test_torch_gs_sharded.py, test_torch_imports.py).

A spawned rank re-imports the module that holds its function, so this one
imports torch, numpy and the port only, never jax or v3d_tpu (the parent
test process has them; a rank must not load them).  ``run_ranks`` starts
``world`` ranks on the CPU joined over gloo on a FileStore under the test's
directory, each collective limited to COLLECTIVE_TIMEOUT_S, and kills ranks
still running after its join limit: a hung collective fails its test, not
the suite.  Each rank function returns a dict, saved by the rank and
returned by ``run_ranks`` in rank order, with ``foreign``: the jax / flax /
v3d_tpu modules the rank had loaded.
"""

from __future__ import annotations

import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from v3d_tpu_torch.parallel.dryrun import spawn_ranks

COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 150.0
T = 4              # frames a video of the tiny engine's tests
FOREIGN = ("jax", "jaxlib", "flax", "v3d_tpu")


def run_ranks(fn, world: int, tmp_path, *args, timeout_s: float = JOIN_TIMEOUT_S) -> list:
    out = tmp_path / f"ranks_{fn.__name__}_{world}"
    out.mkdir()
    spawn_ranks(_entry, world, (fn, world, str(out), args), timeout_s=timeout_s)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, fn, world: int, out: str, args) -> None:
    from v3d_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=COLLECTIVE_TIMEOUT_S,
                     init_method=f"file://{out}/store", rank=rank, world_size=world)
    try:
        result = fn(rank, world, out, *args)
        result["foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tiny_engine(unet_state=None):
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    engine = build_tiny_engine(num_frames=T, device="cpu")
    if unet_state is not None:
        engine.unet.load_state_dict(unet_state)
    return engine


def _unet_state(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.unet.state_dict().items()}


def _ema_state(trainer) -> dict:
    return {k: v.detach().clone() for k, v in zip(trainer.names, trainer.ema)}


# ---------------------------------------------------------------------------
# test_torch_parallel.py


def train_tiny(mesh, steps: int = 3) -> dict:
    """``apps.train_diffusion.train`` under ``mesh`` on the tiny engine: 4
    seeded latent orbits at 8^2, global batches of 2 videos."""
    from v3d_tpu_torch.apps import train_diffusion as app
    from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset

    app.make_dataset = lambda data, t, clip_dim: SyntheticOrbitDataset(4, t, 8,
                                                                      clip_dim=clip_dim)
    stats = []
    trainer = app.train("synthetic", batch_size=2, num_frames=T, max_steps=steps,
                        log_every=1, engine=_tiny_engine(), log_fn=stats.append, mesh=mesh)
    return {"stats": stats, "params": _unet_state(trainer), "ema": _ema_state(trainer)}


def parallel_two(rank: int, world: int, out: str) -> dict:
    """Two ranks: the meshes, shard_batch, replicate, the train CLI's path
    at --model-axis 1, and a collective that one rank never joins."""
    from v3d_tpu_torch.parallel.mesh import (
        axis_index,
        make_mesh,
        replicate,
        shard_batch,
    )

    r = {}
    mesh = make_mesh(device="cpu")
    r["shape"], r["names"] = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    r["data_ranks"] = dist.get_process_group_ranks(mesh.get_group("data"))
    r["data_index"] = axis_index(mesh, "data")
    row = make_mesh(model=2, device="cpu")
    r["shape_model2"] = tuple(row.shape)
    r["model_index"] = axis_index(row, "model")

    batch = {"x": np.arange(64, dtype=np.float32).reshape(16, 4), "s": np.asarray(3.0),
             "t": torch.arange(6), "n": 4, "name": "orbit", "nested": [np.ones((4, 2))]}
    r["sharded"] = shard_batch(batch, mesh)
    r["sharded_model2"] = shard_batch(batch, row)
    try:
        shard_batch({"x": np.zeros((3, 2))}, mesh)
        r["indivisible"] = None
    except ValueError as e:
        r["indivisible"] = str(e)
    r["replicated"] = replicate({"w": torch.full((3, 3), float(rank)),
                                 "h": torch.full((2,), rank + 1, dtype=torch.bfloat16),
                                 "a": np.full((2,), rank, np.float32)}, mesh)
    r["train"] = train_tiny(mesh)

    # rank 1 never joins: rank 0's all_reduce must fail within its timeout
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=3))
    flag = os.path.join(out, "timed_out")
    if rank == 0:
        t0 = time.monotonic()
        try:
            dist.all_reduce(torch.ones(1), group=group)
            r["hang"] = None
        except Exception as e:   # gloo's timeout error type varies by version
            r["hang"] = (type(e).__name__, time.monotonic() - t0)
        open(flag, "w").close()
    else:
        deadline = time.monotonic() + 30
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.05)
    return r


def parallel_four(rank: int, world: int, out: str) -> dict:
    """Four ranks: the meshes of test_parallel.py::test_make_mesh_shapes,
    shard_params' local shards on a (2, 2) mesh, and the train CLI's path at
    --model-axis 2."""
    from v3d_tpu_torch.parallel.mesh import axis_index, make_mesh, shard_params

    r = {}
    r["shape_default"] = tuple(make_mesh(device="cpu").shape)
    mesh = make_mesh(data=2, model=2, device="cpu")
    r["shape"], r["names"] = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    r["coord"] = (axis_index(mesh, "data"), axis_index(mesh, "model"))
    try:
        make_mesh(data=3, model=2, device="cpu")
        r["bad_mesh"] = None
    except AssertionError as e:
        r["bad_mesh"] = str(e)
    shards = shard_params(_tiny_engine().unet, mesh)
    r["local"] = {k: v.to_local().clone() for k, v in shards.items()}
    r["placements"] = {k: repr(v.placements) for k, v in shards.items()}
    r["global_shape"] = {k: tuple(v.shape) for k, v in shards.items()}
    r["train"] = train_tiny(mesh)
    return r


# ---------------------------------------------------------------------------
# test_torch_dp_train.py


def _cpu_batch(engine, host: dict) -> dict:
    return {"latents": torch.as_tensor(host["latents"]),
            "cond": engine.training_cond(host, num_frames=T)}


def dp_train(rank: int, world: int, out: str, unet_state: dict, hosts: list,
             draws: list, grad_clip: float, png_root: str) -> dict:
    """The data-parallel fine-tune on ``world`` ranks of mesh (world, 1):
    - "jax": three steps on the global batches ``hosts`` with the global
      draws ``draws`` (JAX's), clipping at ``grad_clip``;
    - "own": three steps on the same batches with the trainer's own draws;
    - "resume": six steps through ``fit`` (prefetching host batches) against
      three, a checkpoint, and three more by a fresh trainer;
    - "png": ``batches`` on PNG orbits, sharded before the encode."""
    from v3d_tpu_torch.apps import train_diffusion as app
    from v3d_tpu_torch.data.objaverse import OrbitItemConfig, OrbitRenderDataset
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig, latest_checkpoint
    from v3d_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(device="cpu")
    r = {}

    def trainer(cfg):
        engine = _tiny_engine(unet_state)
        return engine, DiffusionTrainer(engine, cfg, num_frames=T, mesh=mesh)

    for name, given in (("jax", draws), ("own", None)):
        engine, tr = trainer(TrainConfig(log_every=1, grad_clip=grad_clip))
        stats = []
        for i, host in enumerate(hosts):
            local = shard_batch(_cpu_batch(engine, host), mesh)
            kw = {} if given is None else {"sigmas": torch.from_numpy(given[i][0]),
                                           "noise": torch.from_numpy(given[i][1])}
            stats.append(tr.train_step(local["latents"], local["cond"], **kw))
        r[name] = {"stats": stats, "params": _unet_state(tr), "ema": _ema_state(tr),
                   "grads": {k: p.grad.clone() for k, p in zip(tr.names, tr.params)
                             if p.grad is not None}}

    stream = [hosts[i % len(hosts)] for i in range(6)]
    engine, whole = trainer(TrainConfig(log_every=1))
    logged = []
    whole.fit(iter([{"latents": h["latents"], "cond": {k: v.numpy() for k, v in
                     engine.training_cond(h, num_frames=T).items()}} for h in stream]),
              max_steps=6, log_fn=logged.append, prefetch=True)
    ck = os.path.join(out, "ck")
    cfg = TrainConfig(log_every=1, ckpt_dir=ck, ckpt_every=3, keep_last=2)
    engine, first = trainer(cfg)
    first.fit(iter([_cpu_batch(engine, h) for h in stream]), max_steps=3,
              log_fn=lambda s: None)
    saved = sorted(os.listdir(ck))
    engine, resumed = trainer(cfg)   # a fresh process: auto-resume at step 3
    resumed.fit(iter([_cpu_batch(engine, h) for h in stream[3:]]), max_steps=6,
                log_fn=lambda s: None)
    r["resume"] = {
        "logged": logged, "saved": saved, "latest": os.path.basename(latest_checkpoint(ck)),
        "step": resumed.step,
        "whole": {"params": _unet_state(whole), "ema": _ema_state(whole),
                  "opt": whole.opt.state_dict()["state"]},
        "resumed": {"params": _unet_state(resumed), "ema": _ema_state(resumed),
                    "opt": resumed.opt.state_dict()["state"]}}

    engine = _tiny_engine()
    ds = OrbitRenderDataset(png_root, OrbitItemConfig(num_frames=T))
    src = app.batches(engine, ds, 2, T, mesh=mesh)
    r["png"] = next(src)
    src.close()
    return r


# ---------------------------------------------------------------------------
# test_torch_gs_sharded.py


def gs_sharded(rank: int, world: int, out: str, g, cam, cfg: dict,
               target: torch.Tensor) -> dict:
    """``rasterize_sharded`` over "data" of mesh (world, 1): the render on a
    white background, and the loss and gradients of the mean absolute error
    against ``target`` on a black one."""
    from v3d_tpu_torch.gs.gaussians import Gaussians
    from v3d_tpu_torch.gs.render import RasterizeConfig, project_gaussians, rasterize_sharded
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    rcfg = RasterizeConfig(**cfg)
    with torch.no_grad():
        ref = rasterize_sharded(project_gaussians(g, cam), cam.height, cam.width,
                                torch.ones(3), mesh, "data", rcfg)
    fields = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
    leaves = {k: getattr(g, k).clone().requires_grad_(True) for k in fields}
    reset_launch_counts()
    out_ = rasterize_sharded(project_gaussians(Gaussians(alive=g.alive, **leaves), cam),
                             cam.height, cam.width, torch.zeros(3), mesh, "data", rcfg)
    loss = (out_.image - target).abs().mean()
    loss.backward()
    return {"image": ref.image, "alpha": ref.alpha, "depth": ref.depth,
            "loss": float(loss.detach()), "launches": dict(LAUNCHES),
            "grads": {k: leaves[k].grad.clone() for k in fields}}


# ---------------------------------------------------------------------------
# test_torch_imports.py


def import_probe(rank: int, world: int, out: str) -> dict:
    """Import every module of v3d_tpu_torch.parallel and take one step of
    each collective the package uses."""
    import importlib
    import pkgutil

    import v3d_tpu_torch.parallel as parallel
    from v3d_tpu_torch.parallel.mesh import all_reduce_mean_, make_mesh, replicate

    names = [m.name for m in pkgutil.walk_packages(parallel.__path__,
                                                   "v3d_tpu_torch.parallel.")]
    for name in names:
        importlib.import_module(name)
    mesh = make_mesh(device="cpu")
    x = torch.full((3,), float(rank))
    all_reduce_mean_([x], mesh)
    w = replicate({"w": torch.full((2,), float(rank))}, mesh)["w"]
    return {"modules": names, "mean": x, "replicated": w}
