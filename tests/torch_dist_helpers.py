"""Rank functions of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_dp_train.py, test_torch_gs_sharded.py, test_torch_imports.py,
test_torch_frames.py, test_torch_tensor_parallel.py).

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


def start_ranks(fn, world: int, tmp_path, *args, timeout_s: float = JOIN_TIMEOUT_S):
    """``run_ranks`` in a thread of this process, so that it can work while
    the ranks do; the returned function waits for them and returns their
    dicts (or raises what ``run_ranks`` raised)."""
    import threading

    box = {}

    def target():
        try:
            box["ranks"] = run_ranks(fn, world, tmp_path, *args, timeout_s=timeout_s)
        except BaseException as e:   # handed to the waiting thread
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def wait() -> list:
        thread.join(timeout_s + 30)
        if "error" in box:
            raise box["error"]
        if "ranks" not in box:
            raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish")
        return box["ranks"]

    return wait


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


def frame_train(rank: int, world: int, out: str, unet_state: dict, hosts: list,
                draws: list, grad_clip: float) -> dict:
    """dp_train's "jax" run on ``world`` ranks that split each video: three
    steps on the global batches ``hosts`` (2 videos of T frames, T * 2 /
    world frames a rank) with the global draws ``draws``."""
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
    from v3d_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(device="cpu")
    engine = _tiny_engine(unet_state)
    tr = DiffusionTrainer(engine, TrainConfig(log_every=1, grad_clip=grad_clip),
                          num_frames=T, mesh=mesh)
    stats = []
    for host, (sigmas, noise) in zip(hosts, draws):
        local = shard_batch(_cpu_batch(engine, host), mesh)
        stats.append(tr.train_step(local["latents"], local["cond"],
                                   sigmas=torch.from_numpy(sigmas),
                                   noise=torch.from_numpy(noise)))
    return {"rows": int(local["latents"].shape[0]), "stats": stats,
            "params": _unet_state(tr), "ema": _ema_state(tr),
            "grads": {k: p.grad.clone() for k, p in zip(tr.names, tr.params)
                      if p.grad is not None}}


# ---------------------------------------------------------------------------
# test_torch_frames.py


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_as_on_card() -> None:
    """Route as on the card, each kernel wrapper counting its call and
    running its plain version (test_torch_routes.py's ``accelerators``, in
    this rank's process only)."""
    from v3d_tpu_torch.models import attention_blocks as pblocks
    from v3d_tpu_torch.models import layers as players
    from v3d_tpu_torch.ops import LAUNCHES, group_norm
    from v3d_tpu_torch.ops import attention as pattn
    from v3d_tpu_torch.ops import flash_attention as pfa
    from v3d_tpu_torch.ops import temporal_attention as pta

    pattn._on_card = lambda *tensors: True
    pblocks.use_plain = lambda *tensors: False
    players.use_plain = lambda *tensors: False
    for mod, name, key in ((pattn, "flash_attn_fwd", "flash_attn_fwd"),
                           (pfa, "flash_attn_fwd", "flash_attn_fwd"),
                           (pfa, "flash_attn_fwd_wide", "flash_attn_fwd_wide"),
                           (pta, "temporal_core_fwd", "temporal_core"),
                           (pta, "temporal_block_fwd", "temporal_block"),
                           (group_norm, "group_norm_fwd", "group_norm"),
                           (group_norm, "group_norm_stats_fwd", "group_norm_stats"),
                           (group_norm, "group_norm_apply_fwd", "group_norm_apply"),
                           (players, "layer_norm_f32", "layer_norm")):
        def counted(*args, _orig=getattr(mod, name), _key=key, **kw):
            LAUNCHES[_key] += 1
            return _orig(*args, **kw)

        setattr(mod, name, counted)


def _frames_engine(t: int, unet_state: dict):
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    engine = build_tiny_engine(num_frames=t, num_steps=2, device="cpu")
    engine.unet.load_state_dict(unet_state)
    return engine


def frames_run(rank: int, world: int, out: str, t: int, unet_state: dict,
               inputs: dict, checks: bool = False) -> dict:
    """The frame-parallel paths on mesh (world, 1), every video's frames
    split: ``sample_latents(mesh=)`` from ``inputs["noise"]`` with c / uc, one
    network forward through ``make_unet_network_fn(mesh=)``, one fine-tune
    step on ``inputs["batch"]`` with its global draws, the exchanges'
    round trips in both modes on uneven strips, the refusal of a row count
    the ranks do not divide, and with ``checks`` ``frames_checks`` on ranks
    0 and 1."""
    import dataclasses

    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
    from v3d_tpu_torch.engines.wrappers import make_unet_network_fn
    from v3d_tpu_torch.parallel import frames as fr
    from v3d_tpu_torch.parallel.mesh import make_mesh, shard_batch

    def tt(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}

    mesh = make_mesh(device="cpu")
    engine = _frames_engine(t, unet_state)
    r = {}
    fr.reset_traffic()
    r["sample"] = engine.sample_latents(tt(inputs["c"]), tt(inputs["uc"]), 64, 64,
                                        noise=torch.from_numpy(inputs["noise"]), mesh=mesh)
    r["traffic"] = dict(fr.TRAFFIC)
    fwd = inputs["forward"]
    net = make_unet_network_fn(engine.unet, t, mesh=mesh)
    with torch.no_grad():
        r["forward"] = net(torch.from_numpy(fwd["x"]), torch.from_numpy(fwd["c_noise"]),
                           tt(fwd["cond"]), torch.zeros(2, t))
    try:    # 2 (world - 1) rows: whole videos that the ranks do not divide
        make_unet_network_fn(engine.unet, world - 1, mesh=mesh)(
            torch.zeros(2 * world - 2, 8, 8, 4), torch.zeros(2 * world - 2), {}, None)
        r["indivisible"] = None
    except ValueError as e:
        r["indivisible"] = str(e)

    batch = inputs["batch"]
    tr = DiffusionTrainer(_frames_engine(t, unet_state), TrainConfig(), num_frames=t,
                          mesh=mesh)
    tr.unet.use_checkpoint = True      # the recompute re-issues the collectives
    local = shard_batch({"latents": torch.from_numpy(batch["latents"]),
                         "cond": tt(batch["cond"])}, mesh)
    r["step"] = tr.train_step(local["latents"], local["cond"],
                              sigmas=torch.from_numpy(batch["sigmas"]),
                              noise=torch.from_numpy(batch["noise"]))
    r["grads"] = {k: p.grad.clone() for k, p in zip(tr.names, tr.params)
                  if p.grad is not None}

    # the launches of a forward and of a step as on the card, against
    # chip_smoke.py's counts of this rank's share (walked from the modules)
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cs = _chip_smoke()
    _count_as_on_card()
    reset_launch_counts()
    with torch.no_grad():
        net(torch.from_numpy(fwd["x"]), torch.from_numpy(fwd["c_noise"]),
            tt(fwd["cond"]), torch.zeros(2, t))
    r["forward_launches"] = (dict(LAUNCHES), cs.forward_launches(
        engine.unet, 8, dtype=torch.float32, ranks=world, rank=rank))
    reset_launch_counts()
    tr.train_step(local["latents"], local["cond"], sigmas=torch.from_numpy(batch["sigmas"]),
                  noise=torch.from_numpy(batch["noise"]))
    r["step_launches"] = (dict(LAUNCHES), cs.train_launches(
        tr.unet, 8, True, ranks=world, rank=rank, dtype=torch.float32))

    # exchanges on (R, s, c) tokens with s not a multiple of the ranks
    fs = fr.frame_shard(mesh, 2 * world, 2)
    whole = torch.from_numpy(np.random.RandomState(5).randn(2 * world, 7, 3)
                             .astype(np.float32))
    x = whole[fs.block]
    r["round_trip"] = {"mode": fs.mode, "whole": whole}
    for mode in ("all_gather", "all_to_all"):
        m = dataclasses.replace(fs, mode=mode)
        px = fr.frames_to_pixels(x, m)
        r["round_trip"][mode] = (px, fr.pixels_to_frames(px, 7, m), x)
    if checks:
        pair = dist.new_group([0, 1])      # every rank creates it
        if rank < 2:
            r["checks"] = frames_checks(rank, pair)
    return r


def _global(op, take, fs):
    """op, a function of this rank's share of a distributed tensor, as a
    function of the whole tensor X that every rank holds (gradcheck
    perturbs each element of X on every rank at once): X's sum over the
    ranks / n (whose backward adds each rank's gradient of its share), this
    rank's share of it (``take``), op, and every rank's result gathered, so
    both the output and the gradient are the whole function's."""
    from v3d_tpu_torch.parallel import frames as fr

    return lambda X: fr.gather_rows(op(take(fr.all_reduce_sum(X, fs) / fs.size)), fs)


def frames_checks(rank: int, group) -> dict:
    """On the 2 ranks of ``group``: ``gradcheck`` (float64) of
    frames_to_pixels / pixels_to_frames in both exchange modes and of the
    differentiable all_reduce / gather, each as a function of the whole
    distributed tensor (``_global``); the split-statistics GroupNorm on
    strips of a video against the whole video in float64
    (``F.group_norm``)."""
    import dataclasses

    import torch.nn.functional as F

    from v3d_tpu_torch.ops.group_norm import group_norm_act_split
    from v3d_tpu_torch.parallel import frames as fr
    from v3d_tpu_torch.parallel.mesh import pixel_strips

    # 2 ranks, 2 rows each
    fs = fr.FrameShard(group, 2, rank, 4, 2, fr.EXCHANGE[dist.get_backend(group)])
    r = {"mode": fs.mode, "gradcheck": {}}
    rs = np.random.RandomState(11)           # the same X on both ranks
    a, b = pixel_strips(5, 2)[rank]       # strips of 3 and 2 pixels
    for mode in ("all_gather", "all_to_all"):
        m = dataclasses.replace(fs, mode=mode)
        x = torch.from_numpy(rs.randn(4, 5, 3)).requires_grad_(True)
        r["gradcheck"][mode] = (   # (strips padded to one width to be gathered)
            torch.autograd.gradcheck(_global(
                lambda v: F.pad(fr.frames_to_pixels(v, m), (0, 0, 0, 3 - (b - a))),
                lambda X: X[fs.block], fs), (x,)),
            torch.autograd.gradcheck(_global(lambda v: fr.pixels_to_frames(v, 5, m),
                                             lambda X: X[:, a:b], fs), (x,)))
    v = torch.from_numpy(rs.randn(4, 3)).requires_grad_(True)
    r["gradcheck"]["reduce"] = (
        torch.autograd.gradcheck(_global(lambda u: fr.all_reduce_sum(u, fs),
                                         lambda X: X[fs.block], fs), (v,)),
        torch.autograd.gradcheck(_global(lambda u: fr.gather_rows(u, fs)[::2],
                                         lambda X: X[fs.block], fs), (v,)))

    # one video (b, c, t, h, w) = (2, 64, 3, 4, 6): rank r's pixel strip of
    # every frame, channels-last as the frame-parallel time stack holds it
    whole = np.random.RandomState(0).randn(2, 64, 3, 4, 6).astype(np.float32)
    scale = 1 + 0.1 * np.random.RandomState(1).randn(64).astype(np.float32)
    bias = 0.1 * np.random.RandomState(2).randn(64).astype(np.float32)
    cot = np.random.RandomState(3).randn(*whole.shape).astype(np.float32)
    a, b = pixel_strips(24, 2)[rank]
    flat = whole.reshape(2, 64, 3, 24)[..., a:b]
    x = torch.from_numpy(np.ascontiguousarray(flat))[..., None].contiguous(
        memory_format=torch.channels_last_3d).requires_grad_(True)
    w, bb = (torch.from_numpy(p).requires_grad_(True) for p in (scale, bias))
    y = group_norm_act_split(x, w, bb, 32, 1e-5, True, 3 * 24,
                             lambda s: fr.all_reduce_sum(s, fs))
    g = torch.from_numpy(np.ascontiguousarray(cot.reshape(2, 64, 3, 24)[..., a:b]))[..., None]
    y.backward(g)
    x64, w64, b64 = (torch.from_numpy(p).double().requires_grad_(True)
                     for p in (whole, scale, bias))
    y64 = F.silu(F.group_norm(x64, 32, w64, b64, 1e-5))
    y64.backward(torch.from_numpy(cot).double())
    r["gn"] = {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": bb.grad,
               "y64": y64.detach().reshape(2, 64, 3, 24)[..., a:b, None],
               "dx64": x64.grad.reshape(2, 64, 3, 24)[..., a:b, None],
               "dw64": w64.grad, "db64": b64.grad}
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


# ---------------------------------------------------------------------------
# test_torch_tensor_parallel.py


def _svt_run(mesh, svt_state: dict, svt_inputs: dict) -> dict:
    """One SpatialVideoTransformer at V3D's ds1 ratio, cut over "model" of
    ``mesh``: its output, the input's gradient and every parameter's
    gradient made whole, for the cotangent ``svt_inputs["cot"]``; the
    collectives of the forward."""
    from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from v3d_tpu_torch.parallel import tensor as tp

    i = svt_inputs
    svt = SpatialVideoTransformer(i["c"], i["heads"], i["dh"], i["context_dim"])
    svt.load_state_dict(svt_state)
    tp.tp_shard_(svt, mesh)
    x = torch.from_numpy(i["x"]).permute(0, 3, 1, 2).requires_grad_(True)
    tp.reset_traffic()
    y = svt(x, torch.from_numpy(i["ctx"]), i["t"], torch.from_numpy(i["ind"]))
    traffic = dict(tp.TRAFFIC)
    (y * torch.from_numpy(i["cot"]).permute(0, 3, 1, 2)).sum().backward()
    grads = tp.tp_gather(svt, {n: p.grad for n, p in svt.named_parameters()})
    plans = {name: (m.tp_plan.first, m.tp_plan.last, m.tp_plan.pad)
             for name, m in svt.named_modules() if getattr(m, "tp_plan", None)}
    return {"y": y.detach().permute(0, 2, 3, 1).contiguous(), "dx": x.grad.permute(0, 2, 3, 1),
            "grads": grads, "traffic": traffic, "plans": plans}


def _tp_checks(shard) -> dict:
    """On the 2 ranks of ``shard``: float64 gradcheck of copy_to_model,
    reduce_from_model and gather_columns as the TP forward uses them, each
    a function of a tensor X that every rank holds (gradcheck perturbs it on
    both at once): X enters through copy_to_model, each rank applies its own
    map to its share, and reduce_from_model sums the results (the same on
    both ranks); and the gradient reduce_from_model hands back (the
    cotangent itself) beside that of a sum whose backward all-reduces
    (frames.all_reduce_sum: twice it)."""
    from v3d_tpu_torch.parallel import frames as fr
    from v3d_tpu_torch.parallel import tensor as tp

    i = shard.index
    rs = np.random.RandomState(12)                     # the same draws on both ranks
    a = torch.from_numpy(rs.randn(2, 3, 4))[i]          # this rank's own maps
    m = torch.from_numpy(rs.randn(2, 4, 3))[i]

    def copy(u):
        return tp.copy_to_model(u, shard)

    def reduce(u):
        return tp.reduce_from_model(u, shard)

    r = {}
    x = torch.from_numpy(rs.randn(2, 4)).requires_grad_(True)
    r["copy"] = torch.autograd.gradcheck(lambda u: reduce(copy(u) @ a.t()), (x,))
    p = torch.from_numpy(rs.randn(2, 2, 3)).requires_grad_(True)
    r["reduce"] = torch.autograd.gradcheck(lambda u: reduce(copy(u)[i]), (p,))
    w = torch.from_numpy(rs.randn(4, 3)).requires_grad_(True)
    r["gather"] = torch.autograd.gradcheck(
        lambda u: reduce((tp.gather_columns(copy(u)[2 * i:2 * i + 2], shard) * m).sum(0)),
        (w,))
    fs = fr.FrameShard(shard.group, shard.size, i, 2 * shard.size, 2, "all_gather")
    g = torch.from_numpy(rs.randn(3, 5))
    for name, fn in (("reduce_from_model", reduce),
                     ("all_reduce_sum", lambda v: fr.all_reduce_sum(v, fs))):
        v = torch.ones(3, 5, dtype=torch.float64, requires_grad=True)
        fn(v).backward(g)
        r[name] = (v.grad, g)
    return r


def _tp_launches(engine, mesh, t: int, fwd: dict) -> tuple:
    """Routed as on the card, one tensor-parallel UNet forward (no frame
    split) against chip_smoke.py's count of one process's forward."""
    from v3d_tpu_torch.engines.wrappers import make_unet_network_fn
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cs = _chip_smoke()
    _count_as_on_card()
    reset_launch_counts()
    with torch.no_grad():
        make_unet_network_fn(engine.unet, t)(
            torch.from_numpy(fwd["x"]), torch.from_numpy(fwd["c_noise"]),
            {k: torch.from_numpy(v) for k, v in fwd["cond"].items()}, torch.zeros(2, t))
    return dict(LAUNCHES), cs.forward_launches(engine.unet, fwd["x"].shape[1],
                                               dtype=torch.float32)


def tp_run(rank: int, world: int, out: str, svt_state: dict, svt_inputs: dict,
           tiny_state: dict, step: dict, sample: dict, straddle: dict) -> dict:
    """Four ranks.  On the (2, 2) mesh: the ds1 transformer on 2 model ranks,
    the dry run's tensor-parallel step (``tp_train_step``, checkpointing on)
    on ``step``'s batch and draws (and, on rank 0, one process's step), its
    sampling stage's sample on
    ``sample``'s noise, the straddling tiny UNet's sample and one process's,
    the round trips of tp_shard_ / tp_gather and the local shards against
    ``shard_params``', the collectives' checks on each model row, a trainer
    handed a cut UNet, the launches as on the card, and the full-size meta
    stage.  On the (1, 4) mesh: the ds1 transformer on 4 model ranks."""
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
    from v3d_tpu_torch.parallel import dryrun
    from v3d_tpu_torch.parallel import tensor as tp
    from v3d_tpu_torch.parallel.mesh import make_mesh, shard_params

    def tt(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}

    mesh = make_mesh(data=2, model=2, device="cpu")
    shard = tp.model_shard(mesh)
    r = {"coord": (mesh.get_local_rank("data"), shard.index)}
    r["svt2"] = _svt_run(mesh, svt_state, svt_inputs)

    def tiny(state=None, **kw):
        engine = build_tiny_engine(num_frames=T, device="cpu", **kw)
        if state is not None:
            engine.unet.load_state_dict(state)
        return engine

    draws = dict(sigmas=torch.from_numpy(step["sigmas"]), noise=torch.from_numpy(step["noise"]))
    engine = tiny(tiny_state)
    engine.unet.use_checkpoint = True    # the recompute runs the collectives again
    r["step"] = dryrun.tp_train_step(engine, torch.from_numpy(step["latents"]),
                                     tt(step["cond"]), T, mesh=mesh, **draws)
    if rank == 0:
        r["step_one"] = dryrun.tp_train_step(tiny(tiny_state), torch.from_numpy(
            step["latents"]), tt(step["cond"]), T, **draws)

    engine = tiny(tiny_state, num_steps=dryrun.SAMPLE_STEPS)
    tp.tp_shard_(engine.unet, mesh)
    r["sample"] = engine.sample_latents(tt(sample["c"]), tt(sample["uc"]), dryrun.SAMPLE_RES,
                                        dryrun.SAMPLE_RES,
                                        noise=torch.from_numpy(sample["noise"]), mesh=mesh)

    # the tiny UNet at 96 channels, heads of 32: 3 at ds1 (straddling 2
    # ranks), 6 at ds2
    kw = dict(num_steps=2, unet_overrides=straddle["overrides"])
    engine = tiny(straddle["state"], **kw)
    args = (tt(sample["c"]), tt(sample["uc"]), 64, 64)
    r["straddle_one"] = engine.sample_latents(*args, noise=torch.from_numpy(sample["noise"]))
    state = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    placed = shard_params(engine.unet, mesh)
    tp.tp_shard_(engine.unet, mesh)
    r["plans"] = {name: (m.tp_plan.first, m.tp_plan.last, m.tp_plan.pad)
                  for name, m in engine.unet.named_modules() if getattr(m, "tp_plan", None)}
    r["straddle"] = engine.sample_latents(*args, noise=torch.from_numpy(sample["noise"]),
                                          mesh=mesh)
    local = engine.unet.state_dict()
    r["local_vs_placed"] = {
        k: torch.equal(local[k], placed[k].to_local()) for k in state
        if k.endswith(("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight",
                       "net.2.weight"))}
    r["geglu"] = {k: (local[k], state[k]) for k in state if k.endswith(tp.GEGLU_CUT)}
    r["local_bytes"] = (tp.local_param_bytes(engine.unet),
                        sum(v.to_local().numel() * 4 for v in placed.values()),
                        sum(state[k].numel() * 4 for k in state if k.endswith(tp.GEGLU_CUT[1])))
    gathered = tp.tp_gather(engine.unet)
    r["round_trip"] = (gathered.keys() == state.keys()
                       and all(torch.equal(gathered[k], state[k]) for k in state))
    try:       # CLIP's c_fc / c_proj / in_proj match the rules: no TP forward here
        tp.tp_shard_(engine.clip, mesh)
        r["clip_refused"] = None
    except ValueError as e:
        r["clip_refused"] = str(e)

    r["checks"] = _tp_checks(shard)
    r["fullsize"] = dryrun.fullsize_forward(mesh)
    row = make_mesh(data=1, model=4, device="cpu")
    r["svt4"] = _svt_run(row, svt_state, svt_inputs)

    # last: routed as on the card from here on in this process
    r["launches"] = _tp_launches(engine, mesh, T, straddle["forward"])
    trainer = DiffusionTrainer(engine, TrainConfig(), num_frames=T, mesh=mesh)
    r["trainer_whole"] = (engine.unet.tp is None and all(
        torch.equal(p, state[n]) for n, p in zip(trainer.names, trainer.params)))
    return r
