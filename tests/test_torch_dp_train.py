"""The port's data-parallel fine-tune (DiffusionTrainer(mesh=...) on 2 ranks
spawned on the CPU over gloo, tests/torch_dist_helpers.py) against the JAX
trainer on make_mesh(model=1) over conftest's 8 CPU devices, and against
one process of the port on the global batch, in float32 with the tiny
engine.

- Three steps of both from the same UNet weights on global batches of 2
  videos x T = 4 frames ((b t) = 8 frames: one a JAX device, one video a
  port rank), the JAX step's draws computed here and handed to the port's
  ranks whole (each rank takes its block).  Gradient clipping at 2.0: the
  steps' global norms are 2.14, 2.15, 1.85, so two steps clip and one does
  not (test_torch_train_steps.py's 2.8 is above every norm of a batch of 2
  videos).  Tolerances are that file's: the loss and gradient norm rel 1e-4
  a step; every parameter and EMA tensor within 2e-6 abs plus 1e-5
  relative, elements whose gradient is 0 (< 1e-6 of the largest) within 2
  lr; on both ranks, which hold the same tensors exactly.
- The 2-rank steps with the trainer's own draws against one process's
  steps on the global batch (``mesh=None``, the draws of the same step
  generator at the same shape): the ranks' halves of each sum add in
  another order, so the loss and gradient norm agree to rel 1e-6 and the
  parameters to float32 rounding moved by Adam (the same 2e-6 + 1e-5 rel,
  2 lr where the gradient is 0).
- Resuming on 2 ranks from the checkpoint rank 0 wrote at step 3 equals
  the uninterrupted 6-step run (which prefetches host batches and shards
  them on the host) exactly, optimizer moments included; one file a
  checkpoint is written, and only rank 0 logs.
- The same three steps on 4 ranks, 2 frames a rank, so that each video's
  frames split over 2 ranks (the frame-parallel forward,
  ``parallel/frames.py``), held to the JAX trainer as the 2-rank steps are.
- ``batches`` on PNG orbits under the mesh (each rank's slice cut before
  the encode, its noise its block of the global draw) equals the slice of
  one process's batch: the VAE encodes 4 frames instead of 8, so its
  convolutions may round differently (atol 1e-5 of the largest latent).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from torch_dist_helpers import T, dp_train, frame_train, run_ranks, start_ranks
from torch_port_helpers import MAP_UNET, numpy_init_, to_flax
from v3d_tpu.diffusion.sigma_sampling import EDMSampling
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.engines.trainer import DiffusionTrainer as JTrainer
from v3d_tpu.engines.trainer import TrainConfig as JConfig
from v3d_tpu.parallel.mesh import make_mesh
from v3d_tpu_torch.apps import train_diffusion as app
from v3d_tpu_torch.data.objaverse import (
    OrbitItemConfig,
    OrbitRenderDataset,
    SyntheticOrbitDataset,
)
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig

CLIP = 2.0
LR = 1e-4


def _write_orbits(root, n_obj=2, hw=64, seed=0):
    rs = np.random.RandomState(seed)
    for o in range(n_obj):
        d = root / f"obj{o}"
        d.mkdir(parents=True)
        for i in range(T):
            arr = rs.randint(0, 256, (hw, hw, (4, 3)[o % 2]), np.uint8)
            Image.fromarray(arr).save(d / f"{i:03d}.png")
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    engine = build_tiny_engine(num_frames=T, device="cpu")
    numpy_init_(engine.unet, 21)
    unet_state = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    it = SyntheticOrbitDataset(num_objects=3, num_frames=T, latent_hw=8, seed=1,
                               clip_dim=64).iter_batches(2)
    hosts = [next(it) for _ in range(3)]

    jengine = jax_tiny_engine(num_frames=T, resolution=64)
    jt = JTrainer(jengine, to_flax(engine.unet, MAP_UNET),
                  JConfig(log_every=1, grad_clip=CLIP), mesh=make_mesh(model=1),
                  num_frames=T)
    jstats, draws = [], []
    for i, host in enumerate(hosts):
        rng = jax.random.PRNGKey(30 + i)
        batch = jt.shard_batch({"latents": host["latents"],
                                "cond": jengine.training_cond(host, num_frames=T)})
        jstats.append(jt.train_step(rng, batch["latents"], batch["cond"]))
        k_sig, k_noise, _ = jax.random.split(rng, 3)
        n = host["latents"].shape[0]
        draws.append((np.asarray(EDMSampling(p_mean=1.5, p_std=2.0)(k_sig, n)),
                      np.asarray(jax.random.normal(k_noise, host["latents"].shape))))

    png = _write_orbits(tmp_path_factory.mktemp("orbits"))
    frame_ranks = start_ranks(frame_train, 4, tmp_path_factory.mktemp("frames"),
                              unet_state, hosts, draws, CLIP)
    ranks = run_ranks(dp_train, 2, tmp_path_factory.mktemp("dp"), unet_state, hosts,
                      draws, CLIP, str(png))

    # one process of the port on the global batches, its own draws
    single = DiffusionTrainer(engine, TrainConfig(log_every=1, grad_clip=CLIP),
                              num_frames=T)
    sstats = [single.train_step(torch.as_tensor(h["latents"]),
                                engine.training_cond(h, num_frames=T)) for h in hosts]
    ds = OrbitRenderDataset(str(png), OrbitItemConfig(num_frames=T))
    src = app.batches(build_tiny_engine(num_frames=T, device="cpu"), ds, 2, T)
    png_single = next(src)
    src.close()
    return dict(jt=jt, jstats=jstats, ranks=ranks, single=single, sstats=sstats,
                png_single=png_single, frame_ranks=frame_ranks())


def _flax_get(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


def _hold(got: dict, want_of, grads: dict, lr_moves: float = 2 * LR):
    """Every tensor of ``got`` (name -> port tensor) within 2e-6 + 1e-5 rel
    of ``want_of(name)``; elements with no gradient within ``lr_moves``."""
    top = max(float(g.abs().max()) for g in grads.values())
    for name, x in got.items():
        _, fn = MAP_UNET(name)
        a = np.asarray(fn(x))
        b = want_of(name)
        zero = np.abs(np.asarray(fn(grads[name]))) < 1e-6 * top if name in grads else True
        err = np.abs(a - b) - (np.where(zero, lr_moves, 2e-6) + 1e-5 * np.abs(b))
        assert float(err.max()) <= 0, (name, float(np.abs(a - b).max()))


def test_dp_steps_match_the_jax_trainer_on_8_devices(run):
    clipped = 0
    for r in run["ranks"]:
        assert r["foreign"] == []
        for got, want in zip(r["jax"]["stats"], run["jstats"]):
            assert got["step"] == want["step"]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
        clipped = sum(s["grad_norm"] >= CLIP for s in r["jax"]["stats"])
    assert clipped == 2
    jt, r0 = run["jt"], run["ranks"][0]["jax"]
    for key, tree in (("params", jt.params), ("ema", jt.ema_params)):
        _hold(r0[key], lambda name: _flax_get(tree["params"], MAP_UNET(name)[0]), r0["grads"])
        for name, x in r0[key].items():     # the replicas agree exactly
            assert torch.equal(run["ranks"][1]["jax"][key][name], x), name


def test_frame_split_steps_on_4_ranks_match_the_jax_trainer(run):
    """The same three steps on 4 ranks, 2 frames a rank: each video's
    frames split over 2 ranks (the frame-parallel UNet forward), held as
    the 2-rank steps are."""
    jt = run["jt"]
    for r in run["frame_ranks"]:
        assert r["foreign"] == [] and r["rows"] == 2
        for got, want in zip(r["stats"], run["jstats"]):
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    r0 = run["frame_ranks"][0]
    for key, tree in (("params", jt.params), ("ema", jt.ema_params)):
        _hold(r0[key], lambda name: _flax_get(tree["params"], MAP_UNET(name)[0]), r0["grads"])
        for r in run["frame_ranks"][1:]:      # the replicas agree exactly
            for name, x in r0[key].items():
                assert torch.equal(r[key][name], x), name


def test_two_ranks_equal_one_process_on_the_global_batch(run):
    single = run["single"]
    grads = {k: p.grad for k, p in zip(single.names, single.params) if p.grad is not None}
    for r in run["ranks"]:
        for got, want in zip(r["own"]["stats"], run["sstats"]):
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-6)
        for key, tensors in (("params", single.params), ("ema", single.ema)):
            state = dict(zip(single.names, tensors))
            _hold(r["own"][key],
                  lambda name: np.asarray(MAP_UNET(name)[1](state[name].detach())), grads)


def test_resume_on_two_ranks_equals_the_uninterrupted_run(run):
    for rank, r in enumerate(run["ranks"]):
        res = r["resume"]
        assert res["saved"] == ["step_3.pt"] and res["latest"] == "step_6.pt"
        assert res["step"] == 6
        assert len(res["logged"]) == (6 if rank == 0 else 0)
        for key in ("params", "ema"):
            for name, x in res["whole"][key].items():
                assert torch.equal(res["resumed"][key][name], x), (key, name)
        for i, st in res["whole"]["opt"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(res["resumed"]["opt"][i][k], st[k]), (i, k)


def test_sharded_png_batch_equals_the_slice_of_one_process(run):
    want = run["png_single"]
    top = float(want["latents"].abs().max())
    for rank, r in enumerate(run["ranks"]):
        got, rows = r["png"], slice(rank * T, (rank + 1) * T)
        torch.testing.assert_close(got["latents"], want["latents"][rows], rtol=0,
                                   atol=1e-5 * top)
        assert got["cond"].keys() == want["cond"].keys()
        for k, v in want["cond"].items():
            torch.testing.assert_close(got["cond"][k], v[rows], rtol=1e-5, atol=1e-5,
                                       msg=k)
