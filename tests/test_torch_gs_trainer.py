"""The port's 3DGS fit (v3d_tpu_torch/gs/densify.py, trainer.py, ply.py,
apps/recon_gs.py, core/convert.py) against the JAX package, on the CPU.

Tolerances:
- densify_and_prune vs densify_and_prune_jnp fed the same split normals:
  masks and counts exact, values 1e-6 (elementwise float32);
- three ``train_iter`` steps of both trainers from one state carried by
  ``trainer_state_from_jax``, on explicit views: each step's loss rel 1e-4,
  and the first step's gradients (optax's first mu is 0.1 g) max |port -
  JAX| <= 1e-4 max |JAX| per field.  Parameters after several steps are not
  compared: with eps = 1e-15 Adam moves a near-zero gradient by ~lr whatever
  its sign noise.
- PLY files byte-identical.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.data.cameras import orbit_cameras as jorbit
from v3d_tpu.gs.densify import densify_and_prune_jnp
from v3d_tpu.gs.ply import save_ply as jsave_ply
from v3d_tpu.gs.trainer import GSTrainConfig as JConfig
from v3d_tpu.gs.trainer import GSTrainer as JTrainer
from v3d_tpu_torch.apps import recon_gs
from v3d_tpu_torch.core.convert import trainer_state_from_jax
from v3d_tpu_torch.data.cameras import orbit_cameras
from v3d_tpu_torch.gs import ply
from v3d_tpu_torch.gs.densify import densify_and_prune, reset_opacity
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer, expon_lr

torch.set_num_threads(1)

KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _densify_case(name):
    """A mixed state: live slots 0-39, high gradients on 10-19 (clones when
    small, splits when large), low opacity on 5-7; "saturated" leaves 12
    free slots for 20 split children; "screen" prunes by size."""
    rs = np.random.RandomState(0)
    cap = 64
    alive = np.zeros(cap, bool)
    alive[:40] = True
    if name == "saturated":
        alive[:52] = True
    scale = {"clone": 0.005, "split": 0.5, "saturated": 0.5, "screen": 0.05}[name]
    g = {"xyz": rs.randn(cap, 3), "f_dc": rs.randn(cap, 1, 3),
         "f_rest": rs.randn(cap, 15, 3),
         "scaling": np.log(np.full((cap, 3), scale) * (1 + 0.1 * rs.rand(cap, 1))),
         "rotation": rs.randn(cap, 4), "opacity": np.full((cap, 1), 2.0)}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    g["opacity"][5:8] = -8.0
    grad_accum = np.zeros(cap, np.float32)
    grad_accum[10:20] = 1.0
    denom = np.ones(cap, np.float32)
    max_radii = np.linspace(0, 40, cap).astype(np.float32)
    max_screen = 20.0 if name == "screen" else 0.0
    return g, alive, grad_accum, denom, max_radii, max_screen


@pytest.mark.parametrize("name", ["clone", "split", "saturated", "screen"])
def test_densify_matches_jax(name):
    g, alive, grad_accum, denom, max_radii, max_screen = _densify_case(name)
    key = jax.random.PRNGKey(3)
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=2.0,
              max_screen_size=max_screen, percent_dense=0.01)
    jp, jalive, jtouched, jstats = jax.jit(
        densify_and_prune_jnp, static_argnames=("max_screen_size",))(
        {k: jnp.asarray(v) for k, v in g.items()}, jnp.asarray(alive),
        jnp.asarray(grad_accum), jnp.asarray(denom), jnp.asarray(max_radii),
        key, **kw)
    samples = torch.from_numpy(np.array(jax.random.normal(key, (len(alive), 3))))
    p, new_alive, touched, stats = densify_and_prune(
        {k: torch.from_numpy(v) for k, v in g.items()}, torch.from_numpy(alive),
        torch.from_numpy(grad_accum), torch.from_numpy(denom),
        torch.from_numpy(max_radii), samples=samples, **kw)
    np.testing.assert_array_equal(new_alive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(touched.numpy(), np.asarray(jtouched))
    for k in jstats:
        assert int(stats[k]) == int(jstats[k]), k
    for k in KEYS:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert int(stats["cloned"]) + int(stats["split"]) > 0


def test_reset_opacity_and_expon_lr():
    logits = torch.tensor([[-3.0], [0.0], [4.0]])
    op = torch.sigmoid(reset_opacity(logits))
    np.testing.assert_allclose(op.numpy()[:, 0], [0.01, 0.01, 0.01], rtol=1e-4)
    assert float(torch.sigmoid(reset_opacity(torch.tensor([-6.0])))) < 0.01
    from v3d_tpu.gs.trainer import expon_lr as jexpon

    for step in (0, 1, 500, 30_000, 40_000):
        np.testing.assert_allclose(
            expon_lr(step, 3.5e-4, 3.5e-6, 0.01, max_steps=30_000),
            float(jexpon(step, 3.5e-4, 3.5e-6, 0.01, max_steps=30_000)), rtol=1e-6)
        np.testing.assert_allclose(
            expon_lr(step, 1e-3, 1e-5, 0.01, lr_delay_steps=1000),
            float(jexpon(step, 1e-3, 1e-5, 0.01, lr_delay_steps=1000)), rtol=1e-6)


def _frames(n=4, res=64):
    return [np.random.RandomState(i).rand(res, res, 3).astype(np.float32) * 0.6 + 0.2
            for i in range(n)]


CFG = dict(densify_from_iter=10**6, opacity_reset_interval=10**6,
           lambda_dssim=1.0, opacity_reset_mode="none", opacity_decay=0.995,
           coarse_factor=2, max_per_coarse=128, tile_chunk=4)


def test_three_steps_match_jax_trainer():
    frames = _frames()
    jt = JTrainer(jorbit(4, resolution=64, images=frames), JConfig(**CFG),
                  num_pts=200, capacity=260, seed=0)
    port = GSTrainer(orbit_cameras(4, resolution=64, images=frames),
                     GSTrainConfig(**CFG), num_pts=200, capacity=260, seed=0,
                     device="cpu")
    # anisotropic, rotated gaussians, so that every field has a gradient
    state = jt.capture()
    rs = np.random.RandomState(1)
    params = dict(state["params"])
    params["scaling"] = params["scaling"] + jnp.asarray(
        0.3 * rs.randn(*params["scaling"].shape), jnp.float32)
    params["rotation"] = jnp.asarray(rs.randn(*params["rotation"].shape), jnp.float32)
    jt.restore({**state, "params": params})
    port.restore(trainer_state_from_jax(jt.capture()))
    for step, cam in enumerate([0, 2, 1]):
        jl = float(jt.train_iter(cam)["loss"])
        pl = float(port.train_iter(cam)["loss"])
        np.testing.assert_allclose(pl, jl, rtol=1e-4, err_msg=f"step {step}")
        if step == 0:
            jstate = trainer_state_from_jax(jt.capture())
            for k in ("xyz", "f_dc", "scaling", "rotation", "opacity"):
                want = jstate["adam"][k]["exp_avg"] / 0.1
                got = port.params[k].grad.numpy()
                scale = np.abs(want).max()
                assert scale > 0, k
                assert np.abs(got - want).max() <= 1e-4 * scale, k
            for k in ("grad_accum", "denom", "max_radii"):
                np.testing.assert_allclose(port.stats[k].numpy(), jstate["stats"][k],
                                           rtol=1e-4, atol=1e-9, err_msg=k)
    assert port.step_count == jt.step_count == 3


def test_capture_restore_round_trip():
    frames = _frames(n=2, res=32)
    cams = orbit_cameras(2, resolution=32, images=frames)
    a = GSTrainer(cams, GSTrainConfig(**CFG), num_pts=50, capacity=64,
                  device="cpu")
    a.train_iter(0)
    state = a.capture()
    b = GSTrainer(cams, GSTrainConfig(**CFG), num_pts=50, capacity=64, seed=5,
                  device="cpu")
    b.restore(state)
    la, lb = float(a.train_iter(1)["loss"]), float(b.train_iter(1)["loss"])
    assert la == lb
    for k in KEYS:
        assert torch.equal(a.params[k], b.params[k]), k


def test_densify_event_in_training():
    frames = _frames(n=4, res=32)
    cfg = dataclasses.replace(
        GSTrainConfig(**CFG), densify_from_iter=2, densification_interval=4,
        densify_until_iter=100, densify_grad_threshold=1e-6)
    tr = GSTrainer(orbit_cameras(4, resolution=32, images=frames), cfg,
                   num_pts=32, capacity=128, device="cpu")
    seen = []
    tr.train(8, log_every=1, log_fn=seen.append)
    events = [s for s in seen if "num_alive" in s]
    assert [s["iter"] for s in events] == [4, 8]
    assert int(tr.alive.sum()) > 32
    assert int(events[0]["alive_before"]) == 32
    assert all(np.isfinite(float(s["loss"])) for s in seen)


def test_ply_bytes_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    g = {"xyz": rs.randn(10, 3), "f_dc": rs.randn(10, 1, 3),
         "f_rest": rs.randn(10, 3, 3), "scaling": rs.randn(10, 3),
         "rotation": rs.randn(10, 4), "opacity": rs.randn(10, 1)}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    g["alive"] = np.arange(10) != 7
    jsave_ply(str(tmp_path / "jax.ply"), g)
    ply.save_ply(str(tmp_path / "port.ply"), g)
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()
    back = ply.load_ply(str(tmp_path / "port.ply"))
    for k in KEYS:
        np.testing.assert_array_equal(back[k], g[k][g["alive"]], err_msg=k)


def test_recon_cli_on_png_frames(tmp_path):
    from PIL import Image

    frames = (np.stack(_frames(n=4, res=32)) * 255).astype(np.uint8)
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(src / f"{i:02d}.png")
    np.testing.assert_array_equal(recon_gs.read_frames(str(src)), frames)
    out = tmp_path / "scene"
    recon_gs.main(["--frames", str(src), "--output", str(out), "--iterations", "3",
                   "--num-pts", "40", "--capacity", "64", "--test-every", "2",
                   "--device", "cpu"])
    assert ply.load_ply(str(out / "point_cloud.ply"))["xyz"].shape == (40, 3)
    orbit = np.load(out / "orbit.npy")
    assert orbit.shape == (4, 32, 32, 3) and orbit.dtype == np.uint8
    assert sorted(os.listdir(out)) == ["orbit.npy", "point_cloud.ply"]
