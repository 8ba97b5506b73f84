"""The port's posed-scene and remaining entry points against the JAX
package's, on the CPU: ``recon_scene`` (the 3DGS step and render at a
ragged non-square size, pinhole NeuS on per-frame directions),
``recon_neus_ortho`` (orthographic rays, per-view weights), ``imgs2poses``
against a fake colmap, ``serve`` with a gradio stub, ``full_eval``'s
metrics and ``validate_ckpt --all``'s report.

Tolerances: cameras, directions and rays exact (the same numpy code);
renders at 40 x 24 image / alpha atol 2e-5, depth 2e-4 (as
test_torch_gs_render.py); three GS steps' losses rel 1e-4 and the first
step's gradients max |port - JAX| <= 1e-4 max |JAX| per field (as
test_torch_gs_trainer.py); NeuS steps from the JAX keys' draws at C6's
tolerances (torch_neus_helpers.check_train_steps) but for two parameters
whose float32 gradient is ill-conditioned on both sides (ROADMAP C19),
held at 5e-2: the weight-normalised first layer's ``v`` where every
frequency is on from step 0 (recon_scene's recipe has no frequency mask:
port / JAX 1.8e-2 / 3.1e-2 of the largest entry from a float64 run of the
port with the learned background, 2.0e-3 / 3.9e-3 with the mask loss) and
the hash table of the ortho CPU recipe at step 3 (2.5e-2 / 3.4e-2);
``test_pinhole_neus_float32_is_near_float64`` holds the port's step to
float64 instead.  After Adam has taken that ``v`` gradient the two
trainers' states part (the sparsity term by 3.4% at the second step), so
the chained port trainer's losses are held on the first step only and the
stepwise trainer's (from the JAX state each step) on all three.  PSNR rel 1e-5 and SSIM atol 1e-5 (as
test_torch_gs_render.py); reports key for key, the JAX CLIP stage's own
fault (C18) aside.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v3d_tpu.apps import recon_scene as jrecon_scene
from v3d_tpu.data import scene_datasets as jsd
from v3d_tpu.data.cameras import get_ortho_ray_directions as jortho
from v3d_tpu.data.cameras import get_ray_directions as jdirs
from v3d_tpu.gs import losses as jlosses
from v3d_tpu.gs.trainer import GSTrainConfig as JConfig
from v3d_tpu.gs.trainer import GSTrainer as JTrainer
from v3d_tpu.nerf.occupancy import OccupancyGrid as JGrid
from v3d_tpu.nerf.system import NeusConfig as JNeusConfig
from v3d_tpu.nerf.system import NeusTrainer as JNeusTrainer
from v3d_tpu_torch.apps import full_eval, recon_neus_ortho, recon_scene
from v3d_tpu_torch.core.convert import trainer_state_from_jax
from v3d_tpu_torch.data import scene_datasets as sd
from v3d_tpu_torch.data.cameras import get_uniform_poses
from v3d_tpu_torch.gs import render
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
from v3d_tpu_torch.nerf.occupancy import OccupancyGrid
from v3d_tpu_torch.nerf.system import NeusConfig, NeusTrainer

from test_wonder3d import wonder3d_dir  # noqa: F401  (fixture)
from torch_neus_helpers import GRID, check_train_steps

torch.set_num_threads(1)
PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

W, H = 40, 24       # 3 x 2 tiles, the last column 8 and the last row 8 pixels


def _write_blender(root, n=4, masked=True):
    """n views at W x H of a soft blob on white, RGBA (alpha its silhouette)
    or RGB."""
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[:H, :W]
    poses = get_uniform_poses(n, 2.0, 0.0, opengl=True)
    frames = []
    for i in range(n):
        r2 = ((xx - W / 2 - 2 * i) / 9.0) ** 2 + ((yy - H / 2) / 6.0) ** 2
        a = (r2 < 1).astype(np.float32)
        rgb = np.stack([0.3 + 0.5 * (xx / W), 0.6 - 0.3 * (yy / H), 0.4 + 0 * xx], -1)
        img = np.concatenate([rgb * a[..., None] + (1 - a[..., None]), a[..., None]], -1)
        img = img if masked else img[..., :3]
        Image.fromarray((img * 255).round().astype(np.uint8)).save(
            os.path.join(root, f"r_{i}.png"))
        frames.append({"file_path": f"./r_{i}", "transform_matrix": poses[i].tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def _cams(tmp_path):
    _write_blender(str(tmp_path))
    port = recon_scene.scene_cameras(sd.load_blender_scene(str(tmp_path)))
    jax_ = jrecon_scene.scene_cameras(jsd.load_blender_scene(str(tmp_path)))
    for a, b in zip(port, jax_):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    assert (port[0].width, port[0].height) == (W, H)
    return port, jax_


# recon_scene's recipe (lambda_dssim 0.2, no resets, decay 0.995) at toy size
CFG = dict(densify_from_iter=10**6, opacity_reset_interval=10**6, lambda_dssim=0.2,
           opacity_reset_mode="none", opacity_decay=0.995, coarse_factor=2,
           max_per_coarse=128, tile_chunk=2, max_per_tile=64)


def _trainers(tmp_path):
    """The JAX GSTrainer on recon_scene's cameras at W x H, its init made
    anisotropic and rotated, and the port's in its state."""
    cams, jcams = _cams(tmp_path)
    jt = JTrainer(jcams, JConfig(**CFG), num_pts=300, capacity=360, seed=0, radius=1.0)
    port = GSTrainer(cams, GSTrainConfig(**CFG), num_pts=300, capacity=360, seed=0,
                     radius=1.0, device="cpu")
    state = jt.capture()
    rs = np.random.RandomState(1)
    params = dict(state["params"])
    params["scaling"] = params["scaling"] + jnp.asarray(
        0.3 * rs.randn(*params["scaling"].shape), jnp.float32)
    params["rotation"] = jnp.asarray(rs.randn(*params["rotation"].shape), jnp.float32)
    jt.restore({**state, "params": params})
    port.restore(trainer_state_from_jax(jt.capture()))
    return jt, port


def test_ragged_scene_render_matches_jax(tmp_path):
    jt, port = _trainers(tmp_path)
    for i in range(4):
        got, want = port.render_view(i), jt.render_view(i)
        assert got.image.shape == (H, W, 3)
        np.testing.assert_allclose(got.image.detach().numpy(), np.asarray(want.image),
                                   atol=2e-5)
        np.testing.assert_allclose(got.alpha.detach().numpy(), np.asarray(want.alpha),
                                   atol=2e-5)
        np.testing.assert_allclose(got.depth.detach().numpy(), np.asarray(want.depth),
                                   atol=2e-4)


def test_ragged_pixels_past_the_edge_take_no_gradient(tmp_path):
    """The compositor runs on whole 16 x 16 tiles; ``untile`` crops the
    padding, so the cotangent T11 receives is 0 exactly on every pixel past
    the image's edge and the slab gradient equals that of the padded render
    with those pixels' loss weights set to 0."""
    cams, _ = _cams(tmp_path)
    pt = GSTrainer(cams, GSTrainConfig(**CFG), num_pts=300, seed=0, radius=1.0,
                   device="cpu")
    g = render.Gaussians(alive=pt.alive, **{k: v.detach() for k, v in pt.params.items()})
    proj = render.project_gaussians(g, cams[0])
    s = render.build_slabs(proj, H, W, pt.raster)
    slab = s.slab.detach().requires_grad_(True)
    rgb, acc, dep = render.composite(slab, s.live_count, s.cell_of_tile, s.tile_xy,
                                     depth_chunk=64, tile_chunk=2)
    for x in (rgb, acc, dep):
        x.retain_grad()
    w = torch.linspace(0.5, 1.5, H * W * 3).reshape(H, W, 3)
    img = render.untile(rgb, s.n_tx, s.n_ty, H, W)
    loss = ((img * w).sum() + render.untile(acc, s.n_tx, s.n_ty, H, W).sum()
            + render.untile(dep, s.n_tx, s.n_ty, H, W).sum())
    loss.backward()
    pad = torch.ones(s.n_ty * 16, s.n_tx * 16, dtype=torch.bool)
    pad[:H, :W] = False
    tile_pad = pad.reshape(s.n_ty, 16, s.n_tx, 16).permute(0, 2, 1, 3).reshape(-1, 256)
    assert tile_pad.sum() == (s.n_ty * 16 * s.n_tx * 16 - H * W) > 0
    for x in (rgb, acc, dep):
        assert (x.grad[tile_pad] == 0).all()
        assert (x.grad[~tile_pad] != 0).any()
    # the same gradient from the padded image with 0 weights past the edge
    slab2 = s.slab.detach().requires_grad_(True)
    rgb2, acc2, dep2 = render.composite(slab2, s.live_count, s.cell_of_tile, s.tile_xy,
                                        depth_chunk=64, tile_chunk=2)
    wp = torch.zeros(s.n_ty * 16, s.n_tx * 16, 3)
    wp[:H, :W] = w
    wt = wp.reshape(s.n_ty, 16, s.n_tx, 16, 3).permute(0, 2, 1, 3, 4).reshape(-1, 256, 3)
    keep = (~tile_pad).float()
    ((rgb2 * wt).sum() + (acc2.reshape(keep.shape) * keep).sum()
     + (dep2.reshape(keep.shape) * keep).sum()
     ).backward()
    torch.testing.assert_close(slab2.grad, slab.grad, rtol=1e-6, atol=1e-7)


def test_ragged_gs_steps_match_jax(tmp_path):
    jt, port = _trainers(tmp_path)
    for step, cam in enumerate([0, 3, 1]):
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


def test_recon_scene_cli_runs_gs_and_neus(tmp_path):
    for masked in (True, False):
        root = str(tmp_path / f"scene{masked}")
        _write_blender(root, masked=masked)
        stats = []
        trainer = recon_scene.main(
            ["--scene", root, "--output", root + "/gs", "--iterations", "3",
             "--num-pts", "200", "--kc", "128", "--log-every", "1", "--device", "cpu"],
            log_fn=stats.append)
        assert len(stats) == 3 and trainer.images.shape == (4, H, W, 3)
        assert os.path.getsize(os.path.join(root, "gs", "point_cloud.ply")) > 0
        neus, mesh = recon_scene.main(
            ["--scene", root, "--output", root + "/neus", "--method", "neus",
             "--format", "videonvs", "--iterations", "2", "--rays", "16",
             "--mc-resolution", "12", "--device", "cpu"])
        assert neus.global_step == 2
        assert not neus.cfg.learned_background      # a blender scene always has masks
        assert neus.cfg.num_samples_per_ray == 1024 and neus.cfg.coarse_to_fine_samples == 0
    cfg = recon_scene.neus_scene_config("cuda", 300, 256, masked=True)
    assert (cfg.num_samples_per_ray, cfg.coarse_to_fine_samples, cfg.ray_chunk) == (256, 64, 128)
    with pytest.raises(SystemExit):
        recon_scene.main(["--scene", root, "--output", root, "--format", "nope"])


def _jax_run_neus_dirs(scene):
    """The directions v3d_tpu/apps/recon_scene.py run_neus builds (:82-91)."""
    h, w = scene.images.shape[1:3]
    Ks = scene.intrinsics
    if np.allclose(Ks, Ks[:1], atol=1e-4):
        return jdirs(h, w, float(Ks[0][0, 0]), (float(Ks[0][0, 2]), float(Ks[0][1, 2])))
    return np.stack([jdirs(h, w, float(K[0, 0]), (float(K[0, 2]), float(K[1, 2])))
                     for K in Ks])


def _tiny(cfg, **kw):
    """A recipe's NeusConfig at toy widths, as a dict both packages take."""
    small = dict(geo_neurons=16, n_frequencies=4, n_levels=4, base_resolution=4,
                 per_level_scale=2.0, start_level=2, update_steps=1,
                 max_steps=8, constant_steps=1, cos_anneal_end=4)
    out = dataclasses.asdict(cfg)
    out.update(small, **kw)
    if out["freq_masking_steps"]:
        out["freq_masking_steps"] = 4
    return out


def _neus_trainers(images, fg, dirs, poses, kw, **extra):
    """The JAX trainer and two port trainers in its state (the occupancy
    grid of torch_neus_helpers.GRID on both sides)."""
    jt = JNeusTrainer(images, fg, dirs, poses, config=JNeusConfig(**kw), seed=0, **extra)
    jt.occ = JGrid(occ_threshold=jt.cfg.grid_prune_occ_thre, **GRID)
    ports = []
    for _ in range(2):
        pt = NeusTrainer(images, fg, dirs, poses, config=NeusConfig(**kw), seed=0,
                         device="cpu", **extra)
        pt.occ = OccupancyGrid(occ_threshold=pt.cfg.grid_prune_occ_thre, device="cpu", **GRID)
        pt.restore(trainer_state_from_jax(jt.capture()))
        ports.append(pt)
    return jt, *ports


@pytest.mark.parametrize("masked", [True, False])
def test_pinhole_neus_per_frame_directions_match_jax(tmp_path, masked):
    """A DTU-like scene (per-frame K) through ``neus_directions`` and three
    steps of recon_scene's recipe (the card's sample counts shrunk; the mask
    loss, or the learned background where there is no mask)."""
    scene = sd.SceneFrames(*[np.asarray(x) for x in (
        np.random.RandomState(2).rand(3, 12, 16, 3).astype(np.float32),
        get_uniform_poses(3, 2.0, 0.0, opengl=True),
        np.stack([np.array([[14.0 + i, 0, 8.5 - i], [0, 14.0 + i, 6.0], [0, 0, 1]],
                           np.float32) for i in range(3)]))],
        fg_masks=np.ones((3, 12, 16), np.float32) if masked else None)
    dirs = recon_scene.neus_directions(scene)
    assert dirs.shape == (3, 12, 16, 3)
    np.testing.assert_array_equal(dirs, _jax_run_neus_dirs(scene))
    shared = dataclasses.replace(scene, intrinsics=np.repeat(scene.intrinsics[:1], 3, 0))
    np.testing.assert_array_equal(recon_scene.neus_directions(shared),
                                  _jax_run_neus_dirs(shared))
    kw = _tiny(recon_scene.neus_scene_config("cuda", 8, 32, masked),
               num_samples_per_ray=16, coarse_to_fine_samples=16, ray_chunk=16,
               num_samples_per_ray_bg=8)
    fg = scene.fg_masks if masked else np.ones((3, 12, 16), np.float32)
    check_train_steps(None, _neus_trainers(scene.images, fg, dirs, scene.c2ws, kw),
                      rel_of={("geometry", "network.layers.0.v"): 5e-2}, chained_steps=1)


def test_pinhole_neus_float32_is_near_float64():
    """The port's first step of the per-frame scene above (learned
    background) in float32 against the same step in float64: every
    gradient within 1e-4 of its largest entry, the first layer's ``v``
    (C19) within 3e-2."""
    from torch_neus_helpers import jax_draws

    scene_imgs = np.random.RandomState(2).rand(3, 12, 16, 3).astype(np.float32)
    Ks = np.stack([np.array([[14.0 + i, 0, 8.5 - i], [0, 14.0 + i, 6.0], [0, 0, 1]])
                   for i in range(3)])
    dirs = np.stack([jdirs(12, 16, K[0, 0], (K[0, 2], K[1, 2])) for K in Ks])
    kw = _tiny(recon_scene.neus_scene_config("cuda", 8, 32, False), num_samples_per_ray=16,
               coarse_to_fine_samples=16, ray_chunk=16, num_samples_per_ray_bg=8)
    jt, p32, p64 = _neus_trainers(scene_imgs, np.ones((3, 12, 16), np.float32), dirs,
                                  get_uniform_poses(3, 2.0, 0.0, opengl=True), kw)
    draws, _ = jax_draws(jt, jt._quantized_rays())
    for m in p64.modules.values():
        m.double()
    for k in ("images", "fg_masks", "directions", "c2ws"):
        setattr(p64, k, getattr(p64, k).double())
    p32.compute_grads(draws)
    p64.compute_grads(draws._replace(**{k: getattr(draws, k).double() for k in (
        "jitter", "rand_pts", "perturb", "bg_jitter")}))
    for group, mod in p32.modules.items():
        want = dict(p64.modules[group].named_parameters())
        for name, p in mod.named_parameters():
            g64 = want[name].grad.numpy()
            rel = 3e-2 if (group, name) == ("geometry", "network.layers.0.v") else 1e-4
            err = np.abs(p.grad.numpy() - g64).max()
            assert err <= rel * np.abs(g64).max() + 1e-12, (group, name, err)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_ortho_neus_steps_match_jax(wonder3d_dir, device):  # noqa: F811
    """recon_neus_ortho's trainer (its recipe for ``device``: the card's or
    the CPU's, at toy widths, built here on the CPU) on Wonder3D views
    against the JAX trainer built as v3d_tpu/apps/recon_neus_ortho.py
    builds it: orthographic origins, OpenGL c2ws, world normals, per-view
    weights."""
    from v3d_tpu_torch.data.wonder3d import load_wonder3d_views

    views = load_wonder3d_views(wonder3d_dir, "owl", im_size=16)
    kw = _tiny(recon_neus_ortho.ortho_config(device, max_steps=8),
               num_samples_per_ray=16, train_num_rays=32, ray_chunk=16 if device == "cuda" else 0)
    port = recon_neus_ortho.ortho_trainer(views, 16, NeusConfig(**kw), device="cpu")
    origins, dirs = jortho(16, 16)
    np.testing.assert_array_equal(port.origins.numpy(), origins)
    np.testing.assert_array_equal(port.directions.numpy(), dirs)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    c2ws[:, :3, :4] = views["c2ws"]
    c2ws[:, :, 1:3] *= -1
    np.testing.assert_array_equal(port.c2ws.numpy(), c2ws)
    np.testing.assert_array_equal(port.view_weights.numpy(), views["view_weights"])
    check_train_steps(None, _neus_trainers(
        views["images"], views["masks"], dirs, c2ws, kw, normals=views["normals_world"],
        origins=origins, view_weights=views["view_weights"]),
        rel_of={("geometry", "encoding.table"): 5e-2})


def test_reconstruct_ortho_writes_a_coloured_mesh(wonder3d_dir, tmp_path):  # noqa: F811
    trainer, mesh = recon_neus_ortho.reconstruct_ortho(
        wonder3d_dir, "owl", str(tmp_path / "out"), max_steps=4, im_size=16,
        num_samples=16, train_num_rays=16, mc_resolution=12, log_every=2,
        device="cpu", config_overrides=dict(n_levels=2))
    assert trainer.global_step == 4 and trainer.view_weights is not None
    if len(mesh.vertices):
        assert mesh.vertex_colors.shape == mesh.vertices.shape
        text = open(tmp_path / "out" / "mesh.obj").read()
        assert text.startswith("v ") and len(text.splitlines()[0].split()) == 7


# ---------------------------------------------------------------------------
# imgs2poses


def test_imgs2poses_against_fake_colmap(tmp_path, monkeypatch):
    from test_imgs2poses import FAKE_COLMAP, _scene

    from v3d_tpu.apps import imgs2poses as jimgs2poses
    from v3d_tpu_torch.apps import imgs2poses

    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "colmap").write_text(FAKE_COLMAP)
    (bindir / "colmap").chmod(0o755)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_LOG", str(log))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    scene, jscene = _scene(tmp_path / "a"), _scene(tmp_path / "b")
    assert imgs2poses.gen_poses(str(scene)) == jimgs2poses.gen_poses(str(jscene)) == {
        "cameras": 1, "images": 2, "points3d": 0}
    calls = log.read_text().strip().splitlines()
    assert len(calls) == 6
    assert [c.replace(str(scene), "S") for c in calls[:3]] == [
        c.replace(str(jscene), "S") for c in calls[3:]]
    imgs2poses.gen_poses(str(scene))      # a model is there: colmap is not run again
    assert len(log.read_text().strip().splitlines()) == 6
    assert sd.load_colmap_scene(str(scene)).num_frames == 2
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))}
    (tmp_path / "c").mkdir()
    seq = _scene(tmp_path / "c")
    rc = subprocess.run([sys.executable, "-m", "v3d_tpu_torch.apps.imgs2poses", str(seq),
                         "--match-type", "sequential_matcher"], capture_output=True,
                        text=True, env=env)
    assert rc.returncode == 0, rc.stderr
    assert "sequential_matcher" in log.read_text()
    monkeypatch.setenv("PATH", str(tmp_path))      # no colmap anywhere
    (tmp_path / "d").mkdir()
    bare = _scene(tmp_path / "d")
    assert imgs2poses.main([str(bare)]) == 1
    with pytest.raises(FileNotFoundError, match="COLMAP") as port_err:
        imgs2poses.gen_poses(str(bare))
    with pytest.raises(FileNotFoundError) as jax_err:
        jimgs2poses.gen_poses(str(bare))
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# serve


def test_serve_wires_generate_and_keeps_the_engine(monkeypatch, tmp_path):
    from test_serve import _install_gradio_stub

    from v3d_tpu_torch.apps import generate, serve
    from v3d_tpu_torch.data import video_io

    registry, calls = {}, []
    _install_gradio_stub(registry)
    try:
        def fake_sample_one(image, **kw):
            calls.append((image.shape, kw))
            return np.zeros((2, 8, 8, 3), np.uint8), "ENGINE", {}

        monkeypatch.setattr(generate, "sample_one", fake_sample_one)
        written = []
        monkeypatch.setattr(video_io, "write_video",
                            lambda path, frames, fps=3: written.append((path, fps)))
        Image.fromarray(np.zeros((10, 12, 4), np.uint8)).save(tmp_path / "img.png")
        demo = serve.build_demo(checkpoint="ckpt.safetensors", device="cpu")
        assert demo is not None and registry["n_inputs"] == 6
        out = registry["fn"](str(tmp_path / "img.png"), 0.3, 3.5, 4.0, 6.0, 23.0)
        registry["fn"](str(tmp_path / "img.png"), 0.2, 3.0, 3.0, 2, 7)
        assert [w[0] for w in written][0] == out and out.endswith(".mp4")
        assert written[0][1] == 3
        shape, kw = calls[0]
        assert shape == (10, 12, 4)
        assert kw == dict(engine=None, checkpoint="ckpt.safetensors", border_ratio=0.3,
                          min_guidance_scale=3.5, max_guidance_scale=4.0, decoding_t=6,
                          seed=23, device="cpu")
        assert calls[1][1]["engine"] == "ENGINE" and calls[1][1]["seed"] == 7
        for path, _ in written:
            os.remove(path)
    finally:
        sys.modules.pop("gradio", None)
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        serve.build_demo()
    from v3d_tpu.apps import serve as jserve

    with pytest.raises(ImportError, match="gradio"):
        jserve.build_demo()


# ---------------------------------------------------------------------------
# full_eval


def test_full_eval_scores_match_jax_metrics(tmp_path):
    rs = np.random.RandomState(3)
    renders = torch.tensor(rs.rand(3, 20, 28, 3), dtype=torch.float32)
    frames = np.clip(renders.numpy() + 0.05 * rs.randn(3, 20, 28, 3), 0, 1).astype(np.float32)
    got = full_eval.score_views(renders, frames)
    want_p = np.mean([float(jlosses.psnr(jnp.asarray(r.numpy()), jnp.asarray(f)))
                      for r, f in zip(renders, frames)])
    want_s = np.mean([float(jlosses.ssim(jnp.asarray(r.numpy()), jnp.asarray(f)))
                      for r, f in zip(renders, frames)])
    np.testing.assert_allclose(got["psnr"], want_p, rtol=1e-5)
    np.testing.assert_allclose(got["ssim"], want_s, rtol=0, atol=1e-5)


def test_full_eval_runs_on_mp4_orbits(tmp_path):
    from v3d_tpu.data.video_io import read_video as jread_video
    from v3d_tpu_torch.data.video_io import write_video

    rs = np.random.RandomState(4)
    videos = []
    for name in ("a", "b"):
        videos.append(str(tmp_path / f"{name}.mp4"))
        write_video(videos[-1], rs.rand(4, 32, 32, 3))
    results = full_eval.run(videos, str(tmp_path / "eval"), iterations=2, device="cpu",
                            num_pts=40, capacity=64)
    with open(tmp_path / "eval" / "results.json") as f:
        assert json.load(f) == results
    assert sorted(results) == ["a", "b"]
    for name in ("a", "b"):
        spiral = jread_video(str(tmp_path / "eval" / name / "spiral.mp4"))
        assert spiral.shape == (4, 32, 32, 3)
        assert all(np.isfinite(results[name][k]) for k in ("psnr", "ssim"))


# ---------------------------------------------------------------------------
# validate_ckpt --all


def _tiny_clip_npz(path, bad=False):
    from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer

    m = CLIPVisionTransformer(width=32, layers=2, heads=2, patch_size=8, image_size=32,
                              output_dim=16)
    gen = torch.Generator().manual_seed(0)
    sd_ = {k: torch.randn(v.shape, generator=gen).numpy() for k, v in m.state_dict().items()}
    if bad:
        sd_["not_a_clip_key"] = np.zeros(1, np.float32)
    np.savez(path, **sd_)
    return sum(v.size for v in sd_.values())


def _weights_dir(root, bad_clip=False):
    import chip_smoke
    from v3d_tpu_torch.models.u2net import U2Net

    os.makedirs(root)
    chip_smoke.write_seeded_lpips(os.path.join(root, "lpips_vgg.npz"), seed=3)
    torch.manual_seed(0)
    torch.save(U2Net(small=True).state_dict(), os.path.join(root, "u2netp.pth"))
    return _tiny_clip_npz(os.path.join(root, "open_clip_tiny.npz"), bad=bad_clip)


@pytest.mark.parametrize("bad_clip", [False, True])
def test_validate_ckpt_all_report_matches_jax(tmp_path, bad_clip):
    from v3d_tpu.apps import validate_ckpt as jvalidate
    from v3d_tpu_torch.apps import validate_ckpt

    d = str(tmp_path / "w")
    n_clip = _weights_dir(d, bad_clip)
    got = validate_ckpt.check_all(d, str(tmp_path / "port.json"), device="cpu")
    want = jvalidate.check_all(d, str(tmp_path / "jax.json"), refpoint_fit=False)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert sorted(got) == sorted(want) == ["dir", "ok", "plan", "stages", "wall_s"]
    assert sorted(got["stages"]) == sorted(want["stages"]) == [
        "clip_ingest", "lpips_ingest", "u2net_ingest"]
    # C18: the JAX harness hands convert_clip_visual the .npz's numpy arrays,
    # and its t2j calls .detach() on them; the port reads every key
    assert not want["stages"]["clip_ingest"]["ok"]
    assert "detach" in want["stages"]["clip_ingest"]["error"]
    for name, stage in want["stages"].items():
        if name != "clip_ingest":
            assert got["stages"][name] == {**stage, "s": got["stages"][name]["s"]}, name
    assert got["stages"]["clip_ingest"]["ok"] == (not bad_clip)
    assert got["ok"] == (not bad_clip) and not want["ok"]
    assert [(p["artifact"], p["looked_for"]) for p in got["plan"]] == [
        (p["artifact"], p["looked_for"]) for p in want["plan"]]
    assert all(sorted(p) == ["artifact", "command", "gate", "looked_for"] for p in got["plan"])
    if not bad_clip:
        assert got["stages"]["clip_ingest"]["detail"] == f"{n_clip / 1e6:.1f}M clip params"
    with pytest.raises(SystemExit) as e:
        validate_ckpt.main(["--all", d, "--report", str(tmp_path / "r.json"), "--device", "cpu"])
    assert e.value.code == (1 if bad_clip else 0)


def test_validate_ckpt_all_empty_dir_and_conversion(tmp_path):
    from v3d_tpu.apps import validate_ckpt as jvalidate
    from v3d_tpu_torch.apps import validate_ckpt
    from v3d_tpu_torch.core.checkpoint import save_v3d_checkpoint
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit) as e:
        validate_ckpt.main(["--all", empty, "--report", str(tmp_path / "e.json")])
    assert e.value.code == 0
    got = json.load(open(tmp_path / "e.json"))
    want = jvalidate.check_all(empty, str(tmp_path / "je.json"), refpoint_fit=False)
    assert got["ok"] and not got["stages"] and len(got["plan"]) == 5
    assert [p["artifact"] for p in got["plan"]] == [p["artifact"] for p in want["plan"]]
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    engine = build_tiny_engine(num_frames=4, device="cpu")
    save_v3d_checkpoint(engine, os.path.join(d, "tiny.ckpt"))
    rep = validate_ckpt.check_all(d, str(tmp_path / "c.json"), device="cpu",
                                  engine=build_tiny_engine(num_frames=4, device="cpu"))
    assert rep["ok"] and rep["stages"]["conversion"]["detail"] == "converted"
    assert len(rep["plan"]) == 4
