"""The port stands alone: in a fresh interpreter, importing every module of
v3d_tpu_torch (found by walking the package) and chip_smoke, and running a
tiny generation, a tiny 3DGS fit and a tiny fine-tune step on the CPU, or
the attention routes under every routing setting, or a tiny NeuS
reconstruction, a tiny ``full_asset --mesh`` and a tiny ``--checkpoint``
load, or the refine CLI, a tiny 3DGS -> mesh distillation and the DPT
loader, or the five other samplers, img2img, the U2Net matte in
preprocess_image, the safety filter and a tiny recon_gs_iterative,
loads neither jax, jaxlib, flax nor v3d_tpu.  chip_smoke.py refuses to run, printing no result, without
a CUDA device or outside a checkout of the repository."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys, tempfile
import numpy as np
import chip_smoke
import v3d_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(v3d_tpu_torch.__path__, "v3d_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
print("MODULES", len(mods))

from v3d_tpu_torch.apps.generate import sample_one
from v3d_tpu_torch.apps.recon_gs import train_from_frames
from v3d_tpu_torch.engines.builder import build_tiny_engine

img = chip_smoke.synthetic_image(96)
frames, _, timings = sample_one(
    img, engine=build_tiny_engine(num_frames=4, num_steps=2, device="cpu"),
    resolution=64)
assert frames.shape == (4, 64, 64, 3) and frames.dtype == np.uint8, frames.shape
with tempfile.TemporaryDirectory() as out:
    trainer = train_from_frames(frames[:, :32, :32], out, iterations=3, num_pts=40,
                                capacity=64, test_every=2, device="cpu",
                                config_overrides=dict(densify_from_iter=1,
                                                      densification_interval=2))
assert trainer.step_count == 3
from v3d_tpu_torch.apps.train_diffusion import batches
from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
from v3d_tpu_torch.engines.trainer import DiffusionTrainer
eng = build_tiny_engine(num_frames=4, device="cpu", unet_overrides=dict(use_checkpoint=True))
tuned = DiffusionTrainer(eng, num_frames=4)
tuned.fit(batches(eng, SyntheticOrbitDataset(2, 4, 8, clip_dim=64), 1, 4), max_steps=1,
          log_fn=lambda s: None)
assert tuned.step == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "v3d_tpu"))
print("FOREIGN", bad)
"""


_ROUTES_PROBE = r"""
import sys
import torch
import chip_smoke
from v3d_tpu_torch.apps.generate import sample_one
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.ops import attention as A, flash_attention as F, temporal_attention as T

q = torch.randn(2, 128, 2, 64)
for name, layout, backend, override in chip_smoke.ROUTE_CONFIGS:
    with chip_smoke.routing(layout, backend, override):
        outs = [A.attention(q, q, q), A.attention_bhsd(*(x.transpose(1, 2) for x in (q, q, q))
                                                       ).transpose(1, 2)]
        assert all(torch.allclose(o, outs[0], atol=1e-5) for o in outs), name
for fn in (F.flash_attention, F.flash_attention_packed, A.jax_flash_attention):
    assert torch.allclose(fn(q, q, q), A.xla_attention(q, q, q), atol=1e-5)
x = torch.randn(4, 18, 3, 16)
assert torch.allclose(T.temporal_attention(x, x, x), T.temporal_attention_mxu(x, x, x))
with chip_smoke.routing(backend="flash"):
    frames, _, _ = sample_one(chip_smoke.synthetic_image(96), resolution=64,
                              engine=build_tiny_engine(num_frames=4, num_steps=1, device="cpu"))
assert frames.shape == (4, 64, 64, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "v3d_tpu"))
print("FOREIGN", bad)
"""


_SLICE3_PROBE = r"""
import os, sys, tempfile
import numpy as np
from PIL import Image
import chip_smoke
from v3d_tpu_torch.apps import full_asset, generate
from v3d_tpu_torch.apps.recon_neus import reconstruct
from v3d_tpu_torch.core.checkpoint import save_v3d_checkpoint
from v3d_tpu_torch.engines.builder import build_tiny_engine

res = 24
yy, xx = np.mgrid[:res, :res]
ball = (yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (res / 4) ** 2
frames = np.where(ball[None, ..., None], 0.3, 1.0).repeat(6, 0).repeat(3, -1)
tiny_neus = dict(num_samples=32, train_num_rays=32,
                 config_overrides=dict(n_levels=2, grid_prune=False))
with tempfile.TemporaryDirectory() as out:
    trainer, mesh, timings = reconstruct(frames, out, max_steps=4, mc_resolution=16,
                                         device="cpu", log_every=2, **tiny_neus)
    assert trainer.global_step == 4 and "export_s" in timings
    if len(mesh.vertices):
        assert os.path.getsize(os.path.join(out, "mesh.glb")) > 0
    report = full_asset.run(
        chip_smoke.synthetic_image(96), os.path.join(out, "assets"), gs_iters=3,
        neus_steps=4, mesh=True, num_steps=2, mc_resolution=16, assets=2,
        device="cpu", engine=build_tiny_engine(num_frames=4, num_steps=2, device="cpu"),
        resolution=64, gs_kwargs=dict(num_pts=40, capacity=64, test_every=2),
        neus_kwargs=tiny_neus)
    assert len(report["assets"]) == 2 and "neus_fit_mesh" in report["assets"][1]
    assert os.path.exists(os.path.join(out, "assets", "full_asset.json"))
    eng = build_tiny_engine(num_frames=4, num_steps=1, device="cpu")
    save_v3d_checkpoint(eng, os.path.join(out, "tiny.ckpt"))
    Image.fromarray(chip_smoke.synthetic_image(48)).save(os.path.join(out, "in.png"))
    generate.main(["--input", os.path.join(out, "in.png"), "--checkpoint",
                   os.path.join(out, "tiny.ckpt"), "--tiny", "--num-frames", "4",
                   "--num-steps", "1", "--resolution", "64", "--decoding-t", "4",
                   "--device", "cpu", "--output-folder", os.path.join(out, "gen")])
    assert len(os.listdir(os.path.join(out, "gen", "000000"))) == 4
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "v3d_tpu"))
print("FOREIGN", bad)
"""


_MESH_PROBE = r"""
import os, sys, tempfile
import numpy as np
import torch
from v3d_tpu_torch.apps import gs_to_mesh, recon_neus, refine
from v3d_tpu_torch.gs.ply import save_ply
from v3d_tpu_torch.meshops.mcubes import isosurface
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.models.dpt import DPT
from v3d_tpu_torch.nerf.normals import load_dpt_normal_predictor

rs = np.random.RandomState(0)
with tempfile.TemporaryDirectory() as out:
    v, f = isosurface(lambda p: np.linalg.norm(p, axis=-1) - 0.6, radius=1.0,
                      resolution=12, coarse_resolution=8)
    Mesh(v, f).write_obj(os.path.join(out, "m.obj"))
    np.save(os.path.join(out, "f.npy"), np.full((2, 32, 32, 3), 200, np.uint8))
    refine.main(["--mesh", os.path.join(out, "m.obj"), "--video",
                 os.path.join(out, "f.npy"), "--output", os.path.join(out, "r"),
                 "--iters", "2", "--num-opt-views", "2", "--device", "cpu"])
    assert Mesh(v, f).auto_uv().uvs is not None
    n = 64
    save_ply(os.path.join(out, "g.ply"), dict(
        xyz=rs.randn(n, 3).astype(np.float32) * 0.3, f_dc=rs.rand(n, 1, 3).astype(np.float32),
        f_rest=np.zeros((n, 0, 3), np.float32), opacity=np.ones((n, 1), np.float32),
        scaling=np.full((n, 3), -2.5, np.float32), rotation=rs.randn(n, 4).astype(np.float32),
        alive=np.ones(n, bool)))
    mesh, timings = gs_to_mesh.distill(os.path.join(out, "g.ply"), os.path.join(out, "d"),
                                       n_views=2, fit_steps=1, rays_per_step=32,
                                       resolution=16, mc_resolution=8, refine_iters=1,
                                       device="cpu")
    assert "fit_s" in timings
    sd = DPT().init_(torch.Generator().manual_seed(0)).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}},
               os.path.join(out, "dpt.ckpt"))
    predict = load_dpt_normal_predictor(os.path.join(out, "dpt.ckpt"), infer_size=64,
                                        device="cpu")
    assert predict(np.full((1, 48, 48, 3), 0.5, np.float32)).shape == (1, 48, 48, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "v3d_tpu"))
print("FOREIGN", bad)
"""


_GENERATION_PROBE = r"""
import os, sys, tempfile
import numpy as np
import torch
from PIL import Image
import chip_smoke
from v3d_tpu_torch import diffusion as D
from v3d_tpu_torch.apps import generate, recon_gs_iterative
from v3d_tpu_torch.data import preprocess
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.video_diffusion import img2img_latents
from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer
from v3d_tpu_torch.models.u2net import U2Net
from v3d_tpu_torch.utils import safety

x = torch.randn(2, 4, 4, 4)
for cls in (D.HeunEDMSampler, D.EulerAncestralSampler, D.DPMPP2SAncestralSampler,
            D.DPMPP2MSampler, D.LinearMultistepSampler):
    out = cls(discretization=D.EDMDiscretization(), num_steps=3)(
        lambda xx, s, c: xx / (1 + s[:, None, None, None] ** 2), x, {},
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all(), cls
eng = build_tiny_engine(num_frames=4, num_steps=4, device="cpu")
frames, _, _ = generate.sample_one(chip_smoke.synthetic_image(96), engine=eng, resolution=64)
z = eng.encode_first_stage(torch.from_numpy(frames / 127.5 - 1).float(),
                           generator=torch.Generator().manual_seed(1))
c, uc = eng.build_cond(torch.randn(1, 1, 64), z[:1], 1, 300, 0.02)
assert img2img_latents(eng, z, c, uc, 0.5, generator=torch.Generator().manual_seed(2)).shape == z.shape
with tempfile.TemporaryDirectory() as out:
    torch.save(U2Net(small=True).state_dict(), os.path.join(out, "u2netp.pth"))
    os.environ["V3D_U2NET_CKPT"] = os.path.join(out, "u2netp.pth")
    img = preprocess.preprocess_image(chip_smoke.synthetic_image(64)[..., :3], resolution=32,
                                      device="cpu")
    assert preprocess.default_remove_bg("cpu").kind == "u2net" and img.shape == (32, 32, 3)
    clip = CLIPVisionTransformer(width=32, layers=1, heads=2, patch_size=14, output_dim=8)
    torch.nn.init.normal_(clip.proj)
    np.savez(os.path.join(out, "p_head_v1.npz"), weights=np.ones(8, np.float32), biases=np.float32(0))
    filt = safety.DeepFloydDataFiltering(head_dir=out, clip=clip)
    assert filt(np.full((2, 28, 28, 3), 0.5, np.float32)).shape == (2, 28, 28, 3)
    wm = safety.embed_watermark(np.full((1, 64, 64, 3), 0.5))
    assert list(safety.extract_watermark(wm).astype(int)) == safety.WATERMARK_BITS
    Image.fromarray(frames[0]).save(os.path.join(out, "in.png"))
    recon_gs_iterative.sample_one = lambda *a, **k: (frames, eng, {})
    trainer, timings = recon_gs_iterative.train_iterative(
        os.path.join(out, "in.png"), os.path.join(out, "it"), iterations=4,
        resample_period=2, resample_start=1, num_pts=40, device="cpu")
    assert len(timings["resample_s"]) == 1
    assert os.path.getsize(os.path.join(out, "it", "point_cloud.ply")) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "v3d_tpu"))
print("FOREIGN", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_path_imports_no_jax_and_generates_on_cpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 50, out.stdout


def test_attention_routes_run_without_jax():
    """Every routing of chip_smoke.ROUTE_CONFIGS through ``attention`` /
    ``attention_bhsd``, the T2-T6 entry points, and a tiny generation under
    "flash", on the CPU with no jax loaded."""
    out = subprocess.run([sys.executable, "-c", _ROUTES_PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_neus_full_asset_and_checkpoint_run_without_jax():
    out = subprocess.run([sys.executable, "-c", _SLICE3_PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def _last_json(stdout: str):
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def test_chip_smoke_refuses_without_cuda(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    # alone in a directory, without the package beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


def test_refine_gs_to_mesh_and_dpt_run_without_jax():
    """The refine CLI, ``auto_uv``, a tiny ``gs_to_mesh.distill`` and the
    DPT loader on a seeded .ckpt, in a fresh interpreter with no jax."""
    out = subprocess.run([sys.executable, "-c", _MESH_PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_generation_entry_points_run_without_jax():
    """The five samplers beside Euler, img2img, ``preprocess_image`` with a
    U2Net matte, the safety filter and watermark, and a tiny
    ``recon_gs_iterative``, in a fresh interpreter with no jax."""
    out = subprocess.run([sys.executable, "-c", _GENERATION_PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout
