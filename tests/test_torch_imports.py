"""The port stands alone: in a fresh interpreter, importing every module of
v3d_tpu_torch (found by walking the package) and chip_smoke, and running a
tiny generation, a tiny 3DGS fit and a tiny fine-tune step on the CPU, or
the attention routes under every routing setting, or a tiny NeuS
reconstruction, a tiny ``full_asset --mesh`` and a tiny ``--checkpoint``
load, loads neither jax, jaxlib, flax nor v3d_tpu.  chip_smoke.py refuses to run, printing no result, without
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
