"""The port stands alone: in a fresh interpreter, importing every module of
v3d_tpu_torch (found by walking the package) and chip_smoke, and running a
tiny generation and a tiny 3DGS fit on the CPU, loads neither jax, jaxlib,
flax nor v3d_tpu.  chip_smoke.py refuses to run, printing no result, without
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
    assert n_modules >= 40, out.stdout


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
