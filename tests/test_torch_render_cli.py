"""The port's scene CLIs and their helpers against the JAX package's, on the
CPU: ``data/cam_paths.py`` (max abs 1e-12: the same numpy code),
``utils/colormaps.py`` (exact), ``apps/render_cli.py`` on one PLY (54
spiral frames from ``--num-frames 60``, and depth mode: rgb max abs <= 1e-4,
depth <= 2e-4 as tests/test_torch_gs_render.py; the JAX CLI's float
renders are taken from its ``render`` calls, its mp4 writer stubbed),
``export_blender_cameras`` (the same JSON), ``apps/metrics_cli.py`` on PNG
directories the test writes (PSNR / SSIM / LPIPS within 1e-5, relative)
and ``apps/validate_ckpt.py --lpips / --dpt`` on weights the test writes."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from v3d_tpu.apps import metrics_cli as jmetrics
from v3d_tpu.apps import render_cli as jrender_cli
from v3d_tpu.data import cam_paths as jcp
from v3d_tpu.data import cameras as jcams
from v3d_tpu.gs import render as jrender
from v3d_tpu.utils import colormaps as jcm
from v3d_tpu_torch.apps import metrics_cli, render_cli, validate_ckpt
from v3d_tpu_torch.data import cam_paths as cp
from v3d_tpu_torch.gs.ply import save_ply
from v3d_tpu_torch.models.dpt import DPT
from v3d_tpu_torch.utils import colormaps as cm


def _poses(n=18, seed=0):
    rs = np.random.RandomState(seed)
    poses = jcams.get_uniform_poses(n, 2.0, 15.0)
    poses[:, :3, 3] += 0.1 * rs.randn(n, 3)
    return poses


@pytest.mark.parametrize("method,center", [("up", "poses"), ("up", "focus"),
                                           ("none", "none")])
def test_auto_orient_and_center_matches_jax(method, center):
    poses = _poses(seed=1)
    (a, ta), (b, tb) = (cp.auto_orient_and_center_poses(poses, method, center),
                        jcp.auto_orient_and_center_poses(poses, method, center))
    assert np.abs(a - b).max() <= 1e-12 and np.abs(ta - tb).max() <= 1e-12


def test_cam_paths_match_jax():
    poses = _poses()
    rs = np.random.RandomState(2)
    for _ in range(8):   # both quaternion branches (trace > 0 and not)
        q = rs.randn(4)
        R = cp.matrix_from_quat(q)
        assert np.abs(R - jcp.matrix_from_quat(q)).max() <= 1e-12
        assert np.abs(cp.quat_from_matrix(R) - jcp.quat_from_matrix(R)).max() <= 1e-12
    q0, q1 = rs.randn(4), rs.randn(4)
    for t in (0.0, 0.3, 1.0):
        assert np.abs(cp.slerp(q0, q1, t) - jcp.slerp(q0, q1, t)).max() <= 1e-12
        assert np.abs(cp.slerp(q0, q0 + 1e-5, t) - jcp.slerp(q0, q0 + 1e-5, t)).max() <= 1e-12
    for closed in (True, False):
        a = cp.get_interpolated_path(poses, 3, closed)
        assert a.shape == ((18 if closed else 17) * 3, 4, 4)
        assert np.abs(a - jcp.get_interpolated_path(poses, 3, closed)).max() <= 1e-12
    a, sa = cp.normalize_scene_poses(poses, 1.5)
    b, sb = jcp.normalize_scene_poses(poses, 1.5)
    assert np.abs(a - b).max() <= 1e-12 and sa == sb


def test_colormaps_match_jax_exactly():
    rs = np.random.RandomState(3)
    depth = rs.rand(17, 23).astype(np.float32) * 3 + 1
    acc = rs.rand(17, 23).astype(np.float32)
    x = np.linspace(-0.2, 1.2, 101)
    assert np.array_equal(cm.turbo(x), jcm.turbo(x))
    assert np.array_equal(cm.gray(x), jcm.gray(x))
    for kw in (dict(), dict(accumulation=acc), dict(near_plane=1.5, far_plane=3.0),
               dict(colormap="gray"), dict(colormap="default", accumulation=acc)):
        assert np.array_equal(cm.apply_depth_colormap(depth, **kw),
                              jcm.apply_depth_colormap(depth, **kw)), kw


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    rs = np.random.RandomState(0)
    n = 300
    path = str(tmp_path_factory.mktemp("scene") / "point_cloud.ply")
    save_ply(path, dict(
        xyz=(rs.randn(n, 3) * 0.35).astype(np.float32),
        f_dc=(rs.randn(n, 1, 3) * 0.8).astype(np.float32),
        f_rest=(0.1 * rs.randn(n, 3, 3)).astype(np.float32),   # SH degree 1
        opacity=rs.randn(n, 1).astype(np.float32),
        scaling=(np.log(0.05) + 0.3 * rs.randn(n, 3)).astype(np.float32),
        rotation=rs.randn(n, 4).astype(np.float32), alive=np.ones(n, bool)))
    return path


def _jax_renders(monkeypatch, ply, out, mode, num_frames, res):
    """The JAX CLI's float renders (its ``render`` outputs) and its videos'
    frames (the writer stubbed)."""
    calls, videos = [], {}
    real = jrender.render

    def recording(*args, **kw):
        o = real(*args, **kw)
        calls.append((np.asarray(o.image), np.asarray(o.depth)))
        return o

    monkeypatch.setattr(jrender, "render", recording)
    import v3d_tpu.data.video_io as vio
    monkeypatch.setattr(vio, "write_video",
                        lambda path, frames, fps=3: videos.update({os.path.basename(path): frames}))
    jrender_cli.render_scene(ply, out, mode, num_frames, res)
    return (np.stack([c[0] for c in calls]), np.stack([c[1] for c in calls]), videos)


@pytest.mark.parametrize("mode", ["spiral", "depth", "points"])
def test_render_cli_matches_jax(monkeypatch, ply, tmp_path, mode):
    res = 32
    num = 60 if mode == "spiral" else 6
    jrgb, jdepth, videos = _jax_renders(monkeypatch, ply, str(tmp_path / "j"), mode, num, res)
    rgb, depth = render_cli.render_scene(ply, str(tmp_path / "p"), mode, num, res,
                                         device="cpu")
    n = 54 if mode == "spiral" else 6
    assert rgb.shape == jrgb.shape == (n, res, res, 3)
    assert np.abs(rgb - jrgb).max() <= 1e-4
    assert np.abs(depth - jdepth).max() <= 2e-4
    assert rgb.std() > 0.01   # the scene is in view
    pngs = sorted(os.listdir(tmp_path / "p" / mode))
    assert len(pngs) == n
    frame = np.asarray(Image.open(tmp_path / "p" / mode / pngs[1]))
    video = videos[f"{mode}.mp4"]
    assert frame.shape == video[1].shape
    assert np.abs(frame.astype(int) - video[1].astype(int)).max() <= 1


def test_render_cli_main_writes_frames(ply, tmp_path):
    render_cli.main(["--ply", ply, "--output", str(tmp_path), "--mode", "orbit",
                     "--num-frames", "3", "--resolution", "16", "--device", "cpu"])
    assert len(os.listdir(tmp_path / "orbit")) == 3


def test_export_blender_cameras_matches_jax(tmp_path):
    a = render_cli.export_blender_cameras(str(tmp_path / "p"), 18, 2.0, 10.0, 50.0)
    b = jrender_cli.export_blender_cameras(str(tmp_path / "j"), 18, 2.0, 10.0, 50.0)
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    return chip_smoke.write_seeded_lpips(str(tmp_path_factory.mktemp("w") / "lpips.npz"), 0)


def test_metrics_cli_matches_jax(tmp_path, monkeypatch, lpips_npz, capsys):
    rs = np.random.RandomState(4)
    for d in ("renders", "gt"):
        os.makedirs(tmp_path / d)
    base = rs.randint(0, 256, (3, 40, 40, 3)).astype(np.uint8)
    for i in range(3):
        noisy = np.clip(base[i].astype(int) + rs.randint(-30, 31, base[i].shape), 0, 255)
        Image.fromarray(base[i]).save(tmp_path / "gt" / f"{i:03d}.png")
        Image.fromarray(noisy.astype(np.uint8)).save(tmp_path / "renders" / f"{i:03d}.png")
    monkeypatch.setenv("V3D_TPU_LPIPS_WEIGHTS", lpips_npz)
    got = metrics_cli.evaluate(str(tmp_path / "renders"), str(tmp_path / "gt"), device="cpu")
    want = jmetrics.evaluate(str(tmp_path / "renders"), str(tmp_path / "gt"))
    assert sorted(got) == sorted(want) == ["lpips", "n_images", "psnr", "ssim"]
    assert got["n_images"] == want["n_images"] == 3
    for k in ("psnr", "ssim", "lpips"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    monkeypatch.setenv("V3D_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    metrics_cli.main(["--renders", str(tmp_path / "renders"), "--gt", str(tmp_path / "gt"),
                      "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert "lpips" not in out and out["psnr"] == pytest.approx(want["psnr"], rel=1e-5)


def test_validate_ckpt_lpips_and_dpt(tmp_path, lpips_npz, capsys):
    """The ingestion stages on weights written here: LPIPS of a black and a
    gray image finite and positive, the DPT normals of a gray frame finite;
    absent files raise; neither flag nor --ckpt is an argparse error."""
    sd = DPT().init_(torch.Generator().manual_seed(0)).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, tmp_path / "dpt.ckpt")
    validate_ckpt.main(["--lpips", lpips_npz, "--dpt", str(tmp_path / "dpt.ckpt"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "LPIPS weights ingested" in out and "DPT weights ingested" in out
    d = validate_ckpt.check_lpips(lpips_npz, "cpu")
    assert np.isfinite(d) and d > 0
    with pytest.raises(FileNotFoundError):
        validate_ckpt.check_lpips(str(tmp_path / "absent.npz"), "cpu")
    with pytest.raises(FileNotFoundError):
        validate_ckpt.check_dpt(str(tmp_path / "absent.ckpt"), "cpu")
    with pytest.raises(SystemExit):
        validate_ckpt.main(["--device", "cpu"])
