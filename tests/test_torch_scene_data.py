"""The port's scene readers (v3d_tpu_torch/data/colmap.py, scene_datasets.py,
cameras.py's orthographic rays, video_io.py) against the JAX package's, on
files each test writes from a numpy seed.

Tolerances: parsed poses, intrinsics and decoded pixels exact; derived
cameras (c2w from a quaternion, DTU's decomposition) 1e-6; DTU against the
JAX loader's cv2.decomposeProjectionMatrix path, including a P whose raw
RQ decomposition has a negative focal length; an mp4 read back by both
packages bit for bit.
"""

import json
import os

import numpy as np
import pytest

import v3d_tpu.data.colmap as jcolmap
import v3d_tpu.data.scene_datasets as jsd
from v3d_tpu.data.cameras import get_ortho_ray_directions as jortho_dirs
from v3d_tpu.data.cameras import get_ortho_rays as jortho_rays
from v3d_tpu.data.cameras import get_uniform_poses
from v3d_tpu_torch.data import colmap, scene_datasets as sd
from v3d_tpu_torch.data.cam_paths import quat_from_matrix
from v3d_tpu_torch.data.cameras import get_ortho_ray_directions, get_ortho_rays

from test_co3d import co3d_root  # noqa: F401  (fixture)

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402


def _rotation(rs):
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def _model(rs, n_images=5, n_points=40):
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 40, 24, np.array([33.0, 35.0, 20.5, 11.25])),
            2: colmap.ColmapCamera(2, "SIMPLE_RADIAL", 40, 24, np.array([30.0, 20.0, 12.0, 0.01]))}
    imgs = {}
    for i in range(n_images):
        R = _rotation(rs)
        imgs[10 + i] = colmap.ColmapImage(10 + i, quat_from_matrix(R), rs.randn(3), 1 + i % 2,
                                          f"img_{i:03d}.png")
    xyz = rs.randn(n_points, 3).astype(np.float32)
    rgb = rs.randint(0, 255, (n_points, 3)).astype(np.uint8)
    return cams, imgs, (xyz, rgb)


def _write_text(sparse, cams, imgs):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in imgs.values():
            f.write(f"{im.id} " + " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
                    + f" {im.camera_id} {im.name}\n1.0 2.0 -1\n")


def _same_model(got, want):
    (cg, ig, pg), (cw, iw, pw) = got, want
    assert sorted(cg) == sorted(cw) and sorted(ig) == sorted(iw)
    for k in cw:
        assert (cg[k].model, cg[k].width, cg[k].height) == (cw[k].model, cw[k].width, cw[k].height)
        np.testing.assert_array_equal(cg[k].params, cw[k].params)
    for k in iw:
        assert (ig[k].name, ig[k].camera_id) == (iw[k].name, iw[k].camera_id)
        np.testing.assert_array_equal(ig[k].qvec, iw[k].qvec)
        np.testing.assert_array_equal(ig[k].tvec, iw[k].tvec)
        np.testing.assert_allclose(ig[k].c2w(), iw[k].c2w(), rtol=0, atol=1e-6)
    assert (pg is None) == (pw is None)
    if pw is not None:
        for a, b in zip(pg, pw):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_model_matches_jax(tmp_path, fmt):
    cams, imgs, pts = _model(np.random.RandomState(0))
    sparse = str(tmp_path / "sparse" / "0")
    if fmt == "binary":
        colmap.write_model(sparse, cams, imgs, pts)
        xyz, rgb = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        np.testing.assert_array_equal(xyz, pts[0])
        np.testing.assert_array_equal(rgb, pts[1])
    else:
        _write_text(sparse, cams, imgs)
    got, want = colmap.read_model(sparse), jcolmap.read_model(sparse)
    _same_model(got, want)
    for k, im in imgs.items():      # the model read back is the model written
        np.testing.assert_allclose(got[1][k].qvec, im.qvec, rtol=0, atol=0)
        assert got[0][im.camera_id].model == cams[im.camera_id].model


def test_ortho_rays_match_jax():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = _rotation(np.random.RandomState(1))
    c2w[:3, 3] = [0.2, -0.3, 1.3]
    for h, w, scale in ((6, 10, 1.0), (8, 8, 0.7)):
        got, want = get_ortho_ray_directions(h, w, scale), jortho_dirs(h, w, scale)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(get_ortho_rays(*got, c2w), jortho_rays(*want, c2w)):
            np.testing.assert_array_equal(a, b)


def _write_blender(root, n=5, h=20, w=28, alpha=True):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(2)
    poses = get_uniform_poses(n, 2.0, 0.0, opengl=True)
    frames = []
    for i in range(n):
        img = rs.randint(0, 255, (h, w, 4 if alpha else 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"r_{i}.png"))
        frames.append({"file_path": f"./r_{i}", "transform_matrix": poses[i].tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)


def _same_scene(got, want, atol=0.0):
    assert got.opengl == want.opengl and got.num_frames == want.num_frames
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.c2ws, want.c2ws, rtol=0, atol=atol)
    np.testing.assert_allclose(got.intrinsics, want.intrinsics, rtol=0, atol=atol)
    assert (got.fg_masks is None) == (want.fg_masks is None)
    if want.fg_masks is not None:
        np.testing.assert_array_equal(got.fg_masks, want.fg_masks)


@pytest.mark.parametrize("alpha", [True, False])
def test_blender_and_videonvs_match_jax(tmp_path, alpha):
    _write_blender(str(tmp_path), alpha=alpha)
    _same_scene(sd.load_blender_scene(str(tmp_path)), jsd.load_blender_scene(str(tmp_path)))
    _same_scene(sd.load_videonvs_scene(str(tmp_path)), jsd.load_videonvs_scene(str(tmp_path)))


def test_colmap_scene_matches_jax(tmp_path):
    rs = np.random.RandomState(3)
    cams, imgs, pts = _model(rs)
    cams[2] = colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 40, 24, np.array([30.0, 20.0, 12.0]))
    os.makedirs(tmp_path / "images")
    for im in imgs.values():
        Image.fromarray(rs.randint(0, 255, (24, 40, 3)).astype(np.uint8)).save(
            tmp_path / "images" / im.name)
    colmap.write_model(str(tmp_path / "sparse" / "0"), cams, imgs, pts)
    _same_scene(sd.load_colmap_scene(str(tmp_path)), jsd.load_colmap_scene(str(tmp_path)),
                atol=1e-6)


def _projections(rs):
    """P = K [R | t] cases: a plain camera, a skewed one with an off-centre
    principal point, and the same scaled by -2.3 (det M < 0: the raw RQ of
    numpy's QR gives a negative focal length, and cv2 a negative K[2, 2])."""
    out = []
    for skew, neg in ((0.0, False), (1.7, False), (0.0, True), (2.5, True)):
        K = np.array([[580.0 + 40 * rs.rand(), skew, 410.3], [0, 575.0, 297.1], [0, 0, 1]])
        P = K @ np.c_[_rotation(rs), rs.randn(3)]
        out.append(-2.3 * P if neg else P)
    return out


def test_decompose_projection_matches_cv2():
    for P in _projections(np.random.RandomState(4)):
        K, R, c = sd.decompose_projection(P)
        Kc, Rc, cc = cv2.decomposeProjectionMatrix(P)[:3]
        np.testing.assert_allclose(K / K[2, 2], Kc / Kc[2, 2], rtol=1e-9, atol=1e-7)
        np.testing.assert_allclose(K, Kc, rtol=1e-9, atol=1e-7)
        np.testing.assert_allclose(R, Rc, rtol=0, atol=1e-9)
        np.testing.assert_allclose(c[:3] / c[3], cc[:3] / cc[3], rtol=1e-9, atol=1e-9)
    raw = np.linalg.qr((np.eye(3)[::-1] @ _projections(np.random.RandomState(4))[2][:, :3]).T)[1]
    assert (np.diag(raw) < 0).any()      # the sign fix is exercised


def test_dtu_scene_matches_jax_cv2(tmp_path):
    rs = np.random.RandomState(5)
    os.makedirs(tmp_path / "image")
    os.makedirs(tmp_path / "mask")
    mats = {}
    for i, P in enumerate(_projections(rs)):
        S = np.eye(4)
        S[:3, :3] *= 1.7
        S[:3, 3] = rs.randn(3)
        W = np.eye(4)
        W[:3] = P
        mats[f"world_mat_{i}"] = W
        mats[f"world_mat_inv_{i}"] = np.linalg.inv(W)
        mats[f"scale_mat_{i}"] = S
        Image.fromarray(rs.randint(0, 255, (12, 16, 3)).astype(np.uint8)).save(
            tmp_path / "image" / f"{i:06d}.png")
        if i != 1:   # a view without its mask
            Image.fromarray(rs.randint(0, 255, (12, 16)).astype(np.uint8)).save(
                tmp_path / "mask" / f"{i:03d}.png")
    np.savez(tmp_path / "cameras.npz", **mats)
    _same_scene(sd.load_dtu_scene(str(tmp_path)), jsd.load_dtu_scene(str(tmp_path)), atol=1e-6)


def test_co3d_scene_matches_jax(co3d_root):  # noqa: F811
    for kw in (dict(), dict(sequence="seq_b", num_frames=5, reso=32)):
        _same_scene(sd.load_co3d_scene(co3d_root, "hydrant", **kw),
                    jsd.load_co3d_scene(co3d_root, "hydrant", **kw), atol=1e-6)


def test_scene_orbit_dataset_matches_jax(tmp_path):
    roots = []
    for s in range(2):
        roots.append(str(tmp_path / f"s{s}"))
        _write_blender(roots[-1], n=7)
    for num_frames in (4, 9):     # a window of the 7 views; all of them
        port = sd.SceneOrbitDataset(roots, sd.SceneOrbitConfig(num_frames=num_frames), seed=3)
        ref = jsd.SceneOrbitDataset(roots, jsd.SceneOrbitConfig(num_frames=num_frames), seed=3)
        for idx in (0, 1, 0):
            got, want = port[idx], ref[idx]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    c2w, K = np.arange(16.0).reshape(4, 4), np.arange(9.0).reshape(3, 3)
    np.testing.assert_array_equal(sd.camera_tensor(c2w, K), jsd.camera_tensor(c2w, K))


def test_mp4_round_trip_matches_jax(tmp_path):
    from v3d_tpu.data import video_io as jvio
    from v3d_tpu_torch.data import video_io

    frames = np.random.RandomState(6).rand(5, 32, 48, 3).astype(np.float32)
    video_io.write_video(str(tmp_path / "port.mp4"), frames)
    jvio.write_video(str(tmp_path / "jax.mp4"), frames)
    for path in ("port.mp4", "jax.mp4"):
        got = video_io.read_video(str(tmp_path / path))
        assert got.shape == (5, 32, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jvio.read_video(str(tmp_path / path)))
    np.testing.assert_array_equal(video_io.read_video(str(tmp_path / "port.mp4")),
                                  video_io.read_video(str(tmp_path / "jax.mp4")))
    video_io.save_image_grid(str(tmp_path / "port.png"), frames, cols=2)
    jvio.save_image_grid(str(tmp_path / "jax.png"), frames, cols=2)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    with pytest.raises(IOError):
        video_io.read_video(str(tmp_path / "missing.mp4"))


def test_video_io_names_cv2_when_missing(monkeypatch):
    import sys

    from v3d_tpu_torch.data import video_io

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        video_io.read_video("x.mp4")
    with pytest.raises(ImportError, match="cv2"):
        video_io.write_video("x.mp4", np.zeros((1, 8, 8, 3), np.uint8))
