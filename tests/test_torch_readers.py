"""The port's training-set readers (v3d_tpu_torch/data/co3d.py,
mvimagenet.py, gobjaverse.py, wonder3d.py) and the fisheye camera model
(fisheye.py) against the JAX package's, on the archives the JAX package's
own tests write (their module fixtures, reused here).

Tolerances: decoded pixels, parsed poses and every seeded draw exact
(arrays equal); derived cameras (the NDC -> OpenCV -> pixelnerf chain, pose
normalisation, world normals) 1e-6; fisheye at 1e-5 relative to the
largest magnitude.  One G-Objaverse item goes through the port's
``training_cond`` (equal to the JAX engine's) and one fine-tune step.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import v3d_tpu.data.co3d as jco3d
import v3d_tpu.data.gobjaverse as jgob
import v3d_tpu.data.mvimagenet as jmvi
import v3d_tpu.data.wonder3d as jw3d
from v3d_tpu.data import fisheye as jfish
from v3d_tpu_torch.data import co3d, fisheye, gobjaverse as gob, mvimagenet as mvi, wonder3d

from test_co3d import co3d_root  # noqa: F401  (fixtures)
from test_gobjaverse import archive  # noqa: F401
from test_mvimagenet import mvi_root  # noqa: F401
from test_wonder3d import wonder3d_dir  # noqa: F401

torch.set_num_threads(1)


def same(got, want, atol=0.0, path="item"):
    """Nested dicts / lists / arrays / scalars equal (floats within atol)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            same(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, atol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=atol), path
    else:
        assert got == want, path


# ---------------------------------------------------------------------------
# CO3D


CO3D_CASES = {
    "pixelnerf": dict(sample_batch_size=8, num_frames=10, reso=32),
    "masked_test": dict(stage="test", masked=True, reso=32, scale_pose=False,
                        sample_batch_size=6, num_frames=6),
    "no_crop": dict(box_crop=False, reso=24, sample_batch_size=12, num_frames=20,
                    load_pixelnerf=False),
}


@pytest.mark.parametrize("case", sorted(CO3D_CASES))
def test_co3d_items_match_jax(co3d_root, case):  # noqa: F811
    kw = CO3D_CASES[case]
    port = co3d.Co3dDataset(co3d_root, seed=4, **kw)
    ref = jco3d.Co3dDataset(co3d_root, seed=4, **kw)
    assert port.seq_list == ref.seq_list and len(port) == len(ref)
    for idx in (0, 1, 0):
        same(port[idx], ref[idx], atol=1e-6)
    if kw.get("load_pixelnerf", True):
        port.max_n_cond = ref.max_n_cond = 3
        same(port.collate_fn([port[0], port[1]]), ref.collate_fn([ref[0], ref[1]]), atol=1e-6)


def test_co3d_frame_data_depths_and_eval_batches(co3d_root):  # noqa: F811
    kw = dict(reso=32, load_depths=True, load_depth_masks=True, mask_depths=True,
              load_point_clouds=True, max_points=100,
              eval_batch_index=[[("seq_a", 0), ("seq_a", 3, "hydrant/seq_a/images/frame000003.jpg")],
                                [("seq_b", 2), ("nope", 1)]])
    port, ref = co3d.Co3dDataset(co3d_root, **kw), jco3d.Co3dDataset(co3d_root, **kw)
    assert port.eval_batches == ref.eval_batches
    for i in (0, 5, 13):
        same(port.frame_data(i), ref.frame_data(i), atol=1e-6)
    with pytest.raises(IndexError):
        port.seq_frame_index_to_dataset_index([[("nope", 1)]])
    with pytest.raises(ValueError):
        co3d.Co3dDataset(co3d_root, eval_batches=[[0]], eval_batch_index=[[("seq_a", 0)]])


def test_co3d_helpers_match_jax(co3d_root, tmp_path):  # noqa: F811
    rs = np.random.RandomState(0)
    mask = np.zeros((30, 40), np.float32)
    mask[5:20, 8:31] = rs.rand(15, 23)
    for thr in (0.4, 0.95, 2.0):
        assert co3d.get_bbox_from_mask(mask, thr) == jco3d.get_bbox_from_mask(mask, thr)
    for ctx in (0.0, 0.3):
        assert co3d.clamp_bbox((3, 4, 20, 11), ctx, 30, 40) == jco3d.clamp_bbox(
            (3, 4, 20, 11), ctx, 30, 40)
    assert co3d.rescale_bbox((3, 4, 20, 11), (30, 40), (15, 20)) == jco3d.rescale_bbox(
        (3, 4, 20, 11), (30, 40), (15, 20))
    img = rs.rand(30, 41, 3).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        same(co3d.resize_longest(img, 16, mode), jco3d.resize_longest(img, 16, mode))
    depth = (1 + rs.rand(9, 7)).astype(np.float32)
    depth[0, 0] = np.inf
    co3d.save_depth_png(str(tmp_path / "d.png"), depth)
    same(co3d.load_depth_png(str(tmp_path / "d.png"), 0.5),
         jco3d.load_depth_png(str(tmp_path / "d.png"), 0.5))
    same(co3d.load_depth_mask_png(str(tmp_path / "d.png")),
         jco3d.load_depth_mask_png(str(tmp_path / "d.png")))
    ply = os.path.join(co3d_root, "hydrant", "seq_a", "pointcloud.ply")
    same(co3d.load_pointcloud_ply(ply, max_points=50, seed=3),
         jco3d.load_pointcloud_ply(ply, max_points=50, seed=3))
    with open(tmp_path / "a.ply", "w") as f:       # ascii, float colours
        f.write("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                "property float y\nproperty float z\nproperty float red\nproperty float "
                "green\nproperty float blue\nend_header\n0 1 2 0.5 0.25 1\n3 4 5 1 0 0\n")
    same(co3d.load_pointcloud_ply(str(tmp_path / "a.ply")),
         jco3d.load_pointcloud_ply(str(tmp_path / "a.ply")))
    for fmt in ("ndc_isotropic", "ndc_norm_image_bounds"):
        vp = {"R": np.linalg.qr(rs.randn(3, 3))[0].tolist(), "T": rs.randn(3).tolist(),
              "focal_length": [2.0, 2.2], "principal_point": [0.1, -0.05],
              "intrinsics_format": fmt}
        f, p = co3d.ndc_to_screen(vp, (30, 40))
        same((f, p), jco3d.ndc_to_screen(vp, (30, 40)))
        cv = co3d.screen_to_opencv_camera(vp, f, p)
        same(cv, jco3d.screen_to_opencv_camera(vp, f, p))
        same(co3d.opencv_to_pixelnerf_camera(*cv), jco3d.opencv_to_pixelnerf_camera(*cv),
             atol=1e-6)


# ---------------------------------------------------------------------------
# MVImageNet


@pytest.mark.parametrize("mask_type", ["center", "random", "rembg"])
def test_mvimagenet_items_match_jax(mvi_root, mask_type):  # noqa: F811
    kw = dict(reso=16, num_frames=6, mask_type=mask_type, load_pixelnerf=True,
              scale_pose=mask_type != "random", max_n_cond=2, min_n_cond=1, seed=5)
    port, ref = mvi.MVImageNet(mvi_root, **kw), jmvi.MVImageNet(mvi_root, **kw)
    assert port.ids == ref.ids
    for idx in range(len(ref)):          # scene_broken falls back to scene 0
        same(port[idx], ref[idx], atol=1e-6)
    same(port.collate_fn([port[0], port[2]]), ref.collate_fn([ref[0], ref[2]]), atol=1e-6)
    q, t = np.array([0.9, 0.1, -0.3, 0.2]), np.array([0.3, -0.2, 5.0])
    same(mvi.qt2c2w(q / np.linalg.norm(q), t), jmvi.qt2c2w(q / np.linalg.norm(q), t),
         atol=1e-6)


# ---------------------------------------------------------------------------
# G-Objaverse


@pytest.mark.parametrize("selection", ["random", "fixed", "clip_score_softmax",
                                       "clip_score_max"])
def test_gobjaverse_items_match_jax(archive, selection):  # noqa: F811
    kw = dict(reso=16, front_view_selection=selection, seed=6)
    if selection == "random":
        kw.update(load_pixelnerf=True, scale_pose=True, condition_on_elevation=True,
                  load_caps=True, max_n_cond=3)
    elif selection == "fixed":
        kw.update(use_latents=True)
    port, ref = gob.GObjaverse(archive, **kw), jgob.GObjaverse(archive, **kw)
    assert port.ids == ref.ids
    for idx in (0, 2, 1):
        same(port[idx], ref[idx], atol=1e-6)
    if kw.get("load_pixelnerf"):
        same(port.collate_fn([port[0], port[1]]), ref.collate_fn([ref[0], ref[1]]), atol=1e-6)
    port.ids[1] = ref.ids[1] = "0/does_not_exist"        # the corrupt-item fallback
    same(port[1], ref[1], atol=1e-6)


def test_gobjaverse_camera_helpers_match_jax(archive):  # noqa: F811
    meta = os.path.join(archive, "gobjaverse", "0/10010", "00003", "00003.json")
    same(gob.read_camera_matrix_single(meta), jgob.read_camera_matrix_single(meta))
    same(gob.read_camera_intrinsics_single(meta, 256, 256, 0.5),
         jgob.read_camera_intrinsics_single(meta, 256, 256, 0.5))
    rs = np.random.RandomState(1)
    rt, intr = rs.randn(4, 3, 4).astype(np.float32), (1 + rs.rand(4, 3, 2)).astype(np.float32)
    cams = gob.build_camera_standard(rt, intr)
    same(cams, jgob.build_camera_standard(rt, intr))
    same(gob.normalize_poses(cams), jgob.normalize_poses(cams), atol=1e-6)
    c2w = rs.randn(5, 4, 4)
    same(gob.calc_elevation(c2w), jgob.calc_elevation(c2w))
    png = os.path.join(archive, "gobjaverse", "0/10011", "00007", "00007.png")
    same(gob._blend_white_and_resize(png, 20), jgob._blend_white_and_resize(png, 20))


def test_gobjaverse_item_feeds_port_fine_tune_step(archive):  # noqa: F811
    """test_gobjaverse.py:191's check on the port: the latents-mode item ->
    collate -> ``training_cond`` (equal to the JAX engine's) -> one
    ``DiffusionTrainer`` step of the tiny engine, on 8 of the 24 views and
    the 32^2 latents cropped to 8^2."""
    from v3d_tpu.engines.builder import build_tiny_engine as jbuild
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig

    ds = gob.GObjaverse(archive, use_latents=True, seed=0)
    batch = ds.collate_fn([ds[0]])
    t, n = 8, gob.N_VIEWS
    for k, v in list(batch.items()):
        if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
            batch[k] = v[:t]
    batch["image_only_indicator"] = batch["image_only_indicator"][:, :t]
    batch["latents"] = batch["latents"][:t, :8, :8]
    batch["cond_frames"] = batch["cond_frames"][..., :8, :8, :]
    batch["cond_frames_without_noise"] = batch["cond_frames_without_noise"][..., :64]

    engine = build_tiny_engine(num_frames=t, device="cpu")
    cond = engine.training_cond(batch, num_frames=t)
    want = jbuild(num_frames=t, resolution=64).training_cond(batch, num_frames=t)
    assert sorted(cond) == sorted(want)
    for k in want:
        # "vector" holds cos / sin of motion_bucket_id 300 times frequencies
        # up to 1: float32 rounds such an argument to its ulp, 3.05e-5
        atol = 4e-5 if k == "vector" else 1e-6
        np.testing.assert_allclose(cond[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=atol, err_msg=k)
    trainer = DiffusionTrainer(engine, TrainConfig(base_learning_rate=1e-4), num_frames=t)
    stats = trainer.train_step(torch.as_tensor(batch["latents"]), cond)
    assert np.isfinite(stats["loss"]) and stats["grad_norm"] > 0 and trainer.step == 1


# ---------------------------------------------------------------------------
# Wonder3D


@pytest.mark.parametrize("system", ["front", "own"])
def test_wonder3d_views_match_jax(wonder3d_dir, tmp_path, system):  # noqa: F811
    kw = dict(im_size=24, normal_system=system)
    if system == "own":
        for view in wonder3d.VIEW_TYPES:
            np.savetxt(tmp_path / f"000_{view}_RT.txt", wonder3d.make_fixed_pose(view, 1.1))
        kw.update(cam_pose_dir=str(tmp_path), view_types=wonder3d.VIEW_TYPES[:4])
    same(wonder3d.load_wonder3d_views(wonder3d_dir, "owl", **kw),
         jw3d.load_wonder3d_views(wonder3d_dir, "owl", **kw), atol=1e-6)
    for view in wonder3d.VIEW_AZIMUTHS:
        same(wonder3d.make_fixed_pose(view), jw3d.make_fixed_pose(view))
        rt = wonder3d.make_fixed_pose(view)
        same(wonder3d.rt_opengl2opencv(rt), jw3d.rt_opengl2opencv(rt))


# ---------------------------------------------------------------------------
# fisheye624


def _fisheye_params(rs, b, n_params):
    f = 300 + 20 * rs.rand(b, 2 if n_params == 16 else 1)
    c = 320 + 10 * rs.randn(b, 2)
    k = 0.02 * rs.randn(b, 6)
    p = 1e-3 * rs.randn(b, 2)
    s = 1e-3 * rs.randn(b, 4)
    return np.concatenate([f, c, k, p, s], -1)


@pytest.mark.parametrize("n_params", [15, 16])
def test_fisheye_matches_jax(n_params):
    rs = np.random.RandomState(n_params)
    params = _fisheye_params(rs, 2, n_params).astype(np.float32)
    # rays within 40 deg of the axis, where five Newton steps converge (both
    # packages run five), one of them on the axis (r = 0)
    ang, rad = rs.uniform(0, 2 * np.pi, (2, 64)), 0.84 * np.sqrt(rs.rand(2, 64))
    z = 0.5 + rs.rand(2, 64, 1)
    xyz = np.concatenate([np.stack([np.cos(ang), np.sin(ang)], -1) * rad[..., None] * z, z], -1)
    xyz[0, 0] = [0.0, 0.0, 1.0]
    xyz = xyz.astype(np.float32)
    uv = fisheye.fisheye624_project(torch.tensor(xyz), torch.tensor(params))
    juv = np.asarray(jfish.fisheye624_project(jnp.asarray(xyz), jnp.asarray(params)))
    np.testing.assert_allclose(uv.numpy(), juv, rtol=0, atol=1e-5 * np.abs(juv).max())
    rays = fisheye.fisheye624_unproject_helper(uv, torch.tensor(params))
    jrays = np.asarray(jfish.fisheye624_unproject_helper(jnp.asarray(juv), jnp.asarray(params)))
    np.testing.assert_allclose(rays.numpy(), jrays, rtol=0, atol=1e-5 * np.abs(jrays).max())
    # project -> unproject returns the rays through the points (z = 1)
    np.testing.assert_allclose(rays.numpy(), xyz / xyz[..., 2:], rtol=0, atol=1e-4)
    one = fisheye.fisheye624_unproject(uv[0], torch.tensor(params[:1]).expand(64, -1))
    jone = np.asarray(jfish.fisheye624_unproject(jnp.asarray(juv[0]),
                                                 jnp.asarray(np.repeat(params[:1], 64, 0))))
    np.testing.assert_allclose(one.numpy(), jone, rtol=0, atol=1e-5 * np.abs(jone).max())
    # gradients through both Newton solves are finite
    p = torch.tensor(params, requires_grad=True)
    x = torch.tensor(xyz, requires_grad=True)
    back = fisheye.fisheye624_unproject_helper(fisheye.fisheye624_project(x, p), p)
    back.sum().backward()
    assert torch.isfinite(p.grad).all() and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError):
        fisheye.fisheye624_project(x, p[:, :14])
