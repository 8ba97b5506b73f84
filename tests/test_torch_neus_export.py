"""The NeuS trainer's export path against the JAX package's, from one
state (the card recipe's field, every parameter moved off the sphere
init): ``sdf_grid`` (keyword-only ``resolution``, corners checked),
``vertex_colors`` and ``render_image``, rtol 1e-4 / atol 1e-5 (the
colours and renders take the field's exact gradient through the radiance
MLP and, for the renders, the coarse-to-fine sampling).  And the guard of
a degenerate fit: an empty isosurface writes timings and no mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_neus_helpers import jposes, pair
from v3d_tpu_torch.core.convert import trainer_state_from_jax


def test_exports_match_jax():
    jt, pt = pair("card")
    # off the sphere init: every parameter perturbed, both trainers alike
    rs = np.random.RandomState(3)
    jt.params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.05 * rs.randn(*np.shape(a)), jnp.float32), jt.params)
    jt.global_step = 3
    pt.restore(trainer_state_from_jax(jt.capture()))
    lo = np.array([-0.9, -1.0, -0.8], np.float32)
    hi = np.array([0.7, 1.0, 0.9], np.float32)
    np.testing.assert_allclose(pt.sdf_grid(lo, hi, resolution=9),
                               jt.sdf_grid(lo, hi, 9), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.sdf_grid(resolution=5), jt.sdf_grid(resolution=5),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="resolution="):
        pt.sdf_grid(64)
    verts = np.random.RandomState(0).randn(101, 3).astype(np.float32) * 0.4
    np.testing.assert_allclose(pt.vertex_colors(verts, chunk=64),
                               jt.vertex_colors(verts, chunk=64), rtol=1e-4, atol=1e-5)
    pose = jposes(4, 2.0, 0.0, opengl=True)[1]
    for got, want in zip(pt.render_image(pose, chunk=128), jt.render_image(pose, chunk=128)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_empty_isosurface_writes_timings_and_no_mesh(tmp_path, monkeypatch):
    """A degenerate fit (no zero crossing): ``reconstruct`` returns its
    timings and an empty mesh and writes no mesh file; ``full_asset``'s
    report says ``"mesh": null`` for that asset."""
    from v3d_tpu_torch.apps import full_asset, recon_neus

    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    monkeypatch.setattr(recon_neus, "isosurface", lambda *a, **k: empty)
    frames = np.ones((2, 8, 8, 3), np.float32)
    trainer, mesh, timings = recon_neus.reconstruct(
        frames, str(tmp_path / "neus"), max_steps=1, num_samples=16,
        train_num_rays=16, mc_resolution=8, device="cpu",
        config_overrides=dict(n_levels=2, grid_prune=False))
    assert len(mesh.vertices) == 0 and {"train_s", "export_s"} <= set(timings)
    assert sorted(p.name for p in (tmp_path / "neus").iterdir()) == ["config.json",
                                                                     "snapshot"]

    monkeypatch.setattr(full_asset, "sample_one",
                        lambda *a, **k: (np.zeros((2, 8, 8, 3), np.uint8), None, {}))
    monkeypatch.setattr(full_asset, "train_from_video", lambda *a, **k: None)
    monkeypatch.setattr(full_asset, "reconstruct",
                        lambda *a, **k: (None, recon_neus.Mesh(*empty), {}))
    report = full_asset.run(np.zeros((8, 8, 4), np.uint8), str(tmp_path / "asset"),
                            mesh=True, device="cpu")
    assert report["assets"][0]["mesh"] is None
    assert (tmp_path / "asset" / "full_asset.json").exists()
