"""The port's DPT normal predictor (v3d_tpu_torch/models/dpt.py, the "dpt"
kind of core/keymap.py and core/convert.py, nerf/normals.py's loader and
npz writer, recon_neus's ``dpt_weights``) against the JAX package's, on the
CPU, float32, full width (ResNetV2-(3,4,9) + ViT-B/16, 256 decoder
features) on seeded weights (the Omnidata checkpoint is not in the
repository).

- The resize matrices equal the JAX package's.
- One ``state_dict()`` drives both sides: the JAX ``convert_dpt`` maps it
  to the Flax tree, and the port's key map inverts the tree to the same
  state dict (the unused final norm and refinenet4's first unit kept from
  the module where a tree lacks them).  The forward at 64^2 and 128^2
  within max abs 1e-4 (outputs ~[0, 2]).
- ``load_dpt_normal_predictor`` gives the same normals from a .ckpt (the
  Omnidata layout, "model." prefixes) and from an .npz of the converted
  tree, within 5e-4 of the JAX loader (the bound of the JAX package's own
  test against the torch reference).
- ``reconstruct(..., dpt_weights=...)`` supervises with the predictor's
  world normals at ``lambda_normal`` 1.0; explicit normals come first, and
  ``$V3D_TPU_DPT_WEIGHTS`` is read when no path is given.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.core.convert import convert_dpt
from v3d_tpu.models import dpt as JD
from v3d_tpu.nerf.normals import load_dpt_normal_predictor as j_load
from v3d_tpu_torch.core.convert import state_dict_from_jax
from v3d_tpu_torch.models import dpt as PD
from v3d_tpu_torch.nerf import normals as PN


@pytest.fixture(scope="module")
def dpt():
    model = PD.DPT(num_channels=3).init_(torch.Generator().manual_seed(0)).eval()
    sd = model.state_dict()
    return model, sd, convert_dpt(sd)


@pytest.fixture(scope="module")
def weight_files(dpt, tmp_path_factory):
    _, sd, params = dpt
    d = tmp_path_factory.mktemp("dpt")
    ckpt = d / "omnidata_dpt_normal_v2.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, ckpt)
    npz = d / "dpt_params.npz"
    PN.save_dpt_params_npz(params, str(npz))
    return ckpt, npz


@pytest.mark.parametrize("n_in,n_out", [(12, 24), (12, 5), (30, 30), (7, 40), (160, 128),
                                        (24, 8), (384, 512)])
def test_resize_matrices_equal_jax(n_in, n_out):
    for ac in (False, True):
        np.testing.assert_array_equal(PD._bilinear_matrix(n_in, n_out, ac),
                                      JD._bilinear_matrix(n_in, n_out, ac))
    np.testing.assert_array_equal(PD._bicubic_matrix(n_in, n_out),
                                  JD._bicubic_matrix(n_in, n_out))
    if n_out < n_in:
        np.testing.assert_array_equal(PD._bilinear_aa_matrix(n_in, n_out),
                                      JD._bilinear_aa_matrix(n_in, n_out))
    x = np.random.RandomState(0).rand(2, n_in, n_in, 3).astype(np.float32)
    for kind, jfn in (("antialias", JD.resize_bilinear_antialias),
                      ("bicubic", JD.resize_bicubic)):
        got = PD.resize(torch.tensor(x).permute(0, 3, 1, 2), (n_out, n_out), kind)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jfn(jnp.asarray(x), (n_out, n_out))),
                                   rtol=1e-5, atol=1e-6)


def test_dpt_state_dict_round_trips_through_the_jax_tree(dpt):
    model, sd, params = dpt
    back = state_dict_from_jax(params, "dpt", model)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # a tree without the unused keys (as a Flax init has it) keeps the module's
    tree = jax.tree_util.tree_map(lambda a: a, params)
    del tree["params"]["refinenet4"]["rcu1"]
    back = state_dict_from_jax(tree, "dpt", model)
    assert torch.equal(back["scratch.refinenet4.resConfUnit1.conv1.weight"],
                       sd["scratch.refinenet4.resConfUnit1.conv1.weight"])
    del tree["params"]["refinenet3"]["rcu1"]
    with pytest.raises(KeyError, match="refinenet3"):
        state_dict_from_jax(tree, "dpt", model)
    assert sum(v.numel() for v in sd.values()) > 120_000_000


@pytest.mark.parametrize("size", [64, 128])
def test_dpt_forward_matches_jax(dpt, size):
    model, _, params = dpt
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.jit(JD.DPT(num_channels=3).apply)(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, size, size, 3)
    assert 0.5 < np.abs(want).max() < 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_loader_ckpt_and_npz_match_jax(weight_files):
    ckpt, npz = weight_files
    imgs = np.random.RandomState(3).rand(3, 160, 160, 3).astype(np.float32)
    from_ckpt = PN.load_dpt_normal_predictor(str(ckpt), infer_size=128, batch_size=2,
                                             device="cpu")
    from_npz = PN.load_dpt_normal_predictor(str(npz), infer_size=128, batch_size=2,
                                            device="cpu")
    got = from_ckpt(imgs)
    assert got.shape == imgs.shape
    np.testing.assert_array_equal(from_npz(imgs), got)
    want = j_load(str(ckpt), infer_size=128)(imgs)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    assert PN.load_dpt_normal_predictor(str(ckpt) + ".missing", device="cpu") is None


def test_reconstruct_with_dpt_weights(weight_files, monkeypatch, tmp_path):
    from v3d_tpu_torch.apps import recon_neus
    from v3d_tpu_torch.data.cameras import get_uniform_poses

    ckpt, _ = weight_files
    res, views = 32, 3
    yy, xx = np.mgrid[:res, :res]
    ball = (yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (res / 4) ** 2
    frames = np.where(ball[None, ..., None], 0.3, 1.0).repeat(views, 0).repeat(3, -1)
    tiny = dict(max_steps=1, num_samples=16, train_num_rays=16, mc_resolution=8,
                device="cpu", config_overrides=dict(n_levels=2, grid_prune=False))
    trainer, _, _ = recon_neus.reconstruct(frames, str(tmp_path / "a"),
                                           dpt_weights=str(ckpt), **tiny)
    assert trainer.cfg.lambda_normal == 1.0
    predict = PN.load_dpt_normal_predictor(str(ckpt), device="cpu")
    want = PN.dpt_world_normals(predict(frames.astype(np.float32)),
                                recon_neus.foreground_masks(frames.astype(np.float32)),
                                get_uniform_poses(views, 2.0, 0.0, opengl=True))
    np.testing.assert_array_equal(trainer.normals.numpy(), want)
    # explicit normals first; the environment variable when no path is given
    given = np.zeros_like(want)
    trainer, _, _ = recon_neus.reconstruct(frames, str(tmp_path / "b"), normals=given,
                                           dpt_weights=str(ckpt), **tiny)
    np.testing.assert_array_equal(trainer.normals.numpy(), given)
    monkeypatch.setenv("V3D_TPU_DPT_WEIGHTS", str(ckpt))
    trainer, _, _ = recon_neus.reconstruct(frames, str(tmp_path / "c"), **tiny)
    np.testing.assert_array_equal(trainer.normals.numpy(), want)
    monkeypatch.setenv("V3D_TPU_DPT_WEIGHTS", str(tmp_path / "absent.ckpt"))
    with pytest.raises(FileNotFoundError, match="DPT"):
        recon_neus.reconstruct(frames, str(tmp_path / "d"), **tiny)
