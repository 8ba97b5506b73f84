"""The port's 3DGS renderer and its pieces (v3d_tpu_torch/gs, data/cameras)
against the JAX package (v3d_tpu/gs, data/cameras) on the same gaussians, in
float32 on the CPU (the JAX side takes its XLA compositor there, the oracle
of its Pallas kernels; the port its plain compositor).

Tolerances: cameras exact (the same numpy code); SH and projection rtol
1e-5 (elementwise float32 in another order); SSIM 1e-5 (a convolution
against banded matmuls); rendered image and alpha atol 2e-5, depth 2e-4 (as
tests/test_pallas_raster.py); gradients max |port - JAX| <= 1e-4 max |JAX|
per parameter (the gather's scatter-add and the compositor's sums run in
another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.data import cameras as jcams
from v3d_tpu.gs import losses as jlosses
from v3d_tpu.gs import render as jrender
from v3d_tpu.gs.gaussians import from_pcd, random_init_pcd
from v3d_tpu.gs.sh import eval_sh as jeval_sh
from v3d_tpu_torch.core.convert import gaussians_from_jax
from v3d_tpu_torch.data import cameras
from v3d_tpu_torch.gs import losses, render
from v3d_tpu_torch.gs.sh import eval_sh

torch.set_num_threads(1)

# name -> RasterizeConfig fields (600 points)
CONFIGS = {
    "global_sort": dict(max_per_tile=96, tile_chunk=5, coarse_factor=2,
                        max_per_coarse=1024),
    "coarse": dict(max_per_tile=96, tile_chunk=5, coarse_factor=2,
                   max_per_coarse=256),
    "force_coarse": dict(max_per_tile=96, tile_chunk=5, coarse_factor=2,
                         max_per_coarse=1024, force_coarse=True),
}
GRAD_FIELDS = ("xyz", "opacity", "scaling", "f_dc")


def _scene(n=600, res=64, seed=0, sh_degree=0):
    rng = np.random.RandomState(seed)
    xyz, colors = random_init_pcd(rng, n, radius=2.0)
    g = from_pcd(xyz, colors, sh_degree=sh_degree, capacity=n + 40)
    pose = jcams.get_uniform_poses(4, 2.0, 15.0, opengl=False)[1]
    return g, jcams.Camera.from_c2w(pose, 60.0, res, res)


def _port_cam(res=64):
    pose = cameras.get_uniform_poses(4, 2.0, 15.0, opengl=False)[1]
    return cameras.Camera.from_c2w(pose, 60.0, res, res)


def _close_rel(got, want, rel, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err} vs {rel} x {scale}"


def test_orbit_cameras_match_jax():
    ours = cameras.orbit_cameras(18, radius=2.0, elevation=0.0, fov_deg=60.0,
                                 resolution=512)
    ref = jcams.orbit_cameras(18, radius=2.0, elevation=0.0, fov_deg=60.0,
                              resolution=512)
    for a, b in zip(ours, ref):
        for f in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.fovx, a.fovy, a.width, a.height) == (b.fovx, b.fovy, b.width, b.height)
    assert cameras.focal2fov(cameras.fov2focal(1.0, 512), 512) == pytest.approx(1.0)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    dirs = rng.randn(50, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = rng.randn(50, (deg + 1) ** 2, 3).astype(np.float32)
    want = np.asarray(jeval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(40, 48, 3), (2, 33, 29, 3)])
def test_ssim_l1_psnr_match_jax(shape):
    rng = np.random.RandomState(0)
    a = rng.rand(*shape).astype(np.float32)
    # a smooth perturbation, so that SSIM is far from 0 and 1
    b = np.clip(a * 0.7 + 0.2 + 0.05 * rng.randn(*shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(losses.ssim(ta, tb)),
                               float(jlosses.ssim(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(float(losses.l1_loss(ta, tb)),
                               float(jlosses.l1_loss(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.psnr(ta, tb)),
                               float(jlosses.psnr(ja, jb)), rtol=1e-6)


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_project_gaussians_matches_jax(sh_degree):
    g, cam = _scene(sh_degree=sh_degree)
    rng = np.random.RandomState(7)
    g = g._replace(
        rotation=jnp.asarray(rng.randn(*g.rotation.shape).astype(np.float32)),
        scaling=g.scaling + jnp.asarray(0.3 * rng.randn(*g.scaling.shape), jnp.float32),
        f_rest=jnp.asarray(0.2 * rng.randn(*g.f_rest.shape), jnp.float32))
    want = jrender.project_gaussians(g, cam, active_sh_degree=sh_degree)
    got = render.project_gaussians(gaussians_from_jax(g), _port_cam(),
                                   active_sh_degree=sh_degree)
    for name in want._fields:
        w, o = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if w.dtype == bool:
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_matches_jax(name):
    g, cam = _scene()
    want = jrender.render(g, cam, jnp.ones(3),
                          config=jrender.RasterizeConfig(backend="xla", **CONFIGS[name]))
    got = render.render(gaussians_from_jax(g), _port_cam(), torch.ones(3),
                        config=render.RasterizeConfig(**CONFIGS[name]))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), atol=2e-5)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=2e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=2e-4)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert float(got.alpha.max()) > 0.5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_gradients_match_jax(name):
    g, cam = _scene(n=300)
    jcfg = jrender.RasterizeConfig(backend="xla", **CONFIGS[name])

    def jloss(params, so):
        out = jrender.render(g._replace(**params), cam, jnp.ones(3), config=jcfg,
                             screen_offset=so)
        return (jnp.sum(out.image * jnp.cos(out.image)) + 0.3 * jnp.sum(out.alpha ** 2)
                + 0.01 * jnp.sum(jnp.sin(out.depth)))

    jparams = {k: getattr(g, k) for k in GRAD_FIELDS}
    jgrads, jso = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.zeros((g.capacity, 2)))

    pg = gaussians_from_jax(g)
    params = {k: getattr(pg, k).requires_grad_() for k in GRAD_FIELDS}
    so = torch.zeros(g.capacity, 2, requires_grad=True)
    out = render.render(dataclasses.replace(pg, **params), _port_cam(), torch.ones(3),
                        config=render.RasterizeConfig(**CONFIGS[name]),
                        screen_offset=so)
    loss = (torch.sum(out.image * torch.cos(out.image)) + 0.3 * torch.sum(out.alpha ** 2)
            + 0.01 * torch.sum(torch.sin(out.depth)))
    grads = torch.autograd.grad(loss, [params[k] for k in GRAD_FIELDS] + [so])
    for k, got in zip(GRAD_FIELDS + ("screen_offset",), grads):
        want = np.asarray(jso if k == "screen_offset" else jgrads[k])
        assert np.abs(want).max() > 0, k
        _close_rel(got.numpy(), want, 1e-4, k)


def test_untile_is_tile_major_to_row_major():
    x = torch.arange(4 * 256, dtype=torch.float32).reshape(4, 256)  # 2 x 2 tiles
    img = render.untile(x, 2, 2, 30, 20)[..., 0]
    assert img.shape == (30, 20)
    assert img[0, 17] == 256 + 1          # tile 1, pixel (1, 0)
    assert img[17, 3] == 2 * 256 + 16 + 3  # tile 2, pixel (3, 1)
