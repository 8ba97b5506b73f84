"""``recon_gs_iterative.train_iterative`` of the port against the JAX
package's, at toy size on the CPU: the tiny engine (4 frames at 64^2, 2
Euler steps) on shared weights (the port's seeded weights converted), the
same generated frames (each package's ``sample_one`` monkeypatched to
return them with its engine), 22 fit iterations of 300 points with
resamples at iterations 10 and 20, and the JAX keys' draws handed to the
port.

Tolerances:
- each resample's decoded views (the new training images): test_torch_slice
  .py's rtol 1e-3 / atol 1e-3;
- the final gaussians: see ``test_final_gaussians``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import v3d_tpu.apps.generate as jgen
from torch_port_helpers import (
    MAP_CLIP,
    MAP_ENCODER,
    MAP_UNET,
    MAP_VIDEO_DECODER,
    numpy_init_,
    to_flax,
)
from v3d_tpu.apps.recon_gs_iterative import train_iterative as jax_train_iterative
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.gs.ply import save_ply as jax_save_ply
from v3d_tpu_torch.apps import recon_gs_iterative as app
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.gs.ply import load_ply, save_ply

TOL = dict(rtol=1e-3, atol=1e-3)
T, RES, ITERS, START, PERIOD, POINTS = 4, 64, 22, 5, 10, 300


def _frames():
    """4 views of a shaded disk on white, uint8."""
    yy, xx = np.mgrid[:RES, :RES] / RES
    out = []
    for k in range(T):
        disk = (yy - 0.5) ** 2 + (xx - 0.4 - 0.05 * k) ** 2 < 0.06
        col = np.stack([0.2 + 0.6 * xx, 0.3 + 0.1 * k + 0 * xx, 0.8 - 0.5 * yy], -1)
        out.append(np.where(disk[..., None], col, 1.0))
    return np.round(np.stack(out) * 255).astype(np.uint8)


def _recorder(engine, store):
    decode = engine.decode_latents

    def record(*args, **kwargs):
        out = decode(*args, **kwargs)
        store.append(np.array(out))
        return out

    engine.__dict__["decode_latents"] = record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("iterative")
    from PIL import Image

    Image.fromarray(_frames()[0]).save(out / "in.png")
    port = build_tiny_engine(num_frames=T, num_steps=2, device="cpu")
    for i, m in enumerate((port.unet, port.vae_encoder, port.vae_decoder, port.clip)):
        numpy_init_(m, 200 + i)
    params = {"unet": to_flax(port.unet, MAP_UNET),
              "encoder": to_flax(port.vae_encoder, MAP_ENCODER),
              "decoder": to_flax(port.vae_decoder, MAP_VIDEO_DECODER),
              "clip": to_flax(port.clip, MAP_CLIP)}
    ref = jax_tiny_engine(num_frames=T, num_steps=2, resolution=RES)
    j_views, p_views = [], []
    _recorder(ref, j_views)
    _recorder(port, p_views)
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "sample_one", lambda *a, **k: (_frames(), ref, params))
    mp.setattr(app, "sample_one", lambda *a, **k: (_frames(), port, {}))
    kw = dict(iterations=ITERS, resample_period=PERIOD, resample_start=START,
              num_pts=POINTS, seed=0)
    jt = jax_train_iterative(str(out / "in.png"), str(out / "jax"), **kw)

    # the JAX app splits rng = PRNGKey(seed) into (rng, r1, r2, r3) at each
    # resample; encode_image splits r3 into (latent sample, cond aug)
    draws, rng = [], jax.random.PRNGKey(0)
    lat, cond = (T, RES // 8, RES // 8, 4), (1, RES // 8, RES // 8, 4)
    for _ in range(2):
        rng, r1, r2, r3 = jax.random.split(rng, 4)
        e3, a3 = jax.random.split(r3)
        draws.append(app.ResampleDraws(*(
            torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
            for k, s in ((r1, lat), (r2, lat), (e3, cond), (a3, cond)))))
    pt, timings = app.train_iterative(str(out / "in.png"), str(out / "port"),
                                      device="cpu", draws=draws, **kw)
    mp.undo()
    return dict(jt=jt, pt=pt, timings=timings, j_views=j_views, p_views=p_views,
                out=out)


def test_resampled_views_match_jax(runs):
    assert len(runs["j_views"]) == len(runs["p_views"]) == 2  # at 10 and 20
    assert len(runs["timings"]["resample_s"]) == 2
    for j, p in zip(runs["j_views"], runs["p_views"]):
        assert p.shape == (T, RES, RES, 3)
        np.testing.assert_allclose(p, j, **TOL)
    np.testing.assert_allclose(runs["pt"].images.numpy(), np.asarray(runs["jt"].images),
                               **TOL)
    # the resamples replaced the generated frames
    assert np.abs(runs["p_views"][-1] - _frames() / 255.0).max() > 0.1


def test_final_gaussians(runs):
    """The fits' parameters after 22 Adam steps (eps 1e-15) and two
    resamples whose images differ by ~1e-4: Adam's update is lr * m /
    sqrt(v), about lr a step whatever the gradient's size, so a parameter
    whose gradient is rounding noise moves by up to lr a step either way on
    each side (C9), and the two sides lie within 2 * steps * lr of each
    other.  That is the bound for ``rotation``, whose gradient at the
    isotropic init is rounding noise.  The other fields' gradients are
    signal, the same on both sides up to the images' differences: held
    within one step's lr (seen: 0.05-0.23 lr).  Alive masks equal."""
    jt, pt = runs["jt"], runs["pt"]
    jg, pg = jt.gaussians_np(), pt.gaussians_np()
    np.testing.assert_array_equal(pg["alive"], jg["alive"])
    cfg = pt.cfg
    lrs = {"xyz": cfg.position_lr_init * pt.extent, "f_dc": cfg.feature_lr,
           "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
           "rotation": cfg.rotation_lr}
    for k, lr in lrs.items():
        bound = 2 * ITERS * lr if k == "rotation" else lr
        assert np.abs(pg[k] - jg[k]).max() <= bound, (k, np.abs(pg[k] - jg[k]).max(), bound)
    ply = load_ply(os.path.join(runs["out"], "port", "point_cloud.ply"))
    assert len(ply["xyz"]) == int(pg["alive"].sum()) > 0
    assert all(np.isfinite(v).all() for v in ply.values())


def test_save_ply_of_no_gaussians_raises_like_jax(tmp_path, runs):
    """ROADMAP C12 (reference-side): where the fit has pruned every
    gaussian, both packages' ``save_ply`` raise rather than write an empty
    cloud, so ``train_iterative`` ends without a PLY on both sides."""
    g = runs["pt"].gaussians_np()
    g["alive"] = np.zeros_like(g["alive"])
    with pytest.raises(ValueError):
        jax_save_ply(str(tmp_path / "jax.ply"), g)
    with pytest.raises(ValueError):
        save_ply(str(tmp_path / "port.ply"), g)
