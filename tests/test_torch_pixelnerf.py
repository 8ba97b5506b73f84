"""The port's PixelNeRF conditioner, its ResUNet encoder and the PixelNeRF
diffusion loss against the JAX package's, on the CPU in float32.

- The ResUNet from one sgm-named ``state_dict()`` (the JAX side through
  ``convert_resunet``), and the "resunet" / "pixelnerf" kinds of
  ``state_dict_from_jax`` bit for bit.
- PixelNeRF with both encoders from the JAX init's tree, on orbit cameras
  around a square and a non-square source, with the JAX key's stratified
  jitter: rgb and features, and the gradient of a loss on them.
- ``bilinear_sample`` at the edges (u, v in {0, 1}: the corner index is
  clamped to W - 2, so u = 1 reads the last column with weight 1), and
  ``project_to_source`` on a non-square view (C14: the JAX module passes
  (W, H) into (h, w); the port matches it).
- ``StandardDiffusionLossWithPixelNeRFLoss`` on a closed-form denoiser with
  the JAX key's sigmas and noise.

Tolerances: rel 1e-5 of the largest magnitude for forwards (float32 in
another summation order).  The ResUNet normalises by batch statistics, so
its inputs are sized for its last layer to keep at least 4 x 4 pixels a
channel (a 2 x 2 map divides the rounding by a standard deviation of four
values, ~6e-5 off).  Gradients through the compositing cumprod rel 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import numpy_init_, rand, t
from v3d_tpu.core import convert as jc
from v3d_tpu.diffusion.denoise import Denoiser as JDenoiser
from v3d_tpu.diffusion.loss import StandardDiffusionLossWithPixelNeRFLoss as JLoss
from v3d_tpu.diffusion.scaling import VScalingWithEDMcNoise as JScaling
from v3d_tpu.diffusion.sigma_sampling import EDMSampling as JSampling
from v3d_tpu.diffusion.weighting import EDMWeighting as JWeighting
from v3d_tpu.models import pixelnerf as JP
from v3d_tpu.models.pixelnerf_encoder import ResUNet as JResUNet
from v3d_tpu_torch.core.convert import state_dict_from_jax
from v3d_tpu_torch.diffusion import Denoiser, EDMSampling, EDMWeighting, VScalingWithEDMcNoise
from v3d_tpu_torch.diffusion.loss import StandardDiffusionLossWithPixelNeRFLoss
from v3d_tpu_torch.models import pixelnerf as PP
from v3d_tpu_torch.models.pixelnerf_encoder import ResUNet


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), (err, np.abs(ref).max())


def _look_at(pos):
    """OpenCV camera-to-world (x right, y down, z forward) at ``pos``
    looking at the origin."""
    z = -np.asarray(pos, np.float64) / np.linalg.norm(pos)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    c2w[:3, 3] = pos
    return c2w.astype(np.float32)


def _cameras(H, W, views=3):
    src_c2w = _look_at([2.0, 0.0, 0.3])
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * H, H / 2], [0, 0, 1]], np.float32)
    angles = np.linspace(0.3, 1.2, views)
    c2ws = np.stack([_look_at([2 * np.cos(a), 2 * np.sin(a), 0.2]) for a in angles])
    return np.linalg.inv(src_c2w).astype(np.float32), K, c2ws, np.stack([K] * views)


def test_resunet_matches_jax_from_one_state_dict():
    port = numpy_init_(ResUNet(coarse_out_ch=32, fine_out_ch=32), 1)
    x = rand((2, 48, 48, 3), 2)
    with torch.no_grad():
        out = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    params = jc.convert_resunet(port.state_dict())
    ref = JResUNet(coarse_out_ch=32, fine_out_ch=32).apply(params, jnp.asarray(x))
    assert out.shape == (2, 12, 12, 64)
    _close(out.numpy(), ref)
    sd = state_dict_from_jax(params, "resunet", ResUNet())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())


def _pair(encoder_type, H, W, seed):
    """(JAX module, its params, the port module with the same weights)."""
    kw = dict(num_samples=8, feat_dim=16, out_feature_dim=2)
    jmod = JP.PixelNeRF(encoder_type=encoder_type, **kw)
    w2c, K, c2ws, Ks = _cameras(H, W)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((H, W, 3)), w2c, K,
                       c2ws, Ks, (8, 8))
    # move every leaf off its init (zero biases, unit norm scales)
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        a + 0.05 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    port = PP.PixelNeRF(encoder_type=encoder_type, **kw)
    port.load_state_dict(state_dict_from_jax(params, "pixelnerf", port), strict=True)
    return jmod, params, port


@pytest.mark.parametrize("encoder_type,H,W,grad", [("small_unet", 32, 32, True),
                                                   ("resunet", 64, 64, False),
                                                   ("small_unet", 32, 48, False)])
def test_pixelnerf_matches_jax(encoder_type, H, W, grad):
    """rgb and features of 3 target views at 8^2 from one source, with the
    JAX key's jitter, and (``grad``) the gradient of sum(rgb^2) + sum(feats)
    w.r.t. the source image and every parameter.  The ResUNet's source is
    64^2, so that its last layer's batch statistics span 4 x 4 pixels."""
    jmod, params, port = _pair(encoder_type, H, W, 3)
    w2c, K, c2ws, Ks = _cameras(H, W)
    src = rand((H, W, 3), 4, 0.5)
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (8,)))

    def jloss(p, s):
        rgb, feats = jmod.apply(p, s, w2c, K, c2ws, Ks, (8, 8), rng=key)
        return jnp.sum(rgb ** 2) + jnp.sum(feats), (rgb, feats)

    if grad:
        (_, (rgb_ref, feats_ref)), (gp_ref, gs_ref) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(src))
    else:
        _, (rgb_ref, feats_ref) = jloss(params, jnp.asarray(src))
    src_t = t(src).requires_grad_(grad)
    rgb, feats = port(src_t, t(w2c), t(K), t(c2ws), t(Ks), (8, 8), jitter=t(jitter))
    assert np.abs(np.asarray(rgb_ref)).max() > 1e-3
    _close(rgb.detach().numpy(), rgb_ref)
    _close(feats.detach().numpy(), feats_ref)
    if not grad:
        return
    ((rgb ** 2).sum() + feats.sum()).backward()
    _close(src_t.grad.numpy(), gs_ref, rel=1e-4)
    ref = state_dict_from_jax(gp_ref, "pixelnerf", port)
    for k, p in port.named_parameters():
        _close(p.grad.numpy(), ref[k].numpy(), rel=1e-4)


def test_pixelnerf_generator_draws_one_jitter_vector():
    _, _, port = _pair("small_unet", 32, 32, 5)
    w2c, K, c2ws, Ks = (t(a) for a in _cameras(32, 32))
    src = t(rand((32, 32, 3), 6, 0.5))
    with torch.no_grad():
        a = port(src, w2c, K, c2ws, Ks, (8, 8), generator=torch.Generator().manual_seed(3))
        u = torch.rand(8, generator=torch.Generator().manual_seed(3))
        b = port(src, w2c, K, c2ws, Ks, (8, 8), jitter=u)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_bilinear_sample_edges_match_jax():
    feat = rand((5, 7, 3), 8)
    uv = np.array([[0, 0], [1, 1], [1, 0], [0, 1], [0.5, 0.25], [0.999, 1.0],
                   [1.0, 0.3]], np.float32)
    got = PP.bilinear_sample(t(feat), t(uv)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.bilinear_sample(
        jnp.asarray(feat), jnp.asarray(uv))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], feat[-1, -1], atol=1e-6)
    np.testing.assert_allclose(got[2], feat[0, -1], atol=1e-6)


def test_project_to_source_non_square_and_c14():
    """The port's ``project_to_source`` equals the JAX function for any
    (h, w).  C14: the JAX PixelNeRF calls it with (W, H) in the (h, w)
    places (pixelnerf.py:135), so on a 32 x 48 source the point seen at the
    principal point (W/2, H/2), whose uv is (0.5, 0.5), is sampled at
    (W/2 / H, H/2 / W) = (0.75, 0.333).  The port's module makes the same
    call (test_pixelnerf_matches_jax's non-square case holds it so)."""
    H, W = 32, 48
    w2c, K, _, _ = _cameras(H, W)
    c2w = np.linalg.inv(w2c)
    o, (x, y, z) = c2w[:3, 3], c2w[:3, :3].T
    pts = np.stack([o + 1.5 * z, o + 1.5 * z + 0.3 * x - 0.2 * y, o - z + 0.2 * (x + y),
                    o + 0.1 * z + x]).astype(np.float32)
    for h, w in ((H, W), (W, H)):
        uv, valid = PP.project_to_source(t(pts), t(w2c), t(K), h, w)
        uv_ref, valid_ref = JP.project_to_source(jnp.asarray(pts), w2c, K, h, w)
        np.testing.assert_allclose(uv.numpy(), np.asarray(uv_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    right, _ = JP.project_to_source(jnp.asarray(pts[:1]), w2c, K, H, W)
    swapped, _ = JP.project_to_source(jnp.asarray(pts[:1]), w2c, K, W, H)
    np.testing.assert_allclose(np.asarray(right)[0], [0.5, 0.5], atol=1e-5)
    np.testing.assert_allclose(np.asarray(swapped)[0], [W / 2 / H, H / 2 / W], atol=1e-5)


def test_pixelnerf_loss_matches_jax():
    """The base EDM loss without cond["rgb"] (the network sees no "rgb"),
    plus w * mean((rgb - target)^2) per sample; and without a target, the
    base loss alone."""
    n = 4
    x = rand((n, 4, 4, 4), 9)
    rgb, target = rand((n, 8, 8, 3), 10), rand((n, 8, 8, 3), 11)
    concat = rand((n, 4, 4, 4), 12, 0.1)

    def network(xx, c, cond, **kw):
        assert "rgb" not in cond
        return xx / (1 + c.reshape(-1, 1, 1, 1) ** 2) + cond["concat"]

    key = jax.random.PRNGKey(13)
    jl = JLoss(sigma_sampler=JSampling(), loss_weighting=JWeighting(1.0),
               pixelnerf_loss_weight=0.7)
    pl = StandardDiffusionLossWithPixelNeRFLoss(
        sigma_sampler=EDMSampling(), loss_weighting=EDMWeighting(1.0),
        pixelnerf_loss_weight=0.7)
    rs, rn, _ = jax.random.split(key, 3)
    sigmas = np.asarray(JSampling()(rs, n))
    noise = np.asarray(jax.random.normal(rn, x.shape))
    for tgt in (target, None):
        ref = jl(network, JDenoiser(JScaling()),
                 {"concat": jnp.asarray(concat), "rgb": jnp.asarray(rgb)}, jnp.asarray(x),
                 key, rgb_target=None if tgt is None else jnp.asarray(tgt))
        got = pl(network, Denoiser(VScalingWithEDMcNoise()),
                 {"concat": t(concat), "rgb": t(rgb)}, t(x), sigmas=t(sigmas),
                 noise=t(noise), rgb_target=None if tgt is None else t(tgt))
        _close(got.numpy(), ref)
