"""Whole port models against the JAX package: VideoUNet, the VAE encoder and
temporal decoder, CLIP ViT (with its resize), at small sizes on converted
non-zero random weights; the full-size V3D-512 structure (keys, transformed
shapes, parameter count) built on the meta device against jax.eval_shape of
the JAX inits; and the round trip of the weight bridge.

Float32, rtol/atol 2e-4 on outputs of order 1: a whole UNet or VAE chains
tens of convolutions and norms, each summed in another order by the two
frameworks (~1e-6 per op)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    MAP_CLIP,
    MAP_ENCODER,
    MAP_UNET,
    MAP_VIDEO_DECODER,
    nchw,
    nhwc,
    numpy_init_,
    rand,
    t,
    to_flax,
)
from v3d_tpu.core import convert as jc
from v3d_tpu.models import clip_vit as JC
from v3d_tpu.models import vae as JVAE
from v3d_tpu.models.video_unet import VideoUNet as JUNet
from v3d_tpu_torch.core.convert import state_dict_from_jax
from v3d_tpu_torch.engines.builder import TINY_CLIP, TINY_UNET
from v3d_tpu_torch.models import clip_vit as PC
from v3d_tpu_torch.models import vae as PVAE
from v3d_tpu_torch.models.video_unet import VideoUNet as PUNet

TOL = dict(rtol=2e-4, atol=2e-4)

# "tiny": the tiny engine's UNet at an 8x8 latent (temporal layers on both
# the fused-block and the core route); "kernel_routes": dim_head 64 at a
# 32x32 latent, so ds1 self-attention takes K1's route (1024 tokens).
UNET_CASES = {
    "tiny": (dict(model_channels=32, **TINY_UNET), 4, 8),
    "kernel_routes": (dict(model_channels=64, num_res_blocks=1,
                           attention_resolutions=(2, 1), channel_mult=(1, 2),
                           num_head_channels=64, context_dim=32,
                           adm_in_channels=768), 2, 32),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_video_unet_forward(case):
    cfg, tt, hw = UNET_CASES[case]
    b = 2 * tt  # a CFG-doubled video
    port = numpy_init_(PUNet(**cfg), 1)
    x = rand((b, hw, hw, 8), 2)
    ts = rand((b,), 3, 0.5)
    ctx = rand((b, 1, cfg["context_dim"]), 4)
    y = rand((b, 768), 5)
    ind = np.zeros((2, tt), np.float32)
    ref = JUNet(**cfg).apply(to_flax(port, MAP_UNET), jnp.asarray(x), jnp.asarray(ts),
                             jnp.asarray(ctx), jnp.asarray(y), num_video_frames=tt,
                             image_only_indicator=jnp.asarray(ind))
    with torch.no_grad():
        got = port(nchw(x), t(ts), t(ctx), t(y), tt, t(ind))
    assert got.dtype == torch.float32 and got.shape == (b, 4, hw, hw)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4)


def test_vae_encoder_and_gaussian_sample():
    port = numpy_init_(PVAE.Encoder(**VAE_KW), 6)
    x = rand((2, 64, 64, 3), 7)
    ref = JVAE.Encoder(**VAE_KW).apply(to_flax(port, MAP_ENCODER), jnp.asarray(x))
    with torch.no_grad():
        moments = nhwc(port(nchw(x)))
    np.testing.assert_allclose(moments, np.asarray(ref), **TOL)
    # the latent draw: the JAX key's normals handed to the port explicitly
    key = jax.random.PRNGKey(3)
    jz = JVAE.gaussian_sample(key, jnp.asarray(moments))
    noise = np.asarray(jax.random.normal(key, jz.shape, jz.dtype))
    pz = PVAE.gaussian_sample(t(moments), t(noise))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(PVAE.gaussian_mode(t(moments)).numpy(),
                               np.asarray(JVAE.gaussian_mode(jnp.asarray(moments))),
                               rtol=0, atol=0)


def test_video_decoder():
    tt = 3
    port = numpy_init_(PVAE.VideoDecoder(out_ch=3, **VAE_KW), 8)
    z = rand((2 * tt, 4, 4, 4), 9)
    ref = JVAE.VideoDecoder(out_ch=3, num_frames=tt, **VAE_KW).apply(
        to_flax(port, MAP_VIDEO_DECODER), jnp.asarray(z))
    with torch.no_grad():
        got = nhwc(port(nchw(z), tt))
    assert got.shape == (2 * tt, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_clip_vit():
    port = numpy_init_(PC.CLIPVisionTransformer(**TINY_CLIP), 10)
    x = rand((2, 224, 224, 3), 11)
    ref = JC.CLIPVisionTransformer(**TINY_CLIP).apply(to_flax(port, MAP_CLIP),
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw", [(512, 512), (100, 80)])
def test_clip_preprocess_matches_jax_image_resize(hw):
    """jax.image.resize's antialiased Keys (a = -0.5) bicubic, rebuilt as two
    resize matrices; torch's own bicubic (a = -0.75) would not match.
    atol 5e-5: the weights are built in float64 here and float32 in JAX,
    summed over ~30 taps, and the CLIP normalisation scales by 1/std ~ 3.7."""
    x = rand((2,) + hw + (3,), 12, 0.5)
    ref = JC.clip_preprocess(jnp.asarray(x))
    got = PC.clip_preprocess(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=5e-5)


# -- full-size structure ------------------------------------------------------

def _full_size_pairs():
    """(name, port module on meta, JAX module, init args, key map)."""
    with torch.device("meta"):
        unet = PUNet()
        enc = PVAE.Encoder()
        dec = PVAE.VideoDecoder()
        clip = PC.CLIPVisionTransformer()
    t_ = 2
    return [
        ("unet", unet, JUNet(), (jnp.zeros((t_, 64, 64, 8)), jnp.zeros((t_,)),
                                 jnp.zeros((t_, 1, 1024)), jnp.zeros((t_, 768))),
         dict(num_video_frames=t_, image_only_indicator=jnp.zeros((1, t_))), MAP_UNET),
        ("vae_encoder", enc, JVAE.Encoder(), (jnp.zeros((1, 64, 64, 3)),), {},
         MAP_ENCODER),
        ("vae_video_decoder", dec, JVAE.VideoDecoder(num_frames=t_),
         (jnp.zeros((t_, 8, 8, 4)),), {}, MAP_VIDEO_DECODER),
        ("clip", clip, JC.CLIPVisionTransformer(), (jnp.zeros((1, 224, 224, 3)),), {},
         MAP_CLIP),
    ]


def test_full_size_structure_matches_jax():
    """Every port key maps to a Flax leaf of the transformed shape, every
    Flax leaf is covered, and the UNet totals 1,524,623,082 parameters."""
    for name, port, jmod, args, kw, key_map in _full_size_pairs():
        shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw),
                                *args)["params"]
        flax_leaves = {tuple(getattr(p, "key", p) for p in path): leaf.shape
                       for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        seen = set()
        for key, val in port.state_dict().items():
            path, fn = key_map(key)
            assert path in flax_leaves, (name, key, path)
            dummy = torch.zeros(()).expand(val.shape)  # no memory, shape only
            assert fn(dummy).shape == flax_leaves[path], (name, key)
            seen.add(path)
        assert seen == set(flax_leaves), (name, set(flax_leaves) - seen)
        if name == "unet":
            assert sum(p.numel() for p in port.parameters()) == 1_524_623_082


# -- weight bridge ------------------------------------------------------------

BRIDGE_CASES = {
    "unet": (lambda: PUNet(model_channels=32, **TINY_UNET), MAP_UNET,
             jc.convert_video_unet),
    "vae_encoder": (lambda: PVAE.Encoder(**VAE_KW), MAP_ENCODER, jc.convert_vae),
    "vae_video_decoder": (lambda: PVAE.VideoDecoder(**VAE_KW), MAP_VIDEO_DECODER,
                          lambda sd: jc.convert_vae(sd, video_decoder=True)),
    "clip": (lambda: PC.CLIPVisionTransformer(**TINY_CLIP), MAP_CLIP,
             lambda sd: jc.convert_clip_visual({"model.visual." + k: v
                                                for k, v in sd.items()})),
}


@pytest.mark.parametrize("kind", sorted(BRIDGE_CASES))
def test_state_dict_from_jax_round_trip(kind):
    """A Flax tree (the JAX converter's image of random port weights; its
    structure is held to the JAX inits by the full-size test above) -> the
    port's state dict, bit for bit, loading strictly -> the JAX converter ->
    the same Flax tree."""
    make, key_map, convert = BRIDGE_CASES[kind]
    src = numpy_init_(make(), 13)
    params = to_flax(src, key_map)["params"]
    port = make()
    sd = state_dict_from_jax(params, kind, port)
    port.load_state_dict(sd, strict=True)
    for key, val in src.state_dict().items():
        np.testing.assert_array_equal(sd[key].numpy(), val.numpy())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(convert(port.state_dict()))[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_state_dict_from_jax_rejects_wrong_kind():
    make, key_map, _ = BRIDGE_CASES["vae_encoder"]
    params = to_flax(make(), key_map)["params"]
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(params, "vae_video_decoder", make())
