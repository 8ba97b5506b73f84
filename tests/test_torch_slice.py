"""The whole slice at tiny size: image -> encode_image -> build_cond -> two
Euler steps of the CFG-doubled VideoUNet -> temporal VAE decode, in the JAX
package and in the port, on the same weights (the port's random weights
converted), the same image and the same noise (each JAX draw reproduced
from its keys and splits and handed to the port).

Each side chains its own outputs; every stage is compared.  Float32, rtol
1e-3 / atol 1e-3: the differences of ~1e-6 per op accumulate through CLIP,
the VAE encoder, two UNet evaluations amplified by the sampler's
sqrt(1 + sigma_max^2) start scaling, and the decoder."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    MAP_CLIP,
    MAP_ENCODER,
    MAP_UNET,
    MAP_VIDEO_DECODER,
    numpy_init_,
    t,
    to_flax,
)
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu_torch.data.preprocess import preprocess_image
from v3d_tpu_torch.engines.builder import build_tiny_engine

TOL = dict(rtol=1e-3, atol=1e-3)


def test_tiny_slice_matches_jax():
    tt, res = 4, 64
    port = build_tiny_engine(num_frames=tt, num_steps=2, device="cpu")
    for i, m in enumerate((port.unet, port.vae_encoder, port.vae_decoder, port.clip)):
        numpy_init_(m, 100 + i)
    params = {"unet": to_flax(port.unet, MAP_UNET),
              "encoder": to_flax(port.vae_encoder, MAP_ENCODER),
              "decoder": to_flax(port.vae_decoder, MAP_VIDEO_DECODER),
              "clip": to_flax(port.clip, MAP_CLIP)}
    ref = jax_tiny_engine(num_frames=tt, num_steps=2, resolution=res)

    rgba = np.zeros((80, 96, 4), np.uint8)
    rgba[..., :3] = np.random.RandomState(1).randint(0, 256, (80, 96, 3))
    rgba[15:70, 20:80, 3] = 255
    image = preprocess_image(rgba, resolution=res)[None]

    # encode_image: video_diffusion.py:76-79 splits rng -> (enc, aug)
    rng = jax.random.PRNGKey(5)
    j_emb, j_cond = ref.encode_image(params, jnp.asarray(image), rng, 0.02)
    r_enc, r_aug = jax.random.split(rng)
    shape = (1, res // 8, res // 8, 4)
    enc_noise = np.asarray(jax.random.normal(r_enc, shape))
    aug_noise = np.asarray(jax.random.normal(r_aug, shape))
    p_emb, p_cond = port.encode_image(t(image), 0.02, t(enc_noise), t(aug_noise))
    np.testing.assert_allclose(p_emb.numpy(), np.asarray(j_emb), **TOL)
    np.testing.assert_allclose(p_cond.numpy(), np.asarray(j_cond), **TOL)

    j_c, j_uc = ref.build_cond(j_emb, j_cond, 1, 300, 0.02)
    p_c, p_uc = port.build_cond(p_emb, p_cond, 1, 300, 0.02)
    for k in ("crossattn", "concat", "vector"):
        np.testing.assert_allclose(p_c[k].numpy(), np.asarray(j_c[k]), **TOL)
        np.testing.assert_allclose(p_uc[k].numpy(), np.asarray(j_uc[k]), **TOL)

    # sample_one draws the initial latent from split(r_samp)[0]
    # (generate.py:102-103); any standard-normal array does here
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (tt,) + shape[1:]))
    j_z = ref.sample_latents(params, jax.random.PRNGKey(8), j_c, j_uc, res, res,
                             noise=jnp.asarray(noise))
    p_z = port.sample_latents(p_c, p_uc, res, res, noise=t(noise))
    assert p_z.shape == (tt, 8, 8, 4)
    np.testing.assert_allclose(p_z.numpy(), np.asarray(j_z), **TOL)

    j_frames = ref.decode_latents(params, j_z, decoding_t=2)
    p_frames = port.decode_latents(p_z, decoding_t=2)
    assert p_frames.shape == (tt, res, res, 3)
    assert float(p_frames.min()) >= 0.0 and float(p_frames.max()) <= 1.0
    np.testing.assert_allclose(p_frames.numpy(), np.asarray(j_frames), **TOL)
    # the random weights must make the comparison non-trivial
    assert float(torch.std(p_frames)) > 0.05
