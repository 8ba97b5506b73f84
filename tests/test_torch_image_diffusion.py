"""The port's ``ImageDiffusionEngine`` (v3d_tpu_torch/engines/image_diffusion.py)
against the JAX package's (v3d_tpu/engines/image_diffusion.py) on one set of
weights: a tiny UNet2D and a tiny image VAE, the JAX trees with every leaf
seeded (test_torch_unet2d.randomize), carried over by
``state_dict_from_jax``.  SD's sampling stack: ``DiscreteDenoiser`` with
``EpsScaling`` and ``LegacyDDPMDiscretization``, Euler, ``VanillaCFG(5)``;
a seeded cross-attention context.  The JAX draws (its key's) go to the port
as ``noise=``.  The JAX sampler's ``lax.scan`` runs as the Python loop that
defines it over a jitted UNet (XLA's CPU compile of a whole scan is the
less exact side, ROADMAP C10).  f32 on the CPU; max relative error <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_img2img import python_scan
from test_torch_unet2d import randomize, rel
from torch_port_helpers import rand
from v3d_tpu.diffusion import denoise as jd, discretize as jz, guidance as jg
from v3d_tpu.diffusion import sampling as js, scaling as jsc
from v3d_tpu.engines.image_diffusion import ImageDiffusionEngine as JEngine
from v3d_tpu.models.unet2d import UNetModel as JUNet
from v3d_tpu.models.vae import Decoder as JDecoder, Encoder as JEncoder
from v3d_tpu_torch import diffusion as D
from v3d_tpu_torch.core.convert import state_dict_from_jax
from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine
from v3d_tpu_torch.models.unet2d import UNetModel
from v3d_tpu_torch.models.vae import Decoder, Encoder

TOL = 1e-4
STEPS = 5
UNET_KW = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
               context_dim=24)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
HW, LATENT = 16, 8   # the tiny VAE halves once


class JittedApply:
    def __init__(self, module):
        self.apply = jax.jit(module.apply)


@pytest.fixture(scope="module")
def engines():
    ju, je, jdec = JUNet(**UNET_KW), JEncoder(double_z=True, **VAE_KW), JDecoder(out_ch=3, **VAE_KW)
    key = jax.random.PRNGKey(0)
    params = {
        "unet": randomize(jax.jit(ju.init)(key, jnp.zeros((1, LATENT, LATENT, 4)),
                                           jnp.zeros((1,)), jnp.zeros((1, 3, 24))), 1),
        "encoder": randomize(jax.jit(je.init)(key, jnp.zeros((1, HW, HW, 3))), 2),
        "decoder": randomize(jax.jit(jdec.init)(key, jnp.zeros((1, LATENT, LATENT, 4))), 3),
    }
    jsampler = js.EulerEDMSampler(discretization=jz.LegacyDDPMDiscretization(),
                                  num_steps=STEPS, guider=jg.VanillaCFG(5.0))
    jden = jd.DiscreteDenoiser(scaling=jsc.EpsScaling(),
                               discretization=jz.LegacyDDPMDiscretization())
    jeng = JEngine(unet=JittedApply(ju), denoiser=jden, sampler=jsampler,
                   vae_encoder=je, vae_decoder=jdec, downscale=HW // LATENT)
    unet, enc, dec = (UNetModel(**UNET_KW), Encoder(double_z=True, **VAE_KW),
                      Decoder(out_ch=3, **VAE_KW))
    for mod, tree, kind in ((unet, params["unet"], "unet2d"),
                            (enc, params["encoder"], "vae_encoder"),
                            (dec, params["decoder"], "vae_decoder")):
        mod.load_state_dict(state_dict_from_jax(tree, kind, mod))
        mod.eval()
    peng = ImageDiffusionEngine(
        unet=unet, denoiser=D.DiscreteDenoiser(scaling=D.EpsScaling(),
                                               discretization=D.LegacyDDPMDiscretization()),
        sampler=D.EulerEDMSampler(discretization=D.LegacyDDPMDiscretization(),
                                  num_steps=STEPS, guider=D.VanillaCFG(5.0)),
        vae_encoder=enc, vae_decoder=dec, downscale=HW // LATENT)
    ctx = rand((1, 3, 24), 4)
    c = {"crossattn": ctx}
    uc = {"crossattn": np.zeros_like(ctx)}
    return jeng, params, peng, c, uc


def _t(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


def _j(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def test_sample_matches_jax(engines, monkeypatch):
    jeng, params, peng, c, uc = engines
    rng = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(jax.random.split(rng)[0], (1, LATENT, LATENT, 4)))
    monkeypatch.setattr(jax.lax, "scan", python_scan)
    want = np.asarray(jeng.sample(params, rng, _j(c), _j(uc), height=HW, width=HW))
    got = peng.sample(_t(c), _t(uc), height=HW, width=HW, noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (1, LATENT, LATENT, 4)
    assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("strength", [0.6, 1.0])
def test_img2img_matches_jax(engines, monkeypatch, strength):
    """The last round(5 * strength) steps (3; all 5) from init latents
    noised with the JAX key's draw."""
    jeng, params, peng, c, uc = engines
    init = rand((1, LATENT, LATENT, 4), 5)
    rng = jax.random.PRNGKey(12)
    noise = np.array(jax.random.normal(jax.random.split(rng)[0], init.shape))
    monkeypatch.setattr(jax.lax, "scan", python_scan)
    want = np.asarray(jeng.img2img(params, rng, jnp.asarray(init), _j(c), _j(uc),
                                   strength=strength))
    calls = []
    hook = peng.unet.register_forward_hook(lambda *args: calls.append(1))
    try:
        got = peng.img2img(torch.from_numpy(init), _t(c), _t(uc), strength=strength,
                           noise=torch.from_numpy(noise))
    finally:
        hook.remove()
    assert len(calls) == round(STEPS * strength)
    assert rel(got.numpy(), want) <= TOL


def test_encode_decode_match_jax(engines):
    jeng, params, peng, _, _ = engines
    images = np.clip(rand((2, HW, HW, 3), 6, 0.5), -1, 1)
    rng = jax.random.PRNGKey(13)
    want = np.asarray(jeng.encode(params, jnp.asarray(images), rng))
    noise = np.array(jax.random.normal(rng, want.shape))
    got = peng.encode(torch.from_numpy(images), noise=torch.from_numpy(noise))
    assert rel(got.numpy(), want) <= TOL
    z = rand((2, LATENT, LATENT, 4), 7, 0.3)
    want = np.asarray(jeng.decode(params, jnp.asarray(z)))
    got = peng.decode(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (2, HW, HW, 3)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    with pytest.raises(ValueError):
        peng.encode(torch.from_numpy(images), noise=torch.zeros(1, 2, 2, 4))


def test_sample_draws_from_generator(engines):
    """Without ``noise`` the start latent comes from the generator: equal
    seeds, equal latents."""
    _, _, peng, c, uc = engines
    a, b = (peng.sample(_t(c), _t(uc), height=HW, width=HW,
                        generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()
