"""``img2img_latents`` of the port against the JAX package's on the tiny
engine, on the same weights (the port's seeded weights converted), the same
cond, init latents and noise draw (the JAX key's), in float32 on the CPU.

Cases: strength 0.5 of 2 steps (tests/test_engine_e2e.py's case: 1 step run)
and of 25 steps (Python's round(12.5) = 12 steps run, counted on the
port's UNet).  Tolerance: test_torch_slice.py's rtol 1e-3 / atol 1e-3 (UNet
evaluations in float32 amplified by the sampler's sqrt(1 + sigma0^2)
start scaling).  The JAX function runs with its sampler's ``lax.scan`` as
the Python loop that defines it and its UNet jitted alone: at 25 steps
XLA's CPU compile of the whole scan lands 1.6e-3 from a float64 run of the
port, the loop over the jitted UNet 9.3e-6 (and all op by op 1.2e-5, in 55
s), the port in float32 1.2e-5."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import MAP_UNET, numpy_init_, rand, to_flax
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.engines.video_diffusion import img2img_latents as jax_img2img
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.video_diffusion import img2img_latents

TOL = dict(rtol=1e-3, atol=1e-3)
T = 4


def python_scan(f, init, xs):
    """``lax.scan`` (with xs, no outputs) as the loop its definition states."""
    carry = init
    for i in range(len(jax.tree_util.tree_leaves(xs)[0])):
        carry, _ = f(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
    return carry, None


class JittedUNet:
    def __init__(self, unet):
        self.apply = jax.jit(unet.apply, static_argnames=("num_video_frames",))


@pytest.mark.parametrize("num_steps,run_steps", [(2, 1), (25, 12)])
def test_img2img_matches_jax(num_steps, run_steps, monkeypatch):
    port = build_tiny_engine(num_frames=T, num_steps=num_steps, device="cpu")
    numpy_init_(port.unet, 100)
    params = {"unet": to_flax(port.unet, MAP_UNET)}
    ref = jax_tiny_engine(num_frames=T, num_steps=num_steps, resolution=64)
    ref = dataclasses.replace(ref, unet=JittedUNet(ref.unet))

    clip_emb, cond_frames = rand((1, 1, 64), 1), rand((1, 8, 8, 4), 2, 0.5)
    c, uc = ref.build_cond(jnp.asarray(clip_emb), jnp.asarray(cond_frames), 1, 300, 0.02)
    init = rand((T, 8, 8, 4), 3, 0.5)
    rng = jax.random.PRNGKey(7)
    monkeypatch.setattr(jax.lax, "scan", python_scan)
    want = np.asarray(jax_img2img(ref, params, rng, jnp.asarray(init), c, uc,
                                  strength=0.5, num_steps=num_steps))
    # img2img_latents splits rng -> (noise, sampler); Euler draws nothing
    r_noise, _ = jax.random.split(rng)
    noise = np.array(jax.random.normal(r_noise, init.shape, jnp.float32))

    calls = []
    port.unet.register_forward_hook(lambda *a: calls.append(1))
    to_t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # noqa: E731
    got = img2img_latents(port, torch.from_numpy(init), to_t(c), to_t(uc),
                          strength=0.5, num_steps=num_steps,
                          noise=torch.from_numpy(noise))
    assert len(calls) == run_steps  # one CFG-doubled forward a step
    assert got.shape == init.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want - init).max() > 1e-3  # the init was moved
