"""A tiny engine's fine-tune loss and every VideoUNet gradient against the
JAX package, on the CPU in float32, on the same batch, sigmas and noise.

Both engines are ``build_tiny_engine`` (the V3D-512 topology at 32 channels),
the port's UNet filled by ``numpy_init_`` and carried to the JAX package
through its own key map.  The JAX loss draws its sigmas and noise from its
rng; the test computes the same draws from that rng and hands them to the
port.  Tolerances: the cond atol 5e-5 (sinusoids of the motion bucket, 300:
f32 rounding of the argument alone is ~2e-5); the loss rel 1e-4; each
parameter's gradient max |port - JAX| <= 2e-3 max |JAX| of that tensor plus
1e-6 of the largest gradient of the UNet (the whole-UNet forward parity holds
2e-4, a gradient sums the forward's rounding over the whole step; the
absolute term covers tensors whose true gradient is 0, such as a conv bias
right before a GroupNorm whose groups are single channels at this width).

The card trains f32 master weights under bf16 compute; that configuration is
held against the JAX engine built with ``dtype=bfloat16`` (flax: f32 params,
bf16 compute) on the same draws, tensor by tensor: max |port - JAX| <=
BF16_NOISE x max |JAX bf16 - JAX f32| of that tensor.  The two bf16 runs
round the same f32 math at different points (XLA fuses, ATen does not), so
they differ by bf16 rounding, which the JAX run's own distance from f32
measures (ratio up to 3.6 at these seeds); a missing or mis-cast gradient
path is off by the size of the tensor, ~30x that distance.  The bf16 losses
agree to rel 1e-3 (2.6e-4 seen)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import MAP_UNET, numpy_init_, to_flax
from v3d_tpu.diffusion.sigma_sampling import EDMSampling
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
from v3d_tpu_torch.engines.builder import build_tiny_engine

T, HW = 4, 8
GRAD_REL = 2e-3
BF16_NOISE = 6.0


def _flax_get(tree, path):
    for name in path:
        tree = tree[name]
    return tree


@pytest.fixture(scope="module")
def setup():
    engine = build_tiny_engine(num_frames=T, device="cpu")
    numpy_init_(engine.unet, 11)
    batch = next(SyntheticOrbitDataset(num_objects=2, num_frames=T, latent_hw=HW,
                                       seed=3, clip_dim=64).iter_batches(1))
    jengine = jax_tiny_engine(num_frames=T, resolution=64)
    params = to_flax(engine.unet, MAP_UNET)
    return engine, jengine, params, batch


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX loss and UNet gradients at rng 9, f32 and bf16 compute (both
    on the f32 params), and the sigmas and noise they draw."""
    _, _, params, batch = setup
    latents = batch["latents"]
    rng = jax.random.PRNGKey(9)
    runs = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        jengine = jax_tiny_engine(num_frames=T, resolution=64, dtype=dtype)
        jcond = jengine.training_cond(batch, num_frames=T)
        runs[name] = jax.jit(jax.value_and_grad(lambda p: jengine.training_loss(
            p, rng, jnp.asarray(latents), jcond, num_frames=T)))(params)
    return runs, _draws(rng, latents.shape[0], latents.shape)


def _draws(rng, n, shape):
    """The sigmas and noise StandardDiffusionLoss draws from ``rng``."""
    k_sig, k_noise, _ = jax.random.split(rng, 3)
    return (np.asarray(EDMSampling(p_mean=1.5, p_std=2.0)(k_sig, n)),
            np.asarray(jax.random.normal(k_noise, shape)))


def test_training_cond_matches_jax(setup):
    engine, jengine, _, batch = setup
    ref = jengine.training_cond(batch, num_frames=T)
    got = engine.training_cond(batch, num_frames=T)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=5e-5, err_msg=k)


def _port_loss_and_grads(engine, batch, sigmas, noise, **cfg):
    """The port's loss and {name: (port grad, JAX path)} with the UNet
    configured by ``cfg`` for this one call."""
    unet = engine.unet.requires_grad_(True)
    for k, v in cfg.items():
        setattr(unet, k, v)
    try:
        unet.zero_grad(set_to_none=True)
        loss = engine.training_loss(torch.as_tensor(batch["latents"]),
                                    engine.training_cond(batch, num_frames=T),
                                    sigmas=torch.tensor(sigmas),
                                    noise=torch.tensor(noise))
        loss.backward()
    finally:
        unet.use_checkpoint, unet.compute_dtype = False, None
    grads = {}
    for name, p in unet.named_parameters():
        path, fn = MAP_UNET(name)
        grads[name] = (np.asarray(fn(p.grad)), path)
    return float(loss.detach()), grads


def test_training_loss_and_unet_gradients_match_jax(setup, jax_runs):
    engine, _, _, batch = setup
    (jloss, jgrads), (sigmas, noise) = jax_runs[0]["f32"], jax_runs[1]
    loss, grads = _port_loss_and_grads(engine, batch, sigmas, noise)
    assert loss == pytest.approx(float(jloss), rel=1e-4)
    pairs = {name: (got, np.asarray(_flax_get(jgrads["params"], path)))
             for name, (got, path) in grads.items()}
    top = max(float(np.abs(want).max()) for _, want in pairs.values())
    for name, (got, want) in pairs.items():
        allowed = GRAD_REL * float(np.abs(want).max()) + 1e-6 * top
        assert float(np.abs(got - want).max()) <= allowed, name
    assert len(pairs) == len(list(engine.unet.parameters())) > 100


def test_bf16_compute_gradients_match_jax(setup, jax_runs):
    """f32 master weights, bf16 compute and checkpointing, as the card
    trains: the loss and each tensor's gradient against the JAX engine's
    bf16-compute run, within BF16_NOISE of that run's own bf16 rounding."""
    engine, _, _, batch = setup
    runs, (sigmas, noise) = jax_runs
    loss, grads = _port_loss_and_grads(engine, batch, sigmas, noise,
                                       use_checkpoint=True,
                                       compute_dtype=torch.bfloat16)
    assert loss == pytest.approx(float(runs["bf16"][0]), rel=1e-3)
    assert loss != pytest.approx(float(runs["f32"][0]), rel=1e-6)  # bf16 ran
    for name, (got, path) in grads.items():
        assert got.dtype == np.float32, name
        want = np.asarray(_flax_get(runs["bf16"][1]["params"], path), np.float32)
        f32 = np.asarray(_flax_get(runs["f32"][1]["params"], path))
        noise_floor = float(np.abs(want - f32).max())
        assert float(np.abs(got - want).max()) <= BF16_NOISE * noise_floor, name
    assert len(grads) > 100


def test_checkpointing_and_compute_dtype(setup, jax_runs):
    """use_checkpoint recomputes the blocks and changes no gradient, in f32
    and under bf16 compute (the same ops run again: exact)."""
    engine, _, _, batch = setup
    sigmas, noise = jax_runs[1]
    for dtype in (None, torch.bfloat16):
        _, plain = _port_loss_and_grads(engine, batch, sigmas, noise,
                                        compute_dtype=dtype)
        _, ckpt = _port_loss_and_grads(engine, batch, sigmas, noise,
                                       use_checkpoint=True, compute_dtype=dtype)
        for name, (got, _) in ckpt.items():
            np.testing.assert_allclose(got, plain[name][0], rtol=1e-6, atol=1e-9,
                                       err_msg=name)


def test_encode_first_stage_matches_jax(setup):
    """Scaled latents of the VAE encoder's moments sampled with the same
    normal draw (the JAX side draws it from its rng inside gaussian_sample).
    Tolerance: the VAE encoder parity bound, rtol/atol 2e-4."""
    from torch_port_helpers import MAP_ENCODER

    engine, jengine, _, _ = setup
    numpy_init_(engine.vae_encoder, 12)
    frames = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    ref = jengine.encode_first_stage({"encoder": to_flax(engine.vae_encoder, MAP_ENCODER)},
                                     jnp.asarray(frames), rng)
    noise = np.asarray(jax.random.normal(rng, ref.shape))
    got = engine.encode_first_stage(torch.tensor(frames), noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_sigma_per_video(setup):
    """One sigma per video shared by its frames: the JAX loss with
    ``sigma_per_video`` on the draws the test computes from its rng, and the
    port's own draw order (b sigmas, then the noise) from one generator."""
    engine, jengine, params, _ = setup
    batches = SyntheticOrbitDataset(num_objects=3, num_frames=T, latent_hw=HW, seed=4,
                                    clip_dim=64).iter_batches(2)
    batch = next(batches)
    latents = batch["latents"]
    rng = jax.random.PRNGKey(6)
    ref = jengine.training_loss(params, rng, jnp.asarray(latents),
                                jengine.training_cond(batch, num_frames=T),
                                num_frames=T, sigma_per_video=True)
    k_sig, k_loss = jax.random.split(rng)
    sigmas = np.repeat(np.asarray(EDMSampling(p_mean=1.5, p_std=2.0)(k_sig, 2)), T)
    _, k_noise, _ = jax.random.split(k_loss, 3)
    noise = np.asarray(jax.random.normal(k_noise, latents.shape))
    cond = engine.training_cond(batch, num_frames=T)
    with torch.no_grad():
        got = engine.training_loss(torch.tensor(latents), cond, sigmas=torch.tensor(sigmas),
                                   noise=torch.tensor(noise))
        assert float(got) == pytest.approx(float(ref), rel=1e-4)
        drawn = engine.training_loss(torch.tensor(latents), cond, sigma_per_video=True,
                                     generator=torch.Generator().manual_seed(8))
        gen = torch.Generator().manual_seed(8)
        s = engine.loss_fn.sigma_sampler(2, generator=gen).repeat_interleave(T)
        again = engine.training_loss(torch.tensor(latents), cond, sigmas=s,
                                     noise=torch.randn(latents.shape, generator=gen))
    assert float(drawn) == float(again)
