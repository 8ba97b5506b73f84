"""The port's autoencoder stack against the JAX package's, on the CPU in
float32: the VAE encoder with down-path attention and the image decoder
from one sgm-named ``state_dict()``, ``gaussian_kl``, both regularizers,
the PatchGAN discriminator and its four loss functions, and four
``AutoencoderTrainer`` steps (``disc_start`` 2, so two generator-only
steps, then two with the discriminator step) from the same parameters on
the JAX keys' draws.

Tolerances.  Forwards of the same weights: rel 1e-5 of the output's
largest magnitude (float32 convolutions in another summation order).
Trainer: each step's logged losses rel 1e-4 (the fine-tune trainer test's
bound); after the four Adam steps (lr 1e-4) every parameter element within
4e-6 abs (4% of one step's largest move, lr: Adam moves each weight by
~lr m/sqrt(v) and the gradients agree to ~1e-5), except the elements whose
JAX gradient is zero to rounding on some step: |g| < 1e-7 there, about 4x
the largest gradient of the tensors whose true gradient is exactly zero
(biases ahead of a one-channel GroupNorm group, the attention key biases).
On such a step Adam's move, lr g / (|g| + 1e-8) on a first step, follows
the rounding, and later steps do not take it back.  Those elements are
counted (at most 1e-3 of all), and the reconstruction they give must
agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_helpers import numpy_init_, rand, t
from v3d_tpu.core import convert as jc
from v3d_tpu.engines.ae_trainer import AETrainConfig as JConfig
from v3d_tpu.engines.ae_trainer import AutoencoderTrainer as JTrainer
from v3d_tpu.models import discriminator as JD
from v3d_tpu.models import regularizers as JR
from v3d_tpu.models import vae as JVAE
from v3d_tpu_torch.core.convert import ae_trainer_state_from_jax, state_dict_from_jax
from v3d_tpu_torch.engines.ae_trainer import AETrainConfig, AutoencoderTrainer
from v3d_tpu_torch.models import discriminator as PD
from v3d_tpu_torch.models import regularizers as PR
from v3d_tpu_torch.models import vae as PVAE

# the JAX AE test's tiny geometry (tests/test_ae_training.py:60), with the
# level at 16^2 attended for the attention test
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32, z_channels=4)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), (err, np.abs(ref).max())


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def test_encoder_attention_and_image_decoder_match_jax():
    """One first-stage state dict (``encoder.*`` / ``decoder.*``, sgm names)
    drives both packages' encoder (attention after the 16^2 level's block)
    and image decoder (attention after each block of its 16^2 level)."""
    kw = dict(TINY, attn_resolutions=(16,))
    enc = numpy_init_(PVAE.Encoder(double_z=True, **kw), 1)
    dec = numpy_init_(PVAE.Decoder(out_ch=3, **kw), 2)
    assert any(".attn.0." in k for k in enc.state_dict())
    assert sum(".attn." in k and "mid" not in k for k in dec.state_dict()) == 2 * 10
    sd = {**{"encoder." + k: v for k, v in enc.state_dict().items()},
          **{"decoder." + k: v for k, v in dec.state_dict().items()}}
    part = lambda pre: {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}  # noqa: E731
    x = rand((2, 32, 32, 3), 3, 0.5)
    with torch.no_grad():
        moments = enc(t(x).permute(0, 3, 1, 2))
        z = moments[:, :4]
        out = dec(z)
    ref_m = JVAE.Encoder(double_z=True, **kw).apply(
        {"params": jc.convert_vae(part("encoder."))}, jnp.asarray(x))
    _close(_nhwc(moments), ref_m)
    ref_out = JVAE.Decoder(out_ch=3, **kw).apply(
        {"params": jc.convert_vae(part("decoder."))}, jnp.asarray(_nhwc(z)))
    _close(_nhwc(out), ref_out)
    # the default attn_resolutions () adds nothing: V3D's encoder keeps its keys
    assert not any(".attn." in k and "mid" not in k
                   for k in PVAE.Encoder(**TINY).state_dict())


def test_gaussian_kl_and_regularizers_match_jax():
    """``gaussian_kl`` (logvar clamped to [-30, 20], summed over the
    non-batch dims) and the diagonal Gaussian regularizer, sampling with the
    JAX key's draw and taking the mode."""
    moments = rand((2, 4, 4, 8), 4, 3.0)
    moments[0, 0, 0, 4:] = [40.0, -50.0, 0.0, 1.0]
    _close(PVAE.gaussian_kl(t(moments)).numpy(), JVAE.gaussian_kl(jnp.asarray(moments)))
    key = jax.random.PRNGKey(5)
    z_ref, log_ref = JR.DiagonalGaussianRegularizer()(jnp.asarray(moments), key)
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 4)))
    z, log = PR.DiagonalGaussianRegularizer()(t(moments), noise=t(noise))
    _close(z.numpy(), z_ref)
    _close(float(log["kl_loss"]), float(log_ref["kl_loss"]))
    z_mode, _ = PR.DiagonalGaussianRegularizer(sample=False)(t(moments))
    _close(z_mode.numpy(), JR.DiagonalGaussianRegularizer(sample=False)(
        jnp.asarray(moments))[0])


def test_vector_quantizer_matches_jax():
    """Indices equal (first index of ties on both sides), the quantized
    values, the loss, the perplexity, and the straight-through gradient of
    sum(z_q^2) (2 z_q, passed to z unchanged)."""
    vq_j, vq_p = JR.VectorQuantizer(n_e=16, e_dim=4), PR.VectorQuantizer(n_e=16, e_dim=4)
    codebook = rand((16, 4), 6, 0.5)
    z = rand((3, 5, 4), 7, 0.5)
    codebook[3] = codebook[9]          # a tie: both pick the first index
    z[0, 0] = codebook[3] + 1e-3
    zq_ref, log_ref = vq_j(jnp.asarray(codebook), jnp.asarray(z))
    zt = t(z).requires_grad_(True)
    zq, log = vq_p(t(codebook), zt)
    np.testing.assert_array_equal(log["indices"].numpy(), np.asarray(log_ref["indices"]))
    assert int(log["indices"][0]) == 3
    _close(zq.detach().numpy(), zq_ref)
    for k in ("vq_loss", "perplexity"):
        _close(float(log[k]), float(log_ref[k]))
    grad_ref = jax.grad(lambda zz: jnp.sum(vq_j(jnp.asarray(codebook), zz)[0] ** 2))(
        jnp.asarray(z))
    (zq ** 2).sum().backward()
    _close(zt.grad.numpy(), grad_ref)
    cb = vq_p.init_codebook(torch.Generator().manual_seed(0))
    assert cb.shape == (16, 4) and float(cb.abs().max()) <= 1 / 16


@pytest.mark.parametrize("ndf,n_layers,hw", [(16, 2, 32), (8, 3, 64)])
def test_discriminator_matches_jax(ndf, n_layers, hw):
    """The PatchGAN from the JAX tree's names (``state_dict_from_jax``, kind
    "discriminator"): GroupNorm eps 1e-6, min(32, channels) groups."""
    x = rand((2, hw, hw, 3), 8)
    jmod = JD.NLayerDiscriminator(ndf=ndf, n_layers=n_layers)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape), params)
    port = PD.NLayerDiscriminator(ndf=ndf, n_layers=n_layers)
    port.load_state_dict(state_dict_from_jax(params, "discriminator", port), strict=True)
    with torch.no_grad():
        out = port(t(x).permute(0, 3, 1, 2))
    _close(_nhwc(out), jmod.apply(params, jnp.asarray(x)))


def test_discriminator_patch_map_is_30x30_at_256():
    with torch.device("meta"):
        out = PD.NLayerDiscriminator()(torch.empty(1, 3, 256, 256))
    assert tuple(out.shape) == (1, 1, 30, 30)


def test_adversarial_losses_match_jax():
    lr_, lf = rand((2, 6, 6, 1), 9), rand((2, 6, 6, 1), 10)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        _close(float(getattr(PD, name)(t(lr_), t(lf))),
               float(getattr(JD, name)(jnp.asarray(lr_), jnp.asarray(lf))))
    _close(float(PD.generator_loss(t(lf))), float(JD.generator_loss(jnp.asarray(lf))))
    for a, b in ((3.0, 0.5), (1e9, 1e-9), (0.0, 1.0)):
        _close(float(PD.adaptive_weight(torch.tensor(a), torch.tensor(b))),
               float(JD.adaptive_weight(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("kind,make", [
    ("vae_decoder", lambda: PVAE.Decoder(attn_resolutions=(16,), **TINY)),
    ("discriminator", lambda: PD.NLayerDiscriminator(ndf=16, n_layers=2)),
])
def test_state_dict_from_jax_new_kinds_round_trip(kind, make):
    """Port weights -> the JAX tree (the JAX converter for the decoder, the
    tree's own names for the discriminator) -> ``state_dict_from_jax``, bit
    for bit."""
    src = numpy_init_(make(), 11)
    if kind == "vae_decoder":
        tree = jc.convert_vae(src.state_dict())
    else:
        tree = {}
        for k, v in src.state_dict().items():
            name, param = k.rsplit(".", 1)
            leaf = {"weight": "scale" if name.startswith("GroupNorm") else "kernel",
                    "bias": "bias"}[param]
            arr = v.numpy()
            jc._set(tree, (name, leaf), arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr)
    sd = state_dict_from_jax({"params": tree}, kind, make())
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())


def _jax_trainer():
    kw = dict(TINY, attn_resolutions=())
    return JTrainer(JVAE.Encoder(double_z=True, **kw), JVAE.Decoder(out_ch=3, **kw),
                    JConfig(lr=1e-4, disc_lr=1e-4, disc_start=2), image_size=32)


def test_ae_trainer_steps_match_jax():
    """Four steps of both trainers from the JAX trainer's parameters
    (carried by ``ae_trainer_state_from_jax``) on the same images and the
    JAX keys' draws: the logged losses per step, and the parameters after,
    element by element apart from those whose JAX gradient was zero to
    rounding on a step."""
    jt = _jax_trainer()
    grads = {"g": [], "d": []}

    def recording(opt, key):   # each step's gradient tree, as the optimizer sees it
        def update(g, state, params=None):
            jax.debug.callback(lambda gg: grads[key].append(
                jax.tree_util.tree_map(np.asarray, gg)), g)
            return opt.update(g, state, params)
        return optax.GradientTransformation(opt.init, update)

    jt.opt, jt.d_opt = recording(jt.opt, "g"), recording(jt.d_opt, "d")
    kw = dict(TINY, attn_resolutions=())
    pt = AutoencoderTrainer(PVAE.Encoder(double_z=True, **kw), PVAE.Decoder(out_ch=3, **kw),
                            AETrainConfig(lr=1e-4, disc_lr=1e-4, disc_start=2), device="cpu")
    for name, sd in ae_trainer_state_from_jax(jt.params, jt.disc_params, pt).items():
        getattr(pt, name).load_state_dict(sd, strict=True)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 32, 32, 3)) * 2 - 1)
    for step in range(4):
        _, r1, r2 = jax.random.split(jt.rng, 3)
        draws = [t(np.asarray(jax.random.normal(r, (2, 16, 16, 4)))) for r in (r1, r2)]
        ref = jt.train_step(jnp.asarray(x))
        got = pt.train_step(x, noise=draws[0], disc_noise=draws[1])
        assert sorted(got) == sorted(ref), (got, ref)
        assert ("d_loss" in got) == (step >= 2)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7), (step, k, got, ref)
    assert (len(grads["g"]), len(grads["d"])) == (4, 2)
    # |g| per step in the port's layout: generator steps for the autoencoder,
    # discriminator steps for the discriminator
    g_abs = {}
    for gg in grads["g"]:
        for name in ("encoder", "decoder"):
            for k, v in ae_trainer_state_from_jax(gg, jt.disc_params, pt)[name].items():
                g_abs.setdefault(f"{name}.{k}", []).append(v.abs())
    for dg in grads["d"]:
        for k, v in ae_trainer_state_from_jax(jt.params, dg, pt)["disc"].items():
            g_abs.setdefault(f"disc.{k}", []).append(v.abs())
    after = ae_trainer_state_from_jax(jt.params, jt.disc_params, pt)
    n_all = n_exempt = 0
    for name in ("encoder", "decoder", "disc"):
        for k, p in getattr(pt, name).state_dict().items():
            err = (p - after[name][k]).abs()
            exempt = (torch.stack(g_abs[f"{name}.{k}"]) < 1e-7).any(0)
            n_all, n_exempt = n_all + err.numel(), n_exempt + int(exempt.sum())
            kept = err[~exempt]
            assert kept.numel() == 0 or float(kept.max()) <= 4e-6, (
                name, k, float(kept.max()), int(exempt.sum()))
    assert n_exempt <= 1e-3 * n_all, (n_exempt, n_all)
    # what the exempt elements leave: the same reconstruction
    noise = draws[0]
    with torch.no_grad():
        rec, _ = pt.reconstruct(pt.images(x), noise)
    mom = JVAE.Encoder(double_z=True, **kw).apply(jt.params["encoder"], jnp.asarray(x))
    zj = JVAE.gaussian_moments_split(mom)[0] + jnp.exp(
        0.5 * JVAE.gaussian_moments_split(mom)[1]) * jnp.asarray(noise.numpy())
    ref_rec = JVAE.Decoder(out_ch=3, **kw).apply(jt.params["decoder"], zj)
    _close(_nhwc(rec), ref_rec, rel=1e-4)


def _full_size_cases():
    from v3d_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
    from v3d_tpu.models.pixelnerf_encoder import ResUNet as JResUNet
    from v3d_tpu_torch.models.pixelnerf import PixelNeRF
    from v3d_tpu_torch.models.pixelnerf_encoder import ResUNet

    K = jnp.eye(3)
    return {
        "vae_encoder": (lambda: PVAE.Encoder(attn_resolutions=(32,)),
                        JVAE.Encoder(attn_resolutions=(32,)), (jnp.zeros((1, 64, 64, 3)),)),
        "vae_decoder": (PVAE.Decoder, JVAE.Decoder(), (jnp.zeros((1, 8, 8, 4)),)),
        "discriminator": (PD.NLayerDiscriminator, JD.NLayerDiscriminator(),
                          (jnp.zeros((1, 64, 64, 3)),)),
        "resunet": (ResUNet, JResUNet(), (jnp.zeros((1, 64, 64, 3)),)),
        "pixelnerf": (lambda: PixelNeRF(encoder_type="resunet"),
                      JPixelNeRF(encoder_type="resunet"),
                      (jnp.zeros((64, 64, 3)), jnp.eye(4), K, jnp.eye(4)[None], K[None],
                       (8, 8))),
    }


@pytest.mark.parametrize("kind", ["vae_encoder", "vae_decoder", "discriminator", "resunet",
                                  "pixelnerf"])
def test_full_size_structure_matches_jax(kind):
    """At the default widths (V3D's first stage with attention at 32^2, the
    PatchGAN, the PixelNeRF ResUNet and heads), every port key maps by the
    port's key map to a Flax leaf of the transformed shape, and every Flax
    leaf of the JAX init is covered."""
    from v3d_tpu_torch.core.convert import KEY_MAPS, _INVERSES

    make, jmod, args = _full_size_cases()[kind]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))["params"]
    leaves = {tuple(getattr(p, "key", p) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        port = make()
    seen = set()
    for key, val in port.state_dict().items():
        path, fn = KEY_MAPS[kind](key)
        assert path in leaves, (kind, key, path)
        flax_shape = _INVERSES[fn](np.zeros(leaves[path], np.float32)).shape
        assert flax_shape == tuple(val.shape), (kind, key, flax_shape, tuple(val.shape))
        seen.add(path)
    assert seen == set(leaves), set(leaves) - seen
