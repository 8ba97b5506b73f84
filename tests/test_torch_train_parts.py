"""The fine-tune slice's parts against the JAX package on the CPU: the sigma
sampler, loss weightings, StandardDiffusionLoss, EMA, LR schedules, the
orbit-data item assembly and collate, and the backwards of the kernels'
plain versions (attention, temporal block, temporal core) against jax.vjp.

Tolerances: elementwise float32 math (weightings, EMA, schedules) rtol 1e-6;
the loss on the same sigmas and noise rtol 1e-5 (one f32 mean over a few
hundred elements); data exact (both sides draw from the same numpy
RandomState); attention and temporal gradients rtol 2e-4 / atol 2e-5, the
bound the forward parity tests use (another summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import rand, t
from v3d_tpu.data import objaverse as jdata
from v3d_tpu.diffusion import loss as jloss
from v3d_tpu.diffusion import sigma_sampling as jsig
from v3d_tpu.diffusion import weighting as jw
from v3d_tpu.diffusion.denoise import Denoiser as JDenoiser
from v3d_tpu.diffusion.scaling import VScalingWithEDMcNoise as JScaling
from v3d_tpu.engines import ema as jema
from v3d_tpu.engines import lr_schedule as jlr
from v3d_tpu.models.clip_vit import clip_preprocess
from v3d_tpu.ops.attention import attention_bhsd
from v3d_tpu.ops.temporal_attention import temporal_block_attention as jblock
from v3d_tpu.ops.temporal_attention import temporal_core as jcore
from v3d_tpu_torch.apps import train_diffusion as app
from v3d_tpu_torch.data import objaverse as pdata
from v3d_tpu_torch.diffusion import Denoiser, VScalingWithEDMcNoise
from v3d_tpu_torch.diffusion import loss as ploss
from v3d_tpu_torch.diffusion import sigma_sampling as psig
from v3d_tpu_torch.diffusion import weighting as pw
from v3d_tpu_torch.engines import ema as pema
from v3d_tpu_torch.engines import lr_schedule as plr
from v3d_tpu_torch.ops import attention as pattn
from v3d_tpu_torch.ops import temporal_attention as ptemp

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def test_edm_sigma_sampling_is_the_same_lognormal():
    """Both samplers are exp(p_mean + p_std z): checked on each side's own
    normal draws (the generators differ), and in distribution."""
    key = jax.random.PRNGKey(0)
    jsamp = jsig.EDMSampling(p_mean=1.5, p_std=2.0)
    z = np.asarray(jax.random.normal(key, (1000,)))
    np.testing.assert_allclose(np.asarray(jsamp(key, 1000)), np.exp(1.5 + 2.0 * z),
                               rtol=1e-5)
    psamp = psig.EDMSampling(p_mean=1.5, p_std=2.0)
    got = psamp(1000, generator=torch.Generator().manual_seed(4))
    zp = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(got.numpy(), torch.exp(1.5 + 2.0 * zp).numpy(), rtol=1e-6)
    logs = torch.log(psamp(200_000, generator=torch.Generator().manual_seed(5)))
    assert abs(float(logs.mean()) - 1.5) < 0.02 and abs(float(logs.std()) - 2.0) < 0.02


@pytest.mark.parametrize("name", ["UnitWeighting", "EDMWeighting", "VWeighting",
                                  "EpsWeighting"])
def test_weightings(name):
    sig = np.exp(rand((64,), 1, 2.0))
    ref = getattr(jw, name)()(jnp.asarray(sig))
    got = getattr(pw, name)()(t(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def _network(x, c_noise, cond, image_only_indicator=None, **_):
    """A small differentiable stand-in for the UNet, the same on both sides
    (numpy-like ops only): depends on x, c_noise and the concat cond."""
    lib = jnp if isinstance(x, jnp.ndarray) else torch
    shift = c_noise.reshape((-1,) + (1,) * (x.ndim - 1))
    return lib.tanh(0.7 * x + 0.3 * cond["concat"]) - 0.1 * shift


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_standard_diffusion_loss_same_draws(loss_type):
    """The JAX loss draws from its rng; the same sigmas and noise, computed
    from that rng in the test, are passed to the port explicitly."""
    x = rand((6, 4, 4, 4), 2)
    cond = {"concat": rand((6, 4, 4, 4), 3)}
    key = jax.random.PRNGKey(7)
    kw = dict(loss_type=loss_type)
    jl = jloss.StandardDiffusionLoss(jsig.EDMSampling(1.5, 2.0), jw.EDMWeighting(1.0), **kw)
    ref = jl(_network, JDenoiser(JScaling()), {k: jnp.asarray(v) for k, v in cond.items()},
             jnp.asarray(x), key)
    k_sig, k_noise, _ = jax.random.split(key, 3)
    sigmas = np.asarray(jsig.EDMSampling(1.5, 2.0)(k_sig, 6))
    noise = np.asarray(jax.random.normal(k_noise, x.shape))
    pl = ploss.StandardDiffusionLoss(psig.EDMSampling(1.5, 2.0), pw.EDMWeighting(1.0), **kw)
    got = pl(_network, Denoiser(VScalingWithEDMcNoise()), {k: t(v) for k, v in cond.items()},
             t(x), sigmas=t(sigmas), noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_ema_update_and_decay():
    params = [rand((3, 4), 1), rand((5,), 2)]
    jshadow = [jnp.asarray(p) for p in params]
    pparams = [t(p) for p in params]
    pshadow = pema.ema_init(pparams)
    assert all(s.data_ptr() != p.data_ptr() for s, p in zip(pshadow, pparams))
    for step in range(4):
        new = [rand(p.shape, 10 + step + i) for i, p in enumerate(params)]
        jshadow = jema.ema_update(jshadow, [jnp.asarray(n) for n in new], step, 0.9999)
        pema.ema_update_(pshadow, [t(n) for n in new], step, 0.9999)
        for a, b in zip(pshadow, jshadow):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for step in (0, 5, 10**6):
        assert pema.ema_decay(step) == pytest.approx(float(jema.ema_decay(step)), rel=1e-6)


def test_lr_schedules():
    j, p = jlr.lambda_linear(), plr.lambda_linear()
    jw_, pw_ = (m(warm_up_steps=(10,), f_start=(0.1,), f_max=(1.0,), f_min=(0.5,),
                  cycle_lengths=(100,)) for m in (jlr.lambda_linear, plr.lambda_linear))
    jc = jlr.lambda_warmup_cosine(10, 0.1, 1.0, 0.0, 100)
    pc = plr.lambda_warmup_cosine(10, 0.1, 1.0, 0.0, 100)
    for step in (0, 1, 2, 5, 9, 10, 50, 99, 10_000):
        for a, b in ((p, j), (pw_, jw_), (pc, jc)):
            assert a(step) == pytest.approx(float(b(step)), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("frontview", ["first", "random"])
def test_assemble_item_and_collate(frontview):
    lat = rand((5, 6, 6, 4), 1)
    items = {}
    for name, mod in (("jax", jdata), ("port", pdata)):
        cfg = mod.OrbitItemConfig(num_frames=4, cond_aug=0.1, frontview=frontview)
        rng = np.random.RandomState(3)
        emb = rand((1, 8), 2)
        its = [mod.assemble_item(lat, cfg, rng, is_latent=True),
               mod.assemble_item(lat, cfg, rng, emb, is_latent=True)]
        items[name] = (its, mod.video_collate([its[1], its[1], its[1]]))
    (jits, jb), (pits, pb) = items["jax"], items["port"]
    for a, b in zip(jits, pits):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(pb[k]), err_msg=k)
    assert pb["latents"].shape == (12, 6, 6, 4) and pb["image_only_indicator"].shape == (3, 4)


def test_synthetic_dataset_same_stream_as_jax():
    j = jdata.SyntheticOrbitDataset(num_objects=3, num_frames=4, latent_hw=8, seed=2)
    p = pdata.SyntheticOrbitDataset(num_objects=3, num_frames=4, latent_hw=8, seed=2,
                                    clip_dim=16)
    jit, pit = j.iter_batches(2), p.iter_batches(2)
    for _ in range(3):
        jb, pb = next(jit), next(pit)
        for k in ("latents", "cond_frames", "fps_id", "cond_aug"):
            np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        assert pb["cond_frames_without_noise"].shape == (2, 1, 16)


def test_orbit_render_dataset_reads_latent_layout(tmp_path):
    for i in range(2):
        d = tmp_path / f"obj{i}"
        d.mkdir()
        np.save(d / "latents.npy", rand((4, 8, 8, 4), i))
        np.save(d / "clip_emb.npy", rand((1, 16), 10 + i))
    jds = jdata.OrbitRenderDataset(str(tmp_path), jdata.OrbitItemConfig(num_frames=4))
    pds = pdata.OrbitRenderDataset(str(tmp_path), pdata.OrbitItemConfig(num_frames=4))
    jb, pb = next(jds.iter_batches(2)), next(pds.iter_batches(2))
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(pb[k]), err_msg=k)


def test_synthetic_cli_cond_is_reference_side(tmp_path, monkeypatch):
    """ROADMAP Queue C, C3: the JAX CLI's synthetic items carry the (h, w,
    4) latent front view as ``cond_frames_without_noise`` and send it
    through CLIP, whose preprocess takes 3 channels: --data synthetic fails
    there (train_diffusion.py:85-91).  The port's synthetic orbits carry a
    seeded embedding instead, and its batches refuse items without one."""
    jb = next(jdata.SyntheticOrbitDataset(num_objects=2, num_frames=4,
                                          latent_hw=8).iter_batches(1))
    assert jb["cond_frames_without_noise"].shape == (1, 8, 8, 4)
    with pytest.raises(ValueError):
        clip_preprocess(jnp.asarray(jb["cond_frames_without_noise"]))

    class Engine:
        device = torch.device("cpu")

        @staticmethod
        def training_cond(batch, num_frames):
            return {"crossattn": torch.as_tensor(batch["cond_frames_without_noise"])}

    ds = pdata.SyntheticOrbitDataset(2, 4, 8, clip_dim=16)
    got = next(app.batches(Engine, ds, 1, 4))
    assert got["cond"]["crossattn"].shape == (1, 1, 16)
    with pytest.raises(ValueError, match="clip_emb"):
        next(app.batches(Engine, pdata.SyntheticOrbitDataset(2, 4, 8), 1, 4))
    # --checkpoint is taken (it was refused before checkpoint loading was
    # ported): the engine (here of the tiny topology) loads the file before
    # any data is read, so a missing file stops the run
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    monkeypatch.setattr(app, "build_v3d_engine",
                        lambda num_frames, device, dtype, seed, unet_overrides:
                        build_tiny_engine(num_frames, device=device, dtype=dtype,
                                          unet_overrides=unet_overrides))
    with pytest.raises(FileNotFoundError):
        app.main(["--data", "synthetic", "--num-frames", "4", "--device", "cpu",
                  "--checkpoint", str(tmp_path / "v3d.ckpt")])


@pytest.mark.parametrize("b,h,s", [(2, 3, 64), (1, 2, 100)])
def test_attention_backward_matches_jax_vjp(b, h, s):
    """flash_attention's autograd on CPU tensors (the plain forward with its
    log-sum-exp, the plain analytic backward) against jax.vjp of the bhsd
    formula."""
    q, k, v, g = (rand((b, h, s, 64), i) for i in range(4))
    _, vjp = jax.vjp(attention_bhsd, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    out = pattn.flash_attention(*ins)
    out.backward(t(g))
    for x, w in zip(ins, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD_TOL)
    o, lse = pattn.flash_attn_fwd_plain(*(t(a) for a in (q, k, v)), with_lse=True)
    got = pattn.flash_attn_bwd_plain(t(q), t(k), t(v), o, lse, t(g))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **GRAD_TOL)


def test_attention_plain_backward_chunking(monkeypatch):
    """Batch chunks of the plain backward change nothing."""
    q, k, v, g = (t(rand((5, 2, 33, 64), i)) for i in range(4))
    o, lse = pattn.flash_attn_fwd_plain(q, k, v, with_lse=True)
    whole = pattn.flash_attn_bwd_plain(q, k, v, o, lse, g)
    monkeypatch.setattr(pattn, "_LOGIT_BYTES_PER_CHUNK", 2 * 2 * 33 * 33 * 4)
    for a, b in zip(pattn.flash_attn_bwd_plain(q, k, v, o, lse, g), whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_temporal_block_backward_matches_jax_vjp():
    b, tt, s, c, heads = 1, 18, 8, 32, 2
    x = rand((b, tt, s, c), 1)
    ws = [rand((c, c), 2 + i, c ** -0.5) for i in range(4)] + [rand((c,), 6, 0.1)]
    g = rand((b, tt, s, c), 7)
    jargs = [jnp.asarray(a) for a in (x, ws[0].T, ws[1].T, ws[2].T, ws[3].T, ws[4])]
    _, vjp = jax.vjp(lambda *a: jblock(*a, heads), *jargs)
    want = vjp(jnp.asarray(g))
    ins = [t(a).requires_grad_() for a in [x] + ws]
    ptemp.temporal_block_attention(*ins, heads).backward(t(g))
    np.testing.assert_allclose(ins[0].grad.numpy(), np.asarray(want[0]), **GRAD_TOL)
    for i in range(1, 5):  # (out, in) here, (in, out) in the JAX package
        np.testing.assert_allclose(ins[i].grad.numpy().T, np.asarray(want[i]), **GRAD_TOL)
    np.testing.assert_allclose(ins[5].grad.numpy(), np.asarray(want[5]), **GRAD_TOL)


def _to_core(x, heads):
    """(b, t, s, h*d) -> the JAX core's (t, d, n) layout, n = (b, s, h)."""
    b, tt, s, hd = x.shape
    return x.reshape(b, tt, s, heads, hd // heads).transpose(1, 4, 0, 2, 3).reshape(
        tt, hd // heads, -1)


def test_temporal_core_backward_matches_jax_vjp():
    b, tt, s, heads, dh = 2, 18, 5, 2, 16
    q, k, v, g = (rand((b, tt, s, heads * dh), 10 + i) for i in range(4))
    _, vjp = jax.vjp(jcore, *(jnp.asarray(_to_core(a, heads)) for a in (q, k, v)))
    want = vjp(jnp.asarray(_to_core(g, heads)))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    ptemp.temporal_core(*ins, heads).backward(t(g))
    for x, w in zip(ins, want):
        np.testing.assert_allclose(_to_core(x.grad.numpy(), heads), np.asarray(w),
                                   **GRAD_TOL)
