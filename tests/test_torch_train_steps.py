"""The port's DiffusionTrainer against the JAX package's, and its elastic
resume, on the CPU in float32 with the tiny engine.

- Three ``train_step``s of both trainers from the same UNet weights on the
  same batches, with gradient clipping at 2.8 (the steps' norms are 2.84,
  2.81, 2.76: two steps clip, one does not); the JAX step draws from its
  rng, the test computes those draws and hands them to the port.  Tolerances: each step's loss and
  gradient norm rel 1e-4 (the engine parity test's bound); after the three
  steps every parameter and EMA tensor within 2e-6 abs (2% of the 1e-4
  learning rate: AdamW moves each weight by ~lr m/sqrt(v), and the gradients
  agree to ~1e-4 relative) plus 1e-5 relative.  Elements whose true gradient
  is 0 (< 1e-6 of the largest) are held to the 2 lr that two full-rate steps
  can move them: Adam turns a gradient of rounding noise into a move of up
  to lr whatever its sign.  Most such elements fill whole tensors that get
  an exact 0 on both sides and do not move (the cross-attentions attend to
  one CLIP token, so their to_q / to_k and the norm before them have no
  gradient); the noisy ones are conv biases right before a GroupNorm of one
  channel per group, and single weights such as a temporal emb_layers entry
  whose gradient sums to ~1e-8 (its sqrt(v) 3e-9 against the tensor's
  median 2e-6).
- A run interrupted at step 3 and resumed by a fresh trainer from its
  checkpoint equals the uninterrupted 6-step run exactly (the step noise is
  seeded from (seed, step), the CPU math is deterministic), optimizer
  moments included, as tests/test_elastic.py:61 holds the JAX trainer.
- chip_smoke.py's per-step launch counts, counted from the modules, equal
  the calls of each kernel's forward on a UNet whose attention takes the
  kernels' sites (d 64, 1024 tokens), with and without checkpointing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from torch_port_helpers import MAP_UNET, numpy_init_, to_flax
from v3d_tpu.diffusion.sigma_sampling import EDMSampling
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.engines.trainer import DiffusionTrainer as JTrainer
from v3d_tpu.engines.trainer import TrainConfig as JConfig
from v3d_tpu.parallel.mesh import single_device_mesh
from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
from v3d_tpu_torch.diffusion import Denoiser, VScalingWithEDMcNoise
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.trainer import (
    DiffusionTrainer,
    TrainConfig,
    latest_checkpoint,
    prune_checkpoints,
)
from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine
from v3d_tpu_torch.models import attention_blocks
from v3d_tpu_torch.models.video_unet import VideoUNet
from v3d_tpu_torch.ops import attention, group_norm, temporal_attention

T, HW = 4, 8


def _flax_get(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _batches(n):
    ds = SyntheticOrbitDataset(num_objects=3, num_frames=T, latent_hw=HW, seed=1,
                               clip_dim=64)
    it = ds.iter_batches(1)
    return [next(it) for _ in range(n)]


def test_three_steps_match_the_jax_trainer():
    engine = build_tiny_engine(num_frames=T, device="cpu")
    numpy_init_(engine.unet, 21)
    jengine = jax_tiny_engine(num_frames=T, resolution=64)
    jt = JTrainer(jengine, to_flax(engine.unet, MAP_UNET),
                  JConfig(log_every=1, grad_clip=2.8), mesh=single_device_mesh(),
                  num_frames=T)
    pt = DiffusionTrainer(engine, TrainConfig(log_every=1, grad_clip=2.8), num_frames=T)
    clipped = 0
    for i, batch in enumerate(_batches(3)):
        rng = jax.random.PRNGKey(30 + i)
        latents = batch["latents"]
        jstats = jt.train_step(rng, jnp.asarray(latents),
                               jengine.training_cond(batch, num_frames=T))
        k_sig, k_noise, _ = jax.random.split(rng, 3)
        sigmas = np.asarray(EDMSampling(p_mean=1.5, p_std=2.0)(k_sig, latents.shape[0]))
        noise = np.asarray(jax.random.normal(k_noise, latents.shape))
        pstats = pt.train_step(torch.tensor(latents),
                               engine.training_cond(batch, num_frames=T),
                               sigmas=torch.tensor(sigmas), noise=torch.tensor(noise))
        assert pstats["step"] == jt.step == i + 1
        assert pstats["loss"] == pytest.approx(jstats["loss"], rel=1e-4)
        assert pstats["grad_norm"] == pytest.approx(jstats["grad_norm"], rel=1e-4)
        clipped += pstats["grad_norm"] >= 2.8
    assert clipped == 2
    top = max(float(p.grad.abs().max()) for p in pt.params)
    noise_floor = 0
    for name, p, shadow in zip(pt.names, pt.params, pt.ema):
        path, fn = MAP_UNET(name)
        zero_grad = np.abs(np.asarray(fn(p.grad))) < 1e-6 * top
        noise_floor += bool(zero_grad.all())
        atol = np.where(zero_grad, 2e-4, 2e-6)
        for got, tree in ((p, jt.params), (shadow, jt.ema_params)):
            a = np.asarray(fn(got.detach()))
            b = np.asarray(_flax_get(tree["params"], path))
            err = np.abs(a - b) - (atol + 1e-5 * np.abs(b))
            assert float(err.max()) <= 0, (name, float(np.abs(a - b).max()))
    assert noise_floor < len(pt.params) // 5, noise_floor


def _fit(trainer, steps, batch):
    def stream():
        while True:
            yield batch

    trainer.fit(stream(), max_steps=steps, log_fn=lambda s: None)


def test_resume_equals_uninterrupted_run(tmp_path):
    batch = _batches(1)[0]

    def make(cfg):
        engine = build_tiny_engine(num_frames=T, device="cpu")
        return DiffusionTrainer(engine, cfg, num_frames=T), {
            "latents": torch.tensor(batch["latents"]),
            "cond": engine.training_cond(batch, num_frames=T)}

    a, data = make(TrainConfig(log_every=100))
    _fit(a, 6, data)
    ckdir = str(tmp_path / "ck")
    cfg = TrainConfig(log_every=100, ckpt_dir=ckdir, ckpt_every=3, keep_last=2)
    b, data = make(cfg)
    _fit(b, 3, data)
    assert latest_checkpoint(ckdir).endswith("step_3.pt")
    c, data = make(cfg)                  # a fresh process: auto-resume at step 3
    _fit(c, 6, data)
    assert c.step == 6
    for x, y in zip(list(a.params) + a.ema, list(c.params) + c.ema):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    sa, sc = a.opt.state_dict()["state"], c.opt.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[i][k], sc[i][k], rtol=0, atol=0)


def test_latest_and_prune(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("step_2.pt", "step_10.pt", "step_6.pt", "step_junk.pt",
                 "other_4.pt", "step_99.pt.tmp-123"):
        (tmp_path / name).write_text("x")
    assert latest_checkpoint(str(tmp_path)).endswith("step_10.pt")
    prune_checkpoints(str(tmp_path), keep=2)
    names = {p.name for p in tmp_path.iterdir()}
    assert "step_2.pt" not in names and {"step_6.pt", "step_10.pt"} <= names
    assert "step_99.pt.tmp-123" in names


@pytest.mark.parametrize("hw", [32, 40])
@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_chip_smoke_launch_counts(monkeypatch, hw, use_checkpoint):
    """At 32^2 the ds1 attention has 1024 tokens (K1, K7, K8; K2 at both
    levels); at 40^2, 1600 tokens (no K1) and 400 at ds2 (K3)."""
    calls = {k: 0 for k in ("flash_attn_fwd", "flash_attn_bwd", "temporal_block",
                            "temporal_core", "group_norm")}

    def counting(mod, fn_name, key):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, fn_name, wrapped)

    # route as on the card: CPU tensors take the pickers' "xla" route
    monkeypatch.setattr(attention, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(attention_blocks, "use_plain", lambda *tensors: False)
    counting(attention, "flash_attn_fwd", "flash_attn_fwd")
    counting(attention, "flash_attn_bwd", "flash_attn_bwd")
    counting(temporal_attention, "temporal_block_fwd", "temporal_block")
    counting(temporal_attention, "temporal_core_fwd", "temporal_core")
    counting(group_norm, "group_norm_fwd", "group_norm")
    t = 2
    torch.manual_seed(0)
    unet = VideoUNet(in_channels=8, model_channels=64, num_res_blocks=1,
                     attention_resolutions=(2, 1), channel_mult=(1, 2),
                     num_head_channels=64, context_dim=32,
                     use_checkpoint=use_checkpoint)
    engine = VideoDiffusionEngine(
        unet=unet, denoiser=Denoiser(VScalingWithEDMcNoise()), sampler=None,
        vae_encoder=None, vae_decoder=None, clip=None, num_frames=t,
        loss_fn=build_tiny_engine(device="cpu").loss_fn)
    cond = {"crossattn": torch.randn(t, 1, 32), "concat": torch.randn(t, hw, hw, 4),
            "vector": torch.randn(t, 768)}
    engine.training_loss(torch.randn(t, hw, hw, 4), cond,
                         sigmas=torch.ones(t), noise=torch.randn(t, hw, hw, 4)).backward()
    want = chip_smoke.train_launches(unet, hw, use_checkpoint)
    assert calls == {"flash_attn_fwd": want["flash_attn_fwd"],
                     "flash_attn_bwd": want["flash_attn_bwd_dq"],
                     "temporal_block": want["temporal_block"],
                     "temporal_core": want["temporal_core"],
                     "group_norm": want["group_norm"]}
    assert want["flash_attn_bwd_dq"] == want["flash_attn_bwd_dkv"]
    assert (want["flash_attn_fwd"] > 0) == (hw == 32)
    assert (want["temporal_core"] > 0) == (hw == 40)
