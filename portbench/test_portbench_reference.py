"""The plain reference against ``v3d_tpu_torch`` on the CPU at toy widths, on
the same seeded weights (both filled by ``bench.seeded.fill_seeded_``, leaf
by leaf in the order of their names): forward outputs of every model, the
schedules, the preprocessing, a 3-step sample, and the cells' own
correctness check with the port in float32, where only rounding separates
the two."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.bench import session
from portbench.bench.seeded import fill_seeded_, leaves
from portbench.reference import clip as rclip, pipelines, unet as runet, vae as rvae
from portbench.tiny import TINY_CLIP, TINY_NET, tiny_cell

torch.set_num_threads(2)
NET = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_NET.items()}


def _pair(port_cls, ref_cls, seed=3, port_kw=None, ref_kw=None):
    port = port_cls(**(port_kw or {})).float().eval()
    ref = ref_cls(**(ref_kw or {})).float().eval()
    assert [(n, tuple(p.shape)) for n, _, _, p in leaves(port)] == \
        [(n, tuple(p.shape)) for n, _, _, p in leaves(ref)]
    return fill_seeded_(port, seed), fill_seeded_(ref, seed)


def _close(a, b, tol=1e-4):
    a, b = a.float(), b.float()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
        float((a - b).abs().max() / b.abs().max())


def test_video_unet_forward():
    from v3d_tpu_torch.models.video_unet import VideoUNet

    kw = dict(NET, adm_in_channels=768)
    port, ref = _pair(VideoUNet, runet.VideoUNet, port_kw=kw, ref_kw=kw)
    g = torch.Generator().manual_seed(0)
    t = 4
    x = torch.randn(2 * t, 8, 16, 16, generator=g)
    ts = torch.randn(2 * t, generator=g)
    ctx = torch.randn(2 * t, 1, 64, generator=g)
    y = torch.randn(2 * t, 768, generator=g)
    ind = torch.zeros(2, t)
    with torch.no_grad():
        _close(port(x, ts, ctx, y, num_video_frames=t, image_only_indicator=ind),
               ref(x, ts, ctx, y, num_video_frames=t, image_only_indicator=ind))


def test_unet2d_forward():
    from v3d_tpu_torch.models.unet2d import UNetModel

    port, ref = _pair(UNetModel, runet.UNetModel, port_kw=NET, ref_kw=NET)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 4, 16, 16, generator=g)
    ts = torch.randint(0, 1000, (4,), generator=g)
    ctx = torch.randn(4, 7, 64, generator=g)
    with torch.no_grad():
        _close(port(x, ts, ctx), ref(x, ts, ctx))


@pytest.mark.parametrize("which", ["encoder", "decoder", "video_decoder"])
def test_first_stage(which):
    from v3d_tpu_torch.models import vae

    fs = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4)
    g = torch.Generator().manual_seed(2)
    if which == "encoder":
        port, ref = _pair(vae.Encoder, rvae.Encoder, port_kw=dict(fs, double_z=True), ref_kw=fs)
        x = torch.randn(2, 3, 64, 64, generator=g)
        with torch.no_grad():
            _close(port(x), ref(x))
    elif which == "decoder":
        port, ref = _pair(vae.Decoder, rvae.Decoder, port_kw=dict(fs, out_ch=3),
                          ref_kw=dict(fs, out_ch=3))
        z = torch.randn(2, 4, 8, 8, generator=g)
        with torch.no_grad():
            _close(port(z), ref(z))
    else:
        port, ref = _pair(vae.VideoDecoder, rvae.VideoDecoder, port_kw=dict(fs, out_ch=3),
                          ref_kw=dict(fs, out_ch=3))
        z = torch.randn(4, 4, 8, 8, generator=g)
        with torch.no_grad():
            _close(port(z, 4), ref(z, 4))


def test_clip_tower_and_preprocess():
    from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer, clip_preprocess

    port, ref = _pair(CLIPVisionTransformer, rclip.CLIPVisionTransformer,
                      port_kw=TINY_CLIP, ref_kw=TINY_CLIP)
    g = torch.Generator().manual_seed(4)
    img = torch.rand(1, 64, 64, 3, generator=g) * 2 - 1
    _close(clip_preprocess(img), rclip.clip_preprocess(img), 1e-6)
    x = rclip.clip_preprocess(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        _close(port(x), ref(x))


def test_preprocess_and_schedules():
    from v3d_tpu_torch.data.preprocess import preprocess_image
    from v3d_tpu_torch.diffusion import EDMDiscretization, LegacyDDPMDiscretization
    from portbench.entries.generate import object_image

    img = object_image(7, 0, 96, {"centre": [0.4, 0.6], "axes": [0.18, 0.32], "grain": 80})
    np.testing.assert_array_equal(preprocess_image(img, 0.3, 64, device="cpu"),
                                  pipelines.preprocess_rgba(img, 0.3, 64))
    np.testing.assert_array_equal(EDMDiscretization(sigma_max=700.0)(25),
                                  pipelines.edm_sigmas(25, 0.002, 700.0))
    np.testing.assert_array_equal(LegacyDDPMDiscretization()(50)[:-1], pipelines.ddpm_sigmas(50))
    np.testing.assert_array_equal(LegacyDDPMDiscretization()(1000, do_append_zero=False,
                                                             flip=True),
                                  pipelines.ddpm_sigmas(1000)[::-1])


def test_three_step_sample():
    """Three Euler steps of the image engine against the reference's."""
    cell = tiny_cell("sd21-v768.txt2img", "float32")
    engine = cell.config_module.build_port(cell.config, "serve", "cpu", 5,
                                           sampler=dict(num_steps=3, cfg=5.0))
    ref = cell.config_module.build_reference(cell.config, "serve", "cpu", 5)
    g = torch.Generator().manual_seed(6)
    c, uc = {"crossattn": torch.randn(2, 7, 64, generator=g)}, \
        {"crossattn": torch.randn(2, 7, 64, generator=g)}
    noise = torch.randn(2, 8, 8, 4, generator=g)
    with torch.no_grad():
        got = engine.sample(c, uc, batch=2, height=64, width=64, noise=noise)
        sig = np.concatenate([pipelines.ddpm_sigmas(3), np.zeros(1, np.float32)])
        want = pipelines.euler(ref, sig, noise, c, uc, 5.0)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", ["v3d512.generate", "sd21-v768.txt2img", "v3d512.finetune"])
def test_cell_check_in_float32(name):
    """A run of the cell with the port in float32: every compared gap at
    rounding level (the frames' at uint8 rounding)."""
    cell = tiny_cell(name, "float32")
    result = session.run(cell, 2**31 + 11, 0.0, False, device="cpu")
    gaps = {k: c["value"] for k, c in result["checks"].items()}
    for k, v in gaps.items():
        assert v < (2e-2 if k == "decode" else 1e-3), gaps
