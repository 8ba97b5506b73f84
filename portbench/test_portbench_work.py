"""The yardstick's work counts: the bounds of the kernels' work functions at
the shapes of PERF.md's kernel table, and the model FLOPs that
``FlopCounterMode`` reads from the plain reference on the meta device,
against the same count over the port's own modules (at full width, no
storage).  The two counts differ by 0.004% of a V3D forward: the port's
cross-attention over V3D's one context token is an einsum that PyTorch
lowers partly without a batched product, which ``FlopCounterMode`` does
not count; the reference's batched products count it."""

from __future__ import annotations

import pytest
import torch

from portbench.bench import manifest
from portbench.bench.work import (
    PEAK_BF16,
    attention_work,
    bound_ms,
    flash_bwd_work,
    group_norm_work,
    k1_sites,
    model_work,
)


def test_bounds_of_the_kernel_table():
    assert bound_ms(*attention_work(36, 5, 4096, 4096, 64, 2), PEAK_BF16)[0] == \
        pytest.approx(0.7817, abs=1e-4)
    assert bound_ms(*attention_work(36, 10, 1024, 1024, 64, 2))[0] == pytest.approx(0.0977, abs=1e-4)
    ms, by = bound_ms(*group_norm_work((36, 320, 64, 64), False, 2, 2))
    assert (round(ms, 4), by) == (0.0563, "bytes")
    assert bound_ms(*flash_bwd_work(18, 5, 4096, 3))[0] == pytest.approx(0.5863, abs=1e-4)
    assert bound_ms(*flash_bwd_work(18, 5, 4096, 4))[0] == pytest.approx(0.7817, abs=1e-4)


def _flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _port_v3d(cfg):
    from v3d_tpu_torch.engines.builder import build_v3d_engine

    net = dict(cfg["network"])
    mc = net.pop("model_channels")
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in net.items()}
    return build_v3d_engine(model_channels=mc, device="meta", dtype=torch.bfloat16,
                            unet_overrides=net)


META = torch.device("meta")


def test_v3d_flops_reference_against_the_port():
    from v3d_tpu_torch.ops._dispatch import meta_shapes

    cfg = manifest.load_cell("v3d512.generate").config
    ref = manifest.load_cell("v3d512.generate").config_module.build_reference(
        cfg, "serve", "meta", 0)
    port = _port_v3d(cfg)
    rows, t = 36, 18
    args = (torch.empty(rows, 8, 64, 64, device=META), torch.empty(rows, device=META))
    kw = dict(context=torch.empty(rows, 1, 1024, device=META),
              y=torch.empty(rows, 768, device=META), num_video_frames=t,
              image_only_indicator=torch.zeros(2, t, device=META))
    work = model_work(lambda: ref.unet(*args, **kw), ref.unet)
    ref_unet = work["flops"]
    assert len(k1_sites(work["attention"])) == 10      # ds1 and ds2: K1 250 a generation
    assert len(work["group_norm"]) == 105                # K6 105 a forward
    ref_dec = model_work(lambda: [ref.decoder(torch.empty(6, 4, 64, 64, device=META), 6)
                                  for _ in range(3)], ref.decoder)["flops"]
    with meta_shapes():
        port_unet = _flops(lambda: port.unet(*(a.bfloat16() for a in args),
                                             **{k: (v.bfloat16() if k in ("context", "y") else v)
                                                for k, v in kw.items()}))
        port_dec = _flops(lambda: [port.vae_decoder(
            torch.empty(6, 4, 64, 64, device=META, dtype=torch.bfloat16), 6) for _ in range(3)])
    assert ref_unet == pytest.approx(port_unet, rel=1e-4)
    assert ref_dec == pytest.approx(port_dec, rel=1e-6)
    assert ref_unet / 1e12 == pytest.approx(45.58, abs=0.01)
    assert ref_dec / 1e12 == pytest.approx(54.77, abs=0.01)


def test_sd21_flops_reference_against_the_port():
    from v3d_tpu_torch.models.unet2d import UNetModel
    from v3d_tpu_torch.models.vae import Decoder
    from v3d_tpu_torch.ops._dispatch import meta_shapes

    cell = manifest.load_cell("sd21-v768.txt2img")
    ref = cell.config_module.build_reference(cell.config, "serve", "meta", 0)
    with torch.device("meta"):
        unet, dec = UNetModel().bfloat16(), Decoder(out_ch=3).bfloat16()
    x, ts = torch.empty(8, 4, 96, 96, device=META), torch.empty(8, device=META)
    ctx = torch.empty(8, 77, 1024, device=META)
    z = torch.empty(4, 4, 96, 96, device=META)
    work = model_work(lambda: ref.unet(x, ts, context=ctx), ref.unet)
    ref_unet = work["flops"]
    assert len(k1_sites(work["attention"])) == 5       # ds1 only: ds2's 2304 tokens are not
    assert len(work["group_norm"]) == 61                 # a multiple of 512; K6 61 a forward
    ref_dec = model_work(lambda: ref.decoder(z), ref.decoder)["flops"]
    with meta_shapes():
        port_unet = _flops(lambda: unet(x.bfloat16(), ts, context=ctx.bfloat16()))
        port_dec = _flops(lambda: dec(z.bfloat16()))
    assert ref_unet == pytest.approx(port_unet, rel=1e-6)
    assert ref_dec == pytest.approx(port_dec, rel=1e-6)
    assert ref_unet / 1e12 == pytest.approx(17.19, abs=0.01)
    assert ref_dec / 1e12 == pytest.approx(23.02, abs=0.01)
