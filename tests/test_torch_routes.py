"""The slice as a whole under every attention routing: a tiny VideoUNet (dim
head 64, its top level at 32^2 latents = 1024 tokens, so the kernel routes
K1/T1, T2 and T4 take their branches and not the fallback) and a tiny VAE
(mid-block attention d = 128), port against the JAX package, under the
default routing, ``set_proj_layout("bshd")``, ``set_default_backend("flash")``
in both layouts, ``"packed"`` and ``set_spatial_override("packed")``; and one
gradient check under "flash".

Both sides route as on their accelerator: the JAX pickers are told they run
on a TPU, its Pallas forwards run in interpret mode and the stock TPU flash
kernel (T1, not runnable on a CPU) is replaced by its own reference
``mha_reference``; the port is told its tensors are on the card, and each
kernel wrapper counts its call and runs its plain version.  The counts must
equal what chip_smoke.py expects on the card (``forward_launches``, walked
from the modules), and the JAX side's kernel calls must match them.

Tolerances: float32, rtol/atol 2e-4 on outputs of order 1, as
tests/test_torch_models.py (tens of convolutions and norms summed in another
order); gradients rtol 2e-3 / atol 2e-4, as the JAX flash tests."""

import importlib.util
from pathlib import Path

import jax
import jax.experimental.pallas.ops.tpu.flash_attention as stock
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    MAP_BLOCK,
    MAP_ENCODER,
    MAP_UNET,
    MAP_VIDEO_DECODER,
    TPUJax,
    nchw,
    nhwc,
    numpy_init_,
    rand,
    t,
    to_flax,
)
from v3d_tpu.models import attention_blocks as jblocks
from v3d_tpu.models import vae as JVAE
from v3d_tpu.models.video_unet import VideoUNet as JUNet
from v3d_tpu.ops import attention as jattn
from v3d_tpu.ops import flash_attention as jfa
from v3d_tpu_torch.models import attention_blocks as pblocks
from v3d_tpu_torch.models import vae as PVAE
from v3d_tpu_torch.models.video_unet import VideoUNet as PUNet
from v3d_tpu_torch.ops import LAUNCHES, group_norm, reset_launch_counts
from v3d_tpu_torch.ops import attention as pattn
from v3d_tpu_torch.ops import flash_attention as pfa
from v3d_tpu_torch.ops import temporal_attention as pta

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
UNET = dict(model_channels=64, num_res_blocks=1, attention_resolutions=(2, 1),
            channel_mult=(1, 2), num_head_channels=64, context_dim=32,
            adm_in_channels=768)
VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
CONFIGS = {name: cfg for name, *cfg in CHIP_SMOKE.ROUTE_CONFIGS}


@pytest.fixture
def accelerators(monkeypatch):
    """Both packages routing as on their accelerator; returns the JAX side's
    kernel calls (T1 the stock kernel, T2, T4)."""
    calls = {"T1": 0, "T2": 0, "T4": 0}
    for tag, name in (("T2", "_flash_forward"), ("T4", "_flash_packed_forward")):
        def run(*args, _orig=getattr(jfa, name), _tag=tag):
            calls[_tag] += 1
            return _orig(*args, interpret=True)

        monkeypatch.setattr(jfa, name, run)

    def stock_kernel(q, k, v, ab=None, segment_ids=None, *, causal=False,
                     sm_scale=1.0, block_sizes=None, debug=False):
        calls["T1"] += 1
        return stock.mha_reference(q, k, v, ab, segment_ids, causal=causal,
                                   sm_scale=sm_scale)

    monkeypatch.setattr(stock, "flash_attention", stock_kernel)
    monkeypatch.setattr(jattn, "jax", TPUJax())
    monkeypatch.setattr(pattn, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(pblocks, "use_plain", lambda *tensors: False)
    for mod, name, key in ((pattn, "flash_attn_fwd", "flash_attn_fwd"),
                           (pfa, "flash_attn_fwd", "flash_attn_fwd"),
                           (pfa, "flash_attn_fwd_wide", "flash_attn_fwd_wide"),
                           (pta, "temporal_core_fwd", "temporal_core"),
                           (pta, "temporal_block_fwd", "temporal_block"),
                           (group_norm, "group_norm_fwd", "group_norm")):
        def counted(*args, _orig=getattr(mod, name), _key=key, **kw):
            LAUNCHES[_key] += 1
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    reset_launch_counts()
    yield calls
    reset_launch_counts()


def _set_routing(layout, backend, override):
    for blocks in (jblocks, pblocks):
        blocks.set_proj_layout(layout)
    for attn in (jattn, pattn):
        attn.set_default_backend(backend)
        attn.set_spatial_override(override)


@pytest.fixture
def routing():
    """Sets the three setters on both sides; restores the defaults."""
    yield _set_routing
    _set_routing("bhsd", "auto", None)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_unet_under_routing(accelerators, routing, config):
    routing(*CONFIGS[config])
    tt, hw = 2, 32
    b = 2 * tt
    port = numpy_init_(PUNet(**UNET), 1)
    x, ts = rand((b, hw, hw, 8), 2), rand((b,), 3, 0.5)
    ctx, y = rand((b, 1, UNET["context_dim"]), 4), rand((b, 768), 5)
    ind = np.zeros((2, tt), np.float32)
    ref = JUNet(**UNET).apply(to_flax(port, MAP_UNET), jnp.asarray(x), jnp.asarray(ts),
                              jnp.asarray(ctx), jnp.asarray(y), num_video_frames=tt,
                              image_only_indicator=jnp.asarray(ind))
    with torch.no_grad():
        got = port(nchw(x), t(ts), t(ctx), t(y), tt, t(ind))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    counts = dict(LAUNCHES)
    assert counts == CHIP_SMOKE.forward_launches(port, hw, dtype=torch.float32)
    assert counts["flash_attn_fwd_wide"] == 0
    # 7 spatial transformers, 3 of them at 1024 tokens; each a self- and a
    # cross-attention site: the JAX kernel that runs at each, by configuration
    n, n1 = 7, 3
    assert sum(isinstance(m, pblocks.BasicTransformerBlock) for m in port.modules()) == n
    want = {"default": dict(T1=n1), "bshd (r4)": dict(T1=n1), "flash": dict(T2=2 * n),
            "flash, bshd": dict(T2=2 * n), "packed": dict(T1=n1, T4=2 * n - n1),
            "spatial override packed": dict(T2=n1)}[config]
    assert accelerators == {"T1": 0, "T2": 0, "T4": 0, **want}
    assert counts["flash_attn_fwd"] == sum(accelerators.values())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_vae_under_routing(accelerators, routing, config):
    """The VAE's mid-block attention (single head, d = 128): K9's route under
    "flash" (T2) and "packed" (T4), the plain formula otherwise."""
    routing(*CONFIGS[config])
    tt = 3
    enc = numpy_init_(PVAE.Encoder(**VAE_KW), 6)
    dec = numpy_init_(PVAE.VideoDecoder(out_ch=3, **VAE_KW), 8)
    x, z = rand((1, 32, 32, 3), 7), rand((tt, 4, 4, 4), 9)
    ref_m = JVAE.Encoder(**VAE_KW).apply(to_flax(enc, MAP_ENCODER), jnp.asarray(x))
    ref_x = JVAE.VideoDecoder(out_ch=3, num_frames=tt, **VAE_KW).apply(
        to_flax(dec, MAP_VIDEO_DECODER), jnp.asarray(z))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(enc(nchw(x))), np.asarray(ref_m), **TOL)
        np.testing.assert_allclose(nhwc(dec(nchw(z), tt)), np.asarray(ref_x), **TOL)
    backend = CONFIGS[config][1]
    wide = 2 if backend in ("flash", "packed") else 0
    assert LAUNCHES["flash_attn_fwd_wide"] == wide
    assert LAUNCHES["flash_attn_fwd"] == 0
    assert accelerators == {"T1": 0, "T2": wide * (backend == "flash"),
                            "T4": wide * (backend == "packed")}
    assert sum(CHIP_SMOKE.vae_sites(m, 4 * 4)["flash_attn_fwd_wide"]
               for m in (enc, dec)) == wide


def test_block_gradients_under_flash(accelerators, routing):
    """One fine-tune gradient under set_default_backend("flash"): a
    BasicTransformerBlock at 1024 tokens (self-attention T2 in the bhsd
    layout, cross-attention T2 on one context token), every parameter's and
    the input's gradient against jax.grad through the JAX custom VJPs."""
    routing("bhsd", "flash", None)
    x, ctx = rand((2, 1024, 64), 10, 0.5), rand((2, 1, 24), 11)
    w = rand((2, 1024, 64), 12)
    port = numpy_init_(pblocks.BasicTransformerBlock(64, 1, 64, 24), 13)
    params = to_flax(port, MAP_BLOCK)

    def loss(params, x):
        out = jblocks.BasicTransformerBlock(1, 64).apply(params, x, jnp.asarray(ctx))
        return jnp.sum(out * jnp.asarray(w))

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    assert accelerators["T2"] == 2
    xt = t(x).requires_grad_()
    (port(xt, t(ctx)) * t(w)).sum().backward()
    assert LAUNCHES["flash_attn_fwd"] == 2
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=2e-3, atol=2e-4)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(g_params["params"])[0]:
        want[tuple(getattr(p, "key", p) for p in path)] = np.asarray(leaf)
    for key, p in port.named_parameters():
        path, fn = MAP_BLOCK(key)
        np.testing.assert_allclose(fn(p.grad), want[path], rtol=2e-3,
                                   atol=2e-4, err_msg=key)
