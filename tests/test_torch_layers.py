"""Port blocks (v3d_tpu_torch.models.{layers,attention_blocks,video_attention})
against their JAX counterparts, on converted non-zero random weights.

Float32 on both sides (JAX at "highest" matmul precision, tests/conftest.py).
Tolerance rtol 1e-4 / atol 1e-4 on outputs of order 1: the two frameworks
sum convolutions, matmuls and norms in different orders, which leaves
differences of ~1e-6 per op that grow through a block's residual chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    MAP_BLOCK,
    MAP_CROSS_ATTN,
    MAP_FF,
    MAP_SVT,
    MAP_VRES,
    map_resblock,
    nchw,
    nhwc,
    numpy_init_,
    rand,
    t,
    to_flax,
    video_nhwc,
)
from v3d_tpu.models import attention_blocks as JA
from v3d_tpu.models import layers as JL
from v3d_tpu.models import video_attention as JV
from v3d_tpu.models import video_unet as JU
from v3d_tpu_torch.models import attention_blocks as PA
from v3d_tpu_torch.models import layers as PL
from v3d_tpu_torch.models import video_attention as PV
from v3d_tpu_torch.models import video_unet as PU

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim,period", [(64, 10000), (33, 100)])
def test_timestep_embedding(dim, period):
    ts = rand((7,), 0, 50.0)
    ref = JL.timestep_embedding(jnp.asarray(ts), dim, max_period=period)
    got = PL.timestep_embedding(t(ts), dim, max_period=period)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm32(eps):
    x = rand((2, 6, 5, 64), 1, 3.0) + 1.5
    port = numpy_init_(PL.GroupNorm32(64, eps=eps), 2)
    ref = JL.GroupNorm32(epsilon=eps).apply(
        to_flax(port, lambda k: (("GroupNorm_0", {"weight": "scale", "bias": "bias"}[k]),
                                 lambda v: v.detach().numpy())), jnp.asarray(x))
    np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(ref), **TOL)


def test_layer_norm_f32_keeps_dtype():
    x = rand((3, 10, 48), 3)
    port = numpy_init_(PL.LayerNormF32(48), 4)
    ref = JL.LayerNormF32().apply(
        to_flax(port, lambda k: (("LayerNorm_0", {"weight": "scale", "bias": "bias"}[k]),
                                 lambda v: v.detach().numpy())), jnp.asarray(x))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(ref), **TOL)
    assert port.to(torch.bfloat16)(t(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_layer_norm_f32_on_the_cpu_is_the_f32_formula(dtype, grad):
    """On the CPU, with or without a gradient wanted, LayerNormF32 gives the
    f32 formula's result bit for bit (the upcast, F.layer_norm in f32 on
    the f32 parameters, the cast back), and with one its gradients."""
    x = t(rand((2, 9, 48), 42)).to(dtype)
    port = numpy_init_(PL.LayerNormF32(48), 43).to(dtype)

    def formula(x, w, b):
        return torch.nn.functional.layer_norm(x.float(), (48,), w.float(), b.float(),
                                              1e-5).to(x.dtype)

    want = formula(x, port.weight, port.bias)
    with torch.set_grad_enabled(grad):
        got = port(x)
    assert torch.equal(got, want) and got.dtype == dtype and got.requires_grad == grad
    if grad:
        got.float().square().sum().backward()
        w = port.weight.detach().requires_grad_()
        formula(x, w, port.bias.detach()).float().square().sum().backward()
        assert torch.equal(port.weight.grad, w.grad)


@pytest.mark.parametrize("on_card,grad_enabled,trainable,route", [
    (True, False, True, "k10"),      # sampling, conditioning: torch.no_grad()
    (True, True, False, "k10"),      # frozen weights on a constant input
    (True, True, True, "plain"),     # training's forward and its recompute
    (False, False, True, "plain"),   # CPU tensors, reference_mode()
    (False, True, True, "plain")])
def test_layer_norm_routes(monkeypatch, on_card, grad_enabled, trainable, route):
    """K10 only for card tensors with no gradient wanted: the pure route
    function, and LayerNormF32 calling the kernel's wrapper exactly there
    (the card told by ``use_plain``, as the attention routes' tests do;
    the stand-in wrapper runs the plain version)."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32_plain, layer_norm_route

    assert layer_norm_route(on_card, grad_enabled and trainable) == route
    calls = []

    def kernel(x, w, b, eps):
        calls.append(tuple(x.shape))
        return layer_norm_f32_plain(x, w, b, eps)

    monkeypatch.setattr(PL, "use_plain", lambda *tensors: not on_card)
    monkeypatch.setattr(PL, "layer_norm_f32", kernel)
    port = numpy_init_(PL.LayerNormF32(48), 44).requires_grad_(trainable)
    x = t(rand((2, 5, 48), 45))
    with torch.set_grad_enabled(grad_enabled):
        got = port(x)
    assert calls == ([(2, 5, 48)] if route == "k10" else [])
    assert torch.equal(got, layer_norm_f32_plain(x, port.weight, port.bias))


@pytest.mark.parametrize("shape", ["btc", "bcthw"])
def test_alpha_blender(shape):
    b, tt = 2, 3
    ind = np.array([[0, 1, 0], [0, 0, 1]], np.float32)
    port = numpy_init_(PL.AlphaBlender(0.5, shape), 5)
    xs_shape = (b * tt, 4, 8) if shape == "btc" else (b, tt, 2, 2, 8)
    xs, xt = rand(xs_shape, 6), rand(xs_shape, 7)
    ref = JL.AlphaBlender(alpha_shape="btc" if shape == "btc" else "bthwc").apply(
        {"params": {"mix_factor": port.mix_factor.detach().numpy()}},
        jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(ind))
    if shape == "btc":
        got = port(t(xs), t(xt), t(ind)).detach().numpy()
    else:
        to5 = lambda a: t(a).permute(0, 4, 1, 2, 3)  # noqa: E731
        got = video_nhwc(port(to5(xs), to5(xt), t(ind)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_upsample_downsample():
    x = rand((2, 6, 6, 16), 8)
    up = numpy_init_(PL.Upsample(16, 24), 9)
    down = numpy_init_(PL.Downsample(16, 24), 10)
    conv = lambda name: (lambda k: ((name, "kernel" if k.endswith("weight") else "bias"),  # noqa: E731
                                    (lambda v: v.detach().numpy().transpose(2, 3, 1, 0))
                                    if k.endswith("weight") else (lambda v: v.detach().numpy())))
    ref_up = JL.Upsample(24).apply(to_flax(up, conv("conv")), jnp.asarray(x))
    ref_down = JL.Downsample(24).apply(to_flax(down, conv("op")), jnp.asarray(x))
    np.testing.assert_allclose(nhwc(up(nchw(x))), np.asarray(ref_up), **TOL)
    np.testing.assert_allclose(nhwc(down(nchw(x))), np.asarray(ref_down), **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock_2d(cin, cout):
    x, emb = rand((3, 8, 8, cin), 11), rand((3, 40), 12)
    port = numpy_init_(PL.ResBlock(cin, 40, cout), 13)
    ref = JL.ResBlock(cout).apply(to_flax(port, map_resblock(2)),
                                  jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_allclose(nhwc(port(nchw(x), t(emb))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("skip_t_emb", [False, True])
def test_resblock_3d_temporal(skip_t_emb):
    """dims=3, kernel (3,1,1), per-frame embedding (exchange_temb_dims) or
    none (the VAE's temporal stacks)."""
    b, tt, c = 2, 4, 32
    x, emb = rand((b, tt, 4, 4, c), 14), rand((b, tt, 40), 15)
    port = numpy_init_(PL.ResBlock(c, 40, c, dims=3, kernel_size=(3, 1, 1),
                                   exchange_temb_dims=not skip_t_emb,
                                   skip_t_emb=skip_t_emb), 16)
    ref = JL.ResBlock(c, dims=3, kernel_size=(3, 1, 1),
                      exchange_temb_dims=not skip_t_emb,
                      skip_t_emb=skip_t_emb).apply(
        to_flax(port, map_resblock(3)), jnp.asarray(x),
        None if skip_t_emb else jnp.asarray(emb))
    got = port(t(x).permute(0, 4, 1, 2, 3), None if skip_t_emb else t(emb))
    np.testing.assert_allclose(video_nhwc(got), np.asarray(ref), **TOL)


def test_video_resblock():
    b, tt, cin, cout = 2, 3, 32, 64
    x, emb = rand((b * tt, 4, 4, cin), 17), rand((b * tt, 40), 18)
    ind = np.zeros((b, tt), np.float32)
    ind[1, 0] = 1
    port = numpy_init_(PU.VideoResBlock(cin, 40, cout), 19)
    ref = JU.VideoResBlock(cout, num_frames=tt).apply(
        to_flax(port, MAP_VRES), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(ind))
    got = port(nchw(x), t(emb), tt, t(ind))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("route", ["kernel", "cross", "short"])
def test_cross_attention_routes(route):
    """Self-attention at 1024 tokens, dim_head 64 is K1's route (bhsd layout,
    attention_blocks.py:98-108); cross-attention and short sequences take
    the plain formula.  All three match the JAX module."""
    heads, dh, c = 2, 64 if route != "short" else 16, 48
    s = 1024 if route == "kernel" else 40
    x = rand((1, s, c), 20)
    ctx = rand((1, 3, 24), 21) if route == "cross" else None
    port = numpy_init_(PA.CrossAttention(c, 24 if ctx is not None else None,
                                         heads, dh), 22)
    ref = JA.CrossAttention(heads, dh).apply(
        to_flax(port, MAP_CROSS_ATTN), jnp.asarray(x),
        None if ctx is None else jnp.asarray(ctx))
    got = port(t(x), None if ctx is None else t(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_geglu_uses_tanh_gelu():
    """The JAX GEGLU gates with flax's default tanh GELU (a reference-side
    difference from sgm's exact form); the port matches JAX, and the two
    forms do differ at this input scale."""
    x = rand((4, 7, 16), 23, 2.0)
    port = numpy_init_(PA.FeedForward(16), 24)
    ref = JA.FeedForward().apply(to_flax(port, MAP_FF), jnp.asarray(x))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(ref), **TOL)
    gate = torch.tensor([-1.5])
    assert abs(float(torch.nn.functional.gelu(gate, approximate="tanh")) + 0.100428) < 1e-5
    assert abs(float(torch.nn.functional.gelu(gate)) + 0.100211) < 1e-5


def test_basic_transformer_block():
    x, ctx = rand((2, 20, 32), 25), rand((2, 1, 24), 26)
    port = numpy_init_(PA.BasicTransformerBlock(32, 2, 16, 24), 27)
    ref = JA.BasicTransformerBlock(2, 16).apply(
        to_flax(port, MAP_BLOCK), jnp.asarray(x), jnp.asarray(ctx))
    np.testing.assert_allclose(port(t(x), t(ctx)).detach().numpy(),
                               np.asarray(ref), **TOL)


def test_spatial_transformer():
    x, ctx = rand((2, 6, 6, 32), 28), rand((2, 1, 24), 29)
    port = numpy_init_(PA.SpatialTransformer(32, 2, 16, depth=2, context_dim=24), 30)
    ref = JA.SpatialTransformer(2, 16, depth=2).apply(
        to_flax(port, MAP_SVT), jnp.asarray(x), jnp.asarray(ctx))
    np.testing.assert_allclose(nhwc(port(nchw(x), t(ctx))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s,heads", [(64, 2), (36, 2), (64, 10)])
def test_temporal_self_attention_both_gates(s, heads):
    """s % 64 == 0 with <= 8 heads is K2's route (the fused block), anything
    else K3's (matmul projections + attention core), as in
    video_attention.py:96.  Both match the JAX module, which takes its own
    fused block / core reference on the CPU."""
    dh = 8
    c = heads * dh
    x = rand((2, 18, s, c), 31)
    port = numpy_init_(PV.TemporalSelfAttention(c, heads, dh), 32)
    ref = JV.TemporalSelfAttention(heads, dh).apply(
        to_flax(port, MAP_CROSS_ATTN), jnp.asarray(x))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(ref), **TOL)


def test_temporal_cross_attention_unrepeated_context():
    x, ctx = rand((2, 5, 9, 32), 33), rand((2, 2, 24), 34)
    port = numpy_init_(PV.TemporalCrossAttention(32, 24, 2, 16), 35)
    ref = JV.TemporalCrossAttention(2, 16).apply(
        to_flax(port, MAP_CROSS_ATTN), jnp.asarray(x), jnp.asarray(ctx))
    np.testing.assert_allclose(port(t(x), t(ctx)).detach().numpy(),
                               np.asarray(ref), **TOL)


def test_video_transformer_block():
    b, tt = 2, 5
    x, ctx = rand((b * tt, 12, 32), 36), rand((b, 1, 24), 37)
    port = numpy_init_(PV.VideoTransformerBlock(32, 2, 16, 24), 38)
    ref = JV.VideoTransformerBlock(2, 16, num_frames=tt).apply(
        to_flax(port, MAP_BLOCK), jnp.asarray(x), jnp.asarray(ctx))
    np.testing.assert_allclose(port(t(x), tt, t(ctx)).detach().numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw,heads,dh", [(8, 2, 16), (6, 4, 8)])
def test_spatial_video_transformer(hw, heads, dh):
    """8x8 = 64 pixels with 2 heads runs the fused temporal route (K2), 6x6
    the core route (K3)."""
    b, tt, c = 2, 4, heads * dh
    x = rand((b * tt, hw, hw, c), 39)
    ctx = rand((b * tt, 1, 24), 40)
    ind = np.zeros((b, tt), np.float32)
    port = numpy_init_(PV.SpatialVideoTransformer(c, heads, dh, context_dim=24), 41)
    ref = JV.SpatialVideoTransformer(heads, dh, num_frames=tt).apply(
        to_flax(port, MAP_SVT), jnp.asarray(x), jnp.asarray(ctx), None,
        jnp.asarray(ind))
    got = port(nchw(x), t(ctx), tt, t(ind))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_unet_layer_specs_match():
    args = (320, (1, 2, 4, 4), 2, (4, 2, 1), 64)
    assert PU.unet_layer_specs(*args) == JU.unet_layer_specs(*args)
