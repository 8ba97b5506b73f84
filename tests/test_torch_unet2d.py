"""The port's image UNet (v3d_tpu_torch/models/unet2d.py) against the JAX
package's ``UNetModel`` (v3d_tpu/models/unet2d.py), f32 on the CPU at tiny
widths: every JAX leaf replaced by a seeded normal (the JAX init zeroes the
out convs), carried over by ``state_dict_from_jax(..., "unet2d")`` (the JAX
package has no converter of its own for this UNet), the same numpy inputs.
Also the "unet2d" key map both ways, ``expand_unet_input_channels``, the
SpatialTransformer's SD 1.x options and the full-width counts that
chip_smoke's phase 21 prints and checks."""

import collections
import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import v3d_tpu_torch
from torch_port_helpers import nchw, nhwc, rand, t
from v3d_tpu.core import convert as jc
from v3d_tpu.models import attention_blocks as JA
from v3d_tpu.models import layers as JL
from v3d_tpu.models.unet2d import UNetModel as JUNet
from v3d_tpu_torch.core import keymap
from v3d_tpu_torch.core.convert import expand_unet_input_channels, state_dict_from_jax
from v3d_tpu_torch.models import attention_blocks as PA
from v3d_tpu_torch.models import layers as PL
from v3d_tpu_torch.models.unet2d import UNetModel

RTOL = 1e-5
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
            context_dim=24)


def randomize(params, seed: int):
    """Every leaf of a Flax tree replaced by N(0, 1/fan_in) from numpy
    (fan_in: the product of all but the last dimension)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1])))
                   ).astype(np.float32), params)


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def tiny_pair(seed=0, batch=2, hw=8, **overrides):
    kw = dict(TINY, **overrides)
    j = JUNet(**kw)
    x = rand((batch, hw, hw, kw["in_channels"]), seed)
    ts = np.linspace(3.0, 900.0, batch).astype(np.float32)
    ctx = rand((batch, 5, kw["context_dim"]), seed + 1)
    y = rand((batch, kw["adm_in_channels"]), seed + 2) if kw.get("adm_in_channels") else None
    params = randomize(j.init(jax.random.PRNGKey(seed), x, ts, ctx, y), seed + 3)
    m = UNetModel(**kw)
    m.load_state_dict(state_dict_from_jax(params, "unet2d", m))
    return j, params, m.eval(), (x, ts, ctx, y)


def port_forward(m, x, ts, ctx, y):
    with torch.no_grad():
        return nhwc(m(nchw(x), t(ts), t(ctx), None if y is None else t(y)))


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "conv_proj"])
@pytest.mark.parametrize("scale_shift", [False, True], ids=["add_emb", "scale_shift"])
@pytest.mark.parametrize("adm", [None, 12], ids=["no_adm", "adm12"])
def test_unet2d_matches_jax(linear, scale_shift, adm):
    j, params, m, (x, ts, ctx, y) = tiny_pair(
        use_linear_in_transformer=linear, use_scale_shift_norm=scale_shift,
        adm_in_channels=adm)
    ref = np.asarray(j.apply(params, x, ts, ctx, y))
    out = port_forward(m, x, ts, ctx, y)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert rel(out, ref) <= RTOL


def test_unet2d_depth2_three_levels_matches_jax():
    j, params, m, (x, ts, ctx, y) = tiny_pair(
        seed=5, hw=16, transformer_depth=2, channel_mult=(1, 2, 2),
        attention_resolutions=(4, 1))
    assert rel(port_forward(m, x, ts, ctx, y), np.asarray(j.apply(params, x, ts, ctx, y))) <= RTOL


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "conv_proj"])
@pytest.mark.parametrize("no_self", [False, True], ids=["self_attn", "disable_self_attn"])
def test_spatial_transformer_options_match_jax(linear, no_self):
    """SD 1.x's 1x1-conv projections and ``disable_self_attn`` (attn1
    attends to the context), against JAX's SpatialTransformer."""
    x, ctx = rand((2, 6, 6, 32), 0), rand((2, 7, 24), 1)
    j = JA.SpatialTransformer(heads=2, dim_head=16, use_linear=linear,
                              disable_self_attn=no_self)
    params = randomize(j.init(jax.random.PRNGKey(0), x, ctx), 3)
    m = PA.SpatialTransformer(32, 2, 16, 1, 24, use_linear=linear,
                              disable_self_attn=no_self)
    state = {}
    for key in m.state_dict():
        path, fn = keymap._map_spatial_transformer(key, (), linear)
        leaf = params["params"]
        for p in path:
            leaf = leaf[p]
        state[key] = torch.from_numpy(np.ascontiguousarray(
            jc_inverse(fn)(np.asarray(leaf))))
    m.load_state_dict(state)
    with torch.no_grad():
        out = nhwc(m(nchw(x), t(ctx)))
    assert rel(out, np.asarray(j.apply(params, x, ctx))) <= RTOL


def jc_inverse(fn):
    from v3d_tpu_torch.core.convert import _INVERSES

    return _INVERSES[fn]


def test_scale_shift_resblock_matches_jax():
    x, emb = rand((2, 6, 6, 32), 0), rand((2, 20), 1)
    j = JL.ResBlock(out_channels=64, use_scale_shift_norm=True)
    params = randomize(j.init(jax.random.PRNGKey(0), x, emb), 2)
    m = PL.ResBlock(32, 20, 64, use_scale_shift_norm=True)
    state = {}
    for key in m.state_dict():
        path, fn = keymap._map_plain_resblock(key, ())
        leaf = params["params"]
        for p in path:
            leaf = leaf[p]
        state[key] = torch.from_numpy(np.ascontiguousarray(jc_inverse(fn)(np.asarray(leaf))))
    m.load_state_dict(state)
    assert m.emb_layers[1].out_features == 128 and isinstance(m.out_layers[1], torch.nn.SiLU)
    with torch.no_grad():
        out = nhwc(m(nchw(x), t(emb)))
    assert rel(out, np.asarray(j.apply(params, x, emb))) <= RTOL


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "conv_proj"])
def test_unet2d_key_map_reaches_every_leaf_once(linear):
    """Every port key maps to a Flax leaf of the JAX UNetModel's tree, no
    leaf twice, none left over; and the map runs both ways: the port's
    state dict through the map's transforms and back through
    ``state_dict_from_jax`` is itself."""
    kw = dict(TINY, adm_in_channels=12, use_scale_shift_norm=True,
              use_linear_in_transformer=linear)
    j = JUNet(**kw)
    x, ts = np.zeros((1, 8, 8, 4), np.float32), np.zeros((1,), np.float32)
    params = j.init(jax.random.PRNGKey(0), x, ts, np.zeros((1, 3, 24), np.float32),
                    np.zeros((1, 12), np.float32))
    leaves = set(_leaf_paths(jax.tree_util.tree_map(np.asarray, params)["params"]))
    m = UNetModel(**kw)
    torch.manual_seed(0)
    for p in m.parameters():
        torch.nn.init.normal_(p)
    seen = collections.Counter()
    tree: dict = {}
    for key, val in m.state_dict().items():
        path, fn = keymap.convert_unet2d_key(key, linear)
        seen[path] += 1
        jc._set(tree, path, fn(val))
    assert set(seen) == leaves and max(seen.values()) == 1
    back = state_dict_from_jax(tree, "unet2d", m)
    assert set(back) == set(m.state_dict())
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    assert keymap.convert_unet2d_key("input_blocks.1.0.time_stack.in_layers.0.weight") is None


def test_expand_unet_input_channels_matches_jax():
    """The zero-padded first conv equals the JAX surgery's; an 8-channel
    UNet on [x, c] then equals the 4-channel one on x; shrinking raises."""
    j, params, m, (x, ts, ctx, y) = tiny_pair(seed=2)
    state = expand_unet_input_channels(m.state_dict(), 8)
    jtree = jc.expand_unet_input_channels(jax.tree_util.tree_map(np.asarray, params), 8)
    m8 = UNetModel(**dict(TINY, in_channels=8))
    ref = state_dict_from_jax(jtree, "unet2d", m8)
    assert all(torch.equal(state[k], ref[k]) for k in ref)
    m8.load_state_dict(state)
    xc = np.concatenate([x, rand(x.shape, 9)], axis=-1)
    assert rel(port_forward(m8, xc, ts, ctx, y), port_forward(m, x, ts, ctx, y)) <= RTOL
    with pytest.raises(ValueError):
        expand_unet_input_channels(state, 4)


def plain_everywhere(monkeypatch):
    """Every dispatcher takes its plain version, on meta tensors too."""
    for info in pkgutil.walk_packages(v3d_tpu_torch.__path__, "v3d_tpu_torch."):
        mod = importlib.import_module(info.name)
        if hasattr(mod, "use_plain"):
            monkeypatch.setattr(mod, "use_plain", lambda *tensors: True)


def _meta_forward_group_norms(monkeypatch, **kw):
    from v3d_tpu_torch.models.layers import GroupNorm32

    plain_everywhere(monkeypatch)
    with torch.device("meta"):
        unet = UNetModel(**kw).to(torch.bfloat16)
    seen = collections.Counter()
    for mod in unet.modules():
        if isinstance(mod, GroupNorm32):
            mod.register_forward_hook(lambda mod, inp, out: seen.update(
                [(tuple(inp[0].shape), mod.act == "silu")]))
    dev = torch.device("meta")
    b, hw = chip_smoke.IMAGE_BATCH, chip_smoke.IMAGE_LATENT
    with torch.no_grad():
        out = unet(torch.empty(b, 4, hw, hw, device=dev),
                   torch.empty(b, device=dev),
                   torch.empty(b, 77, 1024, device=dev))
    assert out.shape == (b, 4, hw, hw)
    return unet, dict(seen)


@pytest.mark.parametrize("which", ["sd21", "scale_shift"])
def test_k6_unet2d_shapes_are_one_forward(monkeypatch, which):
    """The GroupNorm inputs of one CFG-doubled UNet2D forward at 64^2
    latents (meta device) are exactly chip_smoke's lists, which phase 3
    checks K6 at; phase 21's count (``unet2d_sites``) agrees."""
    kw, listed = ((dict(), chip_smoke.K6_UNET2D_SHAPES) if which == "sd21" else
                  (chip_smoke.UNET2D_SS_KW, chip_smoke.K6_UNET2D_SS_SHAPES))
    unet, seen = _meta_forward_group_norms(monkeypatch, **kw)
    assert seen == {(shape, silu): calls for shape, silu, calls in listed}
    sites = chip_smoke.unet2d_sites(unet, chip_smoke.IMAGE_LATENT, 77)
    assert sites["group_norm"] == sum(calls for _, _, calls in listed) == 61


def test_full_width_counts_match_jax():
    """The SD-2.1-width UNet2D's parameter count from ``jax.eval_shape`` of
    the JAX module equals the port's and chip_smoke's ``UNET2D_PARAMS``;
    K1 sites per forward: the ds1 / ds2 self-attentions (2 + 2 + 3 + 3),
    cross-attention and the 256- / 64-token levels plain."""
    j = JUNet()
    shapes = jax.eval_shape(lambda: j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 1024))))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        unet = UNetModel()
    assert n_jax == sum(p.numel() for p in unet.parameters()) == chip_smoke.UNET2D_PARAMS
    sites = chip_smoke.unet2d_sites(unet, 64, 77)
    assert sites["flash_attn_fwd"] == 10 and sites["flash_attn_fwd_wide"] == 0
