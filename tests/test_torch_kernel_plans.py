"""Host-side logic around the redesigned kernels K1 (flash forward, wgmma +
TMA), K3 (temporal core) and K7/K8 (flash backward, wgmma + TMA), on the
CPU: which operands a tensor map can read in place and the aligned copy
made of the others, each kernel's launch plan at the main path's shapes,
the phase-3 work and bound formulas of chip_smoke.py, and CPU tensors
reaching the plain versions with no launch (against the JAX package's
Pallas kernels in interpret mode, or jax.vjp of its attention formula).
K10 (LayerNorm): its plan at the UNets' and CLIP's widths, what its
wrapper hands the kernel (a stand-in launch) and refuses, and the
LayerNorm calls of both full-width UNet forwards on the meta device.

Tolerances: the plans and bounds are exact integers or closed formulas
(bounds to 1e-3 ms); the plain versions as tests/test_torch_ops.py holds
them (f32, rtol 2e-4 / atol 2e-5, the JAX package's own flash test bound).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from torch_port_helpers import rand, t
from v3d_tpu.ops import flash_attention as jfa
from v3d_tpu.ops.attention import attention_bhsd
from v3d_tpu.ops.temporal_attention import _pallas_core
from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
from v3d_tpu_torch.ops import attention as tattn
from v3d_tpu_torch.ops import temporal_attention as ttemp

RTOL, ATOL = 2e-4, 2e-5


def _bshd_view(b, s, h, pad=0, dtype=torch.bfloat16, offset=0):
    """A (b, h, s, 64) view of a (b, s, h, 64 + pad) buffer, ``offset``
    elements into it."""
    base = torch.zeros(b * s * h * (64 + pad) + offset, dtype=dtype)
    x = base[offset:].view(b, s, h, 64 + pad)[..., :64]
    return x.transpose(1, 2)


@pytest.mark.parametrize("case,expect", [
    ("projection view", (5 * 4096 * 64, 64, 5 * 64)),
    ("contiguous bhsd", (5 * 4096 * 64, 4096 * 64, 64)),
    ("odd row pitch", None),
    ("base off by 2 bytes", None),
    ("one key", (5 * 64, 64, 64)),
    ("expanded batch", None),
    ("f32 projection view", (5 * 128 * 64, 64, 5 * 64)),
])
def test_tma_strides(case, expect):
    """A tensor map reads a (b, h, s, d) view in place where its base and
    strides are 16-byte multiples; a size-1 dim's stride is never stepped
    and is replaced by the row width; a stride of 0 on a longer dim (an
    expanded tensor) is not a map's, so that operand is copied."""
    x = {"projection view": lambda: _bshd_view(2, 4096, 5),
         "contiguous bhsd": lambda: torch.zeros(2, 5, 4096, 64, dtype=torch.bfloat16),
         "odd row pitch": lambda: _bshd_view(2, 70, 2, pad=3),
         "base off by 2 bytes": lambda: _bshd_view(2, 16, 5, offset=1),
         "one key": lambda: torch.zeros(3, 1, 5, 64, dtype=torch.bfloat16).transpose(1, 2),
         "expanded batch": lambda: torch.zeros(
             1, 7, 5, 64, dtype=torch.bfloat16).expand(3, 7, 5, 64).transpose(1, 2),
         "f32 projection view": lambda: _bshd_view(2, 128, 5, dtype=torch.float32),
         }[case]()
    assert tattn.tma_strides(x) == expect


@pytest.mark.parametrize("pad,offset", [(0, 0), (3, 0), (0, 1), (8, 0)])
def test_tma_operand_copies_only_what_a_map_cannot_read(pad, offset):
    x = _bshd_view(2, 33, 3, pad=pad, offset=offset)
    x.copy_(torch.from_numpy(rand(tuple(x.shape), 3)).to(torch.bfloat16))
    y = tattn.tma_operand(x)
    if tattn.tma_strides(x) is not None:
        assert y is x
    else:
        assert y is not x and y.is_contiguous()
        assert y.data_ptr() % tattn.TMA_ALIGN == 0
        assert tattn.tma_strides(y) == (3 * 33 * 64, 33 * 64, 64)
        assert torch.equal(y, x)
    assert (pad, offset) in ((0, 0), (8, 0)) or y is not x


@pytest.mark.parametrize("shape,grid,tiles", [
    ((36, 5, 4096, 4096), (32, 180), 32),     # ds1, 250 launches a generation
    ((36, 10, 1024, 1024), (8, 360), 8),      # ds2
    ((36, 5, 4096, 1), (32, 180), 1),         # "flash": one context token
    ((36, 20, 256, 256), (2, 720), 2),        # "flash": ds4 self-attention
    ((36, 20, 64, 64), (1, 720), 1),          # "flash": ds8 self-attention
    ((1, 3, 1, 257), (1, 3), 3),
])
def test_flash_fwd_plan(shape, grid, tiles):
    plan = tattn.flash_fwd_plan(*shape)
    assert plan["grid"] == grid and plan["kv_tiles"] == tiles
    assert plan["threads"] == 384
    # Q + 3 stages of K and V, 16 KB each; 10 barriers; 1 KB alignment slack
    assert plan["smem"] == 7 * 16384 + 80 + 1024 <= 232448


@pytest.mark.parametrize("shape,grid_dq,tiles_dq,grid_dkv,tiles_dkv,pitch", [
    ((18, 5, 4096, 4096), (32, 90), 32, (32, 90), 64, 4096),    # ds1, 10 a fine-tune step
    ((18, 10, 1024, 1024), (8, 180), 8, (8, 180), 16, 1024),    # ds2
    ((1, 3, 1, 257), (1, 3), 3, (3, 3), 1, 4),                   # ragged
])
def test_flash_bwd_plan(shape, grid_dq, tiles_dq, grid_dkv, tiles_dkv, pitch):
    """K8: 128 query rows a block, 128-key K/V tiles in a ring of 3; K7: 128
    keys a block, 64-row Q/dO tiles with their lse and D in a ring of 4; the
    row statistics K8 writes for K7 with a pitch of sq rounded up to 4."""
    plan = tattn.flash_bwd_plan(*shape)
    dq, dkv = plan["dq"], plan["dkv"]
    assert (dq["grid"], dq["tiles"], dq["stages"]) == (grid_dq, tiles_dq, 3)
    assert (dkv["grid"], dkv["tiles"], dkv["stages"]) == (grid_dkv, tiles_dkv, 4)
    assert dq["threads"] == dkv["threads"] == 384
    # Q + dO (16 KB each) + 3 x (K + V) of 16 KB; 10 barriers; 1 KB slack
    assert dq["smem"] == 8 * 16384 + 80 + 1024 <= 232448
    # 4 x (Q + dO of 8 KB + 2 x 256 B of statistics); 8 barriers; 1 KB slack
    assert dkv["smem"] == 4 * (2 * 8192 + 512) + 64 + 1024 <= 232448
    assert plan["stats"] == (shape[0] * shape[1], 2, pitch)
    assert (pitch * 4) % tattn.TMA_ALIGN == 0


@pytest.mark.parametrize("shape,items,max_blocks,smem", [
    ((2, 18, 1024, 10, 64), 20480, 2560, 2 * 72 * (1 + 8 * 54)),   # ds2
    ((2, 18, 256, 20, 64), 10240, 1280, 2 * 72 * (1 + 8 * 54)),    # ds4
    ((2, 18, 64, 20, 64), 2560, 320, 2 * 72 * (1 + 8 * 54)),       # ds8
    ((8192, 18, 1, 5, 64), 40960, 5120, 2 * 72 * (1 + 8 * 54)),    # T5 / T6
    ((2, 5, 3, 2, 100), 12, 2, 2 * 136 * (1 + 8 * 15)),
    ((2, 32, 2, 1, 128), 4, 1, 2 * 136 * (1 + 8 * 96)),
])
def test_temporal_core_plan(shape, items, max_blocks, smem):
    plan = ttemp.temporal_core_plan(*shape)
    assert (plan["items"], plan["max_blocks"], plan["smem"]) == (items, max_blocks, smem)
    assert plan["threads"] == 128 and plan["smem"] <= 232448
    # 3 blocks share an SM at the main path's t = 18, dh = 64
    if shape[1] == 18 and shape[4] == 64:
        assert 3 * plan["smem"] <= 232448 < 4 * plan["smem"]


@pytest.mark.parametrize("what,args,ms,by", [
    ("K1 ds1", (36, 5, 4096, 4096, 64), 0.7817, "operations"),
    ("K1 ds2", (36, 10, 1024, 1024, 64), 0.0977, "operations"),
    ("K1 cross ds1", (36, 5, 4096, 1, 64), 0.0564, "bytes"),
    ("K3 ds2", (2 * 1024 * 10, 1, 18, 18, 64), 0.0563, "bytes"),
    ("T5/T6", (8192, 5, 18, 18, 64), 0.1127, "bytes"),
])
def test_phase3_work_and_bounds(what, args, ms, by):
    """chip_smoke.py's phase-3 formulas: 4 b h sq sk d FLOP (two products),
    q/k/v read once and o written once in bf16; the bound is the larger of
    FLOP over 989 TFLOP/s and bytes over 3.35 TB/s."""
    b, h, sq, sk, d = args
    flops, nbytes = chip_smoke._attention_work(b, h, sq, sk, d, 2)
    assert flops == 4 * b * h * sq * sk * d
    assert nbytes == 2 * (2 * b * h * sq * d + 2 * b * h * sk * d)
    bound, bound_by = chip_smoke.bound_ms(flops, nbytes, chip_smoke.PEAK_BF16)
    assert bound_by == by
    assert math.isclose(bound, ms, abs_tol=1e-3)


@pytest.mark.parametrize("kernel,products,ms", [
    ("flash_attn_bwd_dq", 3, 0.5863),    # K8: S, dP, dQ
    ("flash_attn_bwd_dkv", 4, 0.7817),   # K7: S^T, dP^T, dV, dK
    ("fused", 5, 0.9771),                # the function: one product fewer each
])
def test_phase3_backward_bounds(kernel, products, ms):
    """chip_smoke.py's backward bounds at ds1 (18, 5, 4096, 64): 2 b h s^2 d
    FLOP a product over 989 TFLOP/s (six bf16 tensors and two f32 rows
    over 3.35 TB/s are far below); the pair's bound is 1.368 ms."""
    b, h, s = dict(chip_smoke.FLASH_BWD_SHAPES)["ds1"]
    assert chip_smoke.BWD_PRODUCTS[kernel] == products
    flops, nbytes = chip_smoke.flash_bwd_work(b, h, s, products)
    assert flops == products * 2 * b * h * s * s * 64
    assert nbytes == 6 * b * h * s * 64 * 2 + 2 * b * h * s * 4
    bound, bound_by = chip_smoke.bound_ms(flops, nbytes, chip_smoke.PEAK_BF16)
    assert bound_by == "operations" and math.isclose(bound, ms, abs_tol=1e-3)
    pair = sum(chip_smoke.bound_ms(*chip_smoke.flash_bwd_work(b, h, s, n),
                                   chip_smoke.PEAK_BF16)[0] for n in (3, 4))
    assert math.isclose(pair, 1.368, abs_tol=1e-3)


def test_k1_main_shapes_are_the_generation_shapes():
    shapes = dict(chip_smoke.K1_MAIN_SHAPES)
    assert shapes["ds1"] == (36, 5, 4096, 4096)
    assert shapes["ds2"] == (36, 10, 1024, 1024)


@pytest.mark.parametrize("pad", [0, 3])
def test_cpu_flash_takes_plain_with_no_launch_or_copy(pad, monkeypatch):
    """K1's wrapper on CPU tensors (bf16 misaligned views included) runs
    the plain version, makes no aligned copy and counts no launch; the
    result matches the JAX package's Pallas flash forward (T2's kernel, T1's
    math) in interpret mode."""
    b, h, sq, sk = 1, 2, 128, 128
    arrs = [rand((b, s, h, 64), i) for i, s in enumerate((sq, sk, sk))]
    views = []
    for a in arrs:
        buf = torch.zeros(a.shape[:-1] + (64 + pad,))
        buf[..., :64] = t(a)
        views.append(buf[..., :64].transpose(1, 2))
    calls = []
    monkeypatch.setattr(tattn, "tma_operand", lambda x: calls.append(x) or x)
    before = dict(LAUNCHES)
    got = tattn.flash_attn_fwd(*views)
    assert dict(LAUNCHES) == before and calls == []
    ref = jfa._flash_forward(*(jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, 64))
                               for a in arrs), 128, 128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, h, sq, 64),
                               rtol=RTOL, atol=ATOL)


def test_cpu_temporal_core_takes_plain_with_no_launch():
    """K3's wrapper on CPU tensors runs the plain version and counts no
    launch; it matches _pallas_core (T7) in interpret mode."""
    b, tt, s, heads, d = 1, 18, 16, 2, 64
    q, k, v = (rand((b, tt, s, heads * d), i + 20) for i in range(3))
    before = dict(LAUNCHES)
    got = ttemp.temporal_core(t(q), t(k), t(v), heads)
    assert dict(LAUNCHES) == before

    def to_core(x):  # (b, t, s, heads*d) -> (t, d, b*s*heads), _pallas_core's
        return x.reshape(b, tt, s, heads, d).transpose(1, 4, 0, 2, 3).reshape(
            tt, d, b * s * heads)

    ref = _pallas_core(*(jnp.asarray(to_core(x)) for x in (q, k, v)), block=16,
                       interpret=True)
    np.testing.assert_allclose(to_core(got.numpy()), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pad", [0, 3])
def test_cpu_flash_bwd_takes_plain_with_no_launch_or_copy(pad, monkeypatch):
    """K8/K7's wrapper on CPU tensors (bf16 views whose row pitch no tensor
    map can read included) runs the plain backward, makes no aligned copy
    and counts no launch; in f32 it matches jax.vjp of the JAX package's
    bhsd attention formula."""
    b, h, sq, sk = 1, 2, 70, 90
    arrs = [rand((b, s, h, 64), i + 30) for i, s in enumerate((sq, sk, sk, sq))]
    views = []
    for a in arrs:
        buf = torch.zeros(a.shape[:-1] + (64 + pad,))
        buf[..., :64] = t(a)
        views.append(buf[..., :64].transpose(1, 2))
    q, k, v, do = views
    o, lse = tattn.flash_attn_fwd_plain(q, k, v, with_lse=True)
    calls = []
    monkeypatch.setattr(tattn, "tma_operand", lambda x: calls.append(x) or x)
    before = dict(LAUNCHES)
    got = tattn.flash_attn_bwd(q, k, v, o, lse, do)
    assert dict(LAUNCHES) == before and calls == []
    _, vjp = jax.vjp(attention_bhsd, *(jnp.asarray(a.transpose(0, 2, 1, 3))
                                       for a in arrs[:3]))
    want = vjp(jnp.asarray(arrs[3].transpose(0, 2, 1, 3)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    bf = [x.to(torch.bfloat16) for x in views]
    ob, lseb = tattn.flash_attn_fwd_plain(*bf[:3], with_lse=True)
    got_bf = tattn.flash_attn_bwd(*bf[:3], ob, lseb, bf[3])
    assert dict(LAUNCHES) == before and calls == []
    assert all(g.dtype == torch.bfloat16 and g.shape == x.shape
               for g, x in zip(got_bf, bf[:3]))


# K10's (rows, C) at the main path: both UNets' levels and CLIP ViT-H at batch 1
K10_SITES = [(rows, C) for (rows, C), _ in chip_smoke.K10_FORWARD_SHAPES
             + chip_smoke.K10_IMAGE_SHAPES] + [(257, 1280), (257, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows,C", K10_SITES)
def test_layer_norm_plan(rows, C, dtype):
    """The widths the models use take the fixed-width instances: lanes the
    largest power of two <= 32 that divides a row's 16-byte packs; a warp
    takes 32 / lanes rows, a block of 256 threads 8 times that, and the
    grid covers every row once."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_plan

    plan = layer_norm_plan(rows, C, dtype)
    elem = 4 if dtype == torch.float32 else 2
    packs = C * elem // 16
    lanes = plan["lanes"]
    assert plan["path"] == "fixed" and plan["vec"] == 16 // elem
    assert packs % lanes == 0 and (lanes == 32 or packs % (2 * lanes))
    assert plan["slots"] * lanes * plan["vec"] == C
    assert plan["threads"] == 256 and plan["rows_per_task"] == 32 // lanes
    assert plan["rows_per_block"] == 8 * plan["rows_per_task"]
    grid = plan["grid"][0]
    assert (grid - 1) * plan["rows_per_block"] < rows <= grid * plan["rows_per_block"]
    assert plan["smem"] == 8 * C


@pytest.mark.parametrize("C,lanes,slots,f32_lanes,f32_slots", [
    (320, 8, 5, 16, 5), (640, 16, 5, 32, 5), (1024, 32, 4, 32, 8), (1280, 32, 5, 32, 10)])
def test_layer_norm_plan_widths(C, lanes, slots, f32_lanes, f32_slots):
    """The eight compiled instances (csrc/layer_norm.cu dispatch): bf16 4-5
    packs of 16 bytes a lane, f32 5-10; V3D's ds1 (147,456 rows of 320) in
    4,608 blocks of 32 rows."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_plan

    plan = layer_norm_plan(147456, C)
    assert (plan["lanes"], plan["slots"]) == (lanes, slots)
    plan32 = layer_norm_plan(147456, C, torch.float32)
    assert (plan32["lanes"], plan32["slots"]) == (f32_lanes, f32_slots)
    if C == 320:
        assert (plan["grid"], plan["rows_per_block"]) == ((4608,), 32)


def test_layer_norm_plan_generic_and_above_the_maximum():
    """Another C takes the generic instance (a warp a row), with 16-byte
    packs where C and the layout allow, else one element; C above 4096
    raises."""
    from v3d_tpu_torch.ops.layer_norm import LN_MAX_C, layer_norm_plan

    assert LN_MAX_C == 4096
    plan = layer_norm_plan(100, 1000)
    assert (plan["path"], plan["lanes"], plan["vec"], plan["grid"]) == ("generic", 32, 8, (13,))
    assert layer_norm_plan(100, 1001)["vec"] == 1
    assert layer_norm_plan(100, 320, vec_ok=False)["path"] == "generic"
    assert layer_norm_plan(5, 4096, torch.float32)["slots"] == 32
    with pytest.raises(ValueError, match="4096"):
        layer_norm_plan(10, 4097)


@pytest.fixture
def ln_launches(monkeypatch):
    """K10's wrapper driven on CPU tensors: its card branch, with a
    stand-in launch that records the arguments and counts as the real one."""
    from v3d_tpu_torch.ops import layer_norm as ln

    seen = []

    def record(name, fn_name, device, *args):
        seen.append((name, fn_name, args))
        LAUNCHES[name] += 1

    monkeypatch.setattr(ln, "use_plain", lambda *tensors: False)
    monkeypatch.setattr(ln, "launch", record)
    return seen


@pytest.mark.parametrize("dtype,pdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32)])
def test_layer_norm_wrapper_hands_the_plan(ln_launches, dtype, pdtype):
    """(b t, s, c) tokens as the transformers hand them: one launch a call
    with the row count, C, the row stride and the plan; y contiguous in
    x's dtype; a strided (rows, C) view passes its own row stride."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_plan

    x = torch.randn(6, 64, 320).to(dtype)
    w, b = torch.ones(320, dtype=pdtype), torch.zeros(320, dtype=pdtype)
    before = LAUNCHES["layer_norm"]
    y = layer_norm_f32(x, w, b, 1e-5)
    assert LAUNCHES["layer_norm"] == before + 1 and len(ln_launches) == 1
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    name, fn_name, args = ln_launches[0]
    plan = layer_norm_plan(384, 320, dtype)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert (name, fn_name) == ("layer_norm", "v3d_layer_norm")
    assert args[:2] == (codes[dtype], codes[pdtype])
    assert args[2:6] == (x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr())
    assert args[6:] == (384, 320, 320, 1e-5, plan["lanes"], plan["vec"], 1,
                        plan["grid"][0])
    wide = torch.randn(48, 400).to(dtype)
    layer_norm_f32(wide[:, :320], w, b)
    assert ln_launches[1][2][6:9] == (48, 320, 400)


def test_layer_norm_wrapper_refuses(ln_launches):
    """K10 raises rather than fall back: C above its maximum, a non-unit
    stride on C, leading dims that do not collapse to one row stride,
    parameters of another shape; no launch counted.  Mixed devices raise in
    the dispatch (``use_plain``), before any route."""
    from v3d_tpu_torch.ops import layer_norm as ln

    w = torch.ones(320)
    before = LAUNCHES["layer_norm"]
    with pytest.raises(ValueError, match="above"):
        ln.layer_norm_f32(torch.randn(4, 4097), torch.ones(4097), torch.ones(4097))
    with pytest.raises(ValueError, match="unit stride"):
        ln.layer_norm_f32(torch.randn(320, 4).t(), w, w)
    with pytest.raises(ValueError, match="unit stride"):
        ln.layer_norm_f32(torch.randn(5, 4, 320).transpose(0, 1), w, w)
    with pytest.raises(TypeError, match="weight"):
        ln.layer_norm_f32(torch.randn(4, 320), torch.ones(321), w)
    assert LAUNCHES["layer_norm"] == before and ln_launches == []
    from v3d_tpu_torch.ops._dispatch import use_plain

    with pytest.raises(ValueError, match="several devices"):
        use_plain(torch.randn(4, 320), w.to("meta"), w)


def test_cpu_layer_norm_takes_plain_with_no_launch():
    """On CPU tensors K10's wrapper is its plain version, LayerNormF32's
    formula bit for bit, and counts nothing; ``reset_launch_counts`` clears
    the new key."""
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32

    x = torch.randn(3, 7, 320).to(torch.bfloat16)
    w, b = torch.randn(320).to(torch.bfloat16), torch.randn(320).to(torch.bfloat16)
    before = dict(LAUNCHES)
    got = layer_norm_f32(x, w, b, 1e-5)
    assert dict(LAUNCHES) == before
    assert torch.equal(got, F.layer_norm(x.float(), (320,), w.float(), b.float(),
                                         1e-5).to(x.dtype))
    LAUNCHES["layer_norm"] += 3
    reset_launch_counts()
    assert LAUNCHES["layer_norm"] == 0


def _meta_layer_norm_calls(unet, *inputs):
    import collections

    from v3d_tpu_torch.models.layers import LayerNormF32
    from v3d_tpu_torch.ops._dispatch import meta_shapes

    seen = collections.Counter()
    for m in unet.modules():
        if isinstance(m, LayerNormF32):
            m.register_forward_hook(lambda mod, inp, out: seen.update(
                [(inp[0].numel() // inp[0].shape[-1], inp[0].shape[-1])]))
    with torch.no_grad(), meta_shapes():
        unet(*inputs)
    return dict(seen)


def test_layer_norm_calls_of_the_full_width_unets():
    """On the meta device (plain versions, shapes only) a full-width V3D-512
    VideoUNet forward on the CFG-doubled 36 frames at 64^2 calls
    LayerNormF32 112 times, at chip_smoke.K10_FORWARD_SHAPES; SD 2.1's
    UNet2D on 8 CFG rows at 96^2, 48 times, at K10_IMAGE_SHAPES: each
    module once, the counts the launches must match
    (``chip_smoke.count_layer_norms``)."""
    from v3d_tpu_torch.models.unet2d import UNetModel
    from v3d_tpu_torch.models.video_unet import VideoUNet

    dev, bf16 = torch.device("meta"), torch.bfloat16
    with torch.device("meta"):
        unet = VideoUNet(in_channels=8, model_channels=320, out_channels=4,
                         num_res_blocks=2, attention_resolutions=(4, 2, 1),
                         channel_mult=(1, 2, 4, 4), num_head_channels=64,
                         context_dim=1024, adm_in_channels=768).to(bf16)
    got = _meta_layer_norm_calls(
        unet, torch.empty(36, 8, 64, 64, device=dev, dtype=bf16),
        torch.empty(36, device=dev), torch.empty(36, 1, 1024, device=dev, dtype=bf16),
        torch.empty(36, 768, device=dev, dtype=bf16), 18, torch.empty(2, 18, device=dev))
    assert got == dict(chip_smoke.K10_FORWARD_SHAPES)
    assert sum(got.values()) == 112 == chip_smoke.count_layer_norms(unet)
    with torch.device("meta"):
        sd = UNetModel(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
                       attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                       num_head_channels=64, context_dim=1024).to(bf16)
    got = _meta_layer_norm_calls(
        sd, torch.empty(8, 4, 96, 96, device=dev, dtype=bf16), torch.empty(8, device=dev),
        torch.empty(8, 77, 1024, device=dev, dtype=bf16))
    assert got == dict(chip_smoke.K10_IMAGE_SHAPES)
    assert sum(got.values()) == 48 == chip_smoke.count_layer_norms(sd)


def test_layer_norm_calls_and_launches_of_the_full_width_flux():
    """On the meta device a FLUX.1-dev forward at 1024^2 (4,096 image + 512
    text tokens) calls its affine-free LayerNorm 115 times, at
    chip_smoke.K10_FLUX_SHAPES, and its joint attention 57 times: phase
    29's launches (``chip_smoke.flux_launches``, ``FLUX_LAUNCHES``)."""
    import collections

    from v3d_tpu_torch.models.flux import Flux, LayerNormNoAffine
    from v3d_tpu_torch.ops._dispatch import meta_shapes

    dev, bf16 = torch.device("meta"), torch.bfloat16
    with torch.device("meta"):
        net = Flux().to(bf16)
    assert sum(p.numel() for p in net.parameters()) == chip_smoke.FLUX_PARAMS
    seen = collections.Counter()
    for m in net.modules():
        if isinstance(m, LayerNormNoAffine):
            m.register_forward_hook(lambda mod, inp, out: seen.update(
                [(inp[0].numel() // inp[0].shape[-1], inp[0].shape[-1])]))
    tokens, hw = chip_smoke.FLUX_TOKENS
    with torch.no_grad(), meta_shapes():
        net(torch.empty(1, 16, 2 * hw, 2 * hw, device=dev), torch.empty(1, device=dev),
            torch.empty(1, tokens, 4096, device=dev), torch.empty(1, 768, device=dev),
            torch.empty(1, device=dev))
    assert dict(seen) == dict(chip_smoke.K10_FLUX_SHAPES)
    launches = chip_smoke.flux_launches(net)
    assert sum(seen.values()) == 115 == launches["layer_norm"]
    assert {k: v for k, v in launches.items() if v} == chip_smoke.FLUX_LAUNCHES


def test_k10_bound_is_the_byte_bound():
    """Phase 3's K10 bound: one bf16 read of x and one write of y over
    3.35 TB/s: 0.0563 ms at V3D's ds1, 0.0282 at SD's."""
    for (rows, C), ms in (((147456, 320), 0.0563), ((73728, 320), 0.0282),
                          ((36864, 640), 0.0282), ((9216, 1280), 0.0141)):
        bound, by = chip_smoke.bound_ms(*chip_smoke.layer_norm_work(rows, C, 2, 2),
                                        chip_smoke.PEAK_BF16)
        assert by == "bytes" and math.isclose(bound, ms, abs_tol=1e-4)
