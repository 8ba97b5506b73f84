"""Host-side logic of the redesigned K6 (GroupNorm, T9) and K2 (fused
temporal block, T8), on the CPU: the GroupNorm shapes of one full-width
UNet forward against chip_smoke.py's list, each kernel's launch plan at the
main path's shapes and beyond, phase 3's K6 work formula, and what the
wrappers hand their kernels (recorded by a stand-in launch).

Tolerances: the shapes, plans and counts are exact; the bounds are closed
formulas (to 1e-4 ms).
"""

import collections
import importlib
import math
import pkgutil

import pytest
import torch

import chip_smoke
import v3d_tpu_torch
from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
from v3d_tpu_torch.ops import group_norm as gn
from v3d_tpu_torch.ops import temporal_attention as ttemp

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100

# V3D-512's UNet (engines/builder.py build_v3d_engine)
UNET_KW = dict(in_channels=8, model_channels=320, out_channels=4, num_res_blocks=2,
               attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
               num_head_channels=64, context_dim=1024, adm_in_channels=768)

VAE_SHAPES = [(18, 128, 512, 512), (18, 256, 256, 256), (18, 512, 128, 128),
              (1, 128, 512, 512)]


def test_k6_forward_shapes_are_one_unet_forward(monkeypatch):
    """A full-width VideoUNet forward on the meta device (bf16, the
    CFG-doubled 36 frames at 64^2, plain versions everywhere) calls its
    GroupNorms on exactly chip_smoke.K6_FORWARD_SHAPES: 105 calls, 18
    shapes, with their SiLU flags."""
    from v3d_tpu_torch.models.layers import GroupNorm32
    from v3d_tpu_torch.models.video_unet import VideoUNet

    for info in pkgutil.walk_packages(v3d_tpu_torch.__path__, "v3d_tpu_torch."):
        mod = importlib.import_module(info.name)
        if hasattr(mod, "use_plain"):
            monkeypatch.setattr(mod, "use_plain", lambda *tensors: True)
    with torch.device("meta"):
        unet = VideoUNet(**UNET_KW).to(torch.bfloat16)
    seen = collections.Counter()
    for m in unet.modules():
        if isinstance(m, GroupNorm32):
            m.register_forward_hook(lambda mod, inp, out: seen.update(
                [(tuple(inp[0].shape), mod.act == "silu")]))
    dev, bf16 = torch.device("meta"), torch.bfloat16
    with torch.no_grad():
        out = unet(torch.empty(36, 8, 64, 64, device=dev, dtype=bf16),
                   torch.empty(36, device=dev),
                   torch.empty(36, 1, 1024, device=dev, dtype=bf16),
                   torch.empty(36, 768, device=dev, dtype=bf16), 18,
                   torch.empty(2, 18, device=dev))
    assert out.shape == (36, 4, 64, 64)
    want = {(shape, silu): calls for shape, silu, calls in chip_smoke.K6_FORWARD_SHAPES}
    assert dict(seen) == want
    assert sum(want.values()) == 105 and len({s for s, _ in want}) == 18


def test_k6_forward_bound_is_the_byte_bound():
    """Phase 3's K6 bound: one bf16 read of x and one write of y (scale and
    bias besides) over 3.35 TB/s; 0.0563 ms at ds1 (not 0.0845, which counts
    two reads), 2.9721 ms summed over the forward's 105 calls."""
    total = 0.0
    for shape, silu, calls in chip_smoke.K6_FORWARD_SHAPES:
        bound, by = chip_smoke.bound_ms(*chip_smoke.group_norm_work(shape, silu, 2, 2),
                                        chip_smoke.PEAK_BF16)
        assert by == "bytes"
        total += calls * bound
    ds1 = chip_smoke.bound_ms(*chip_smoke.group_norm_work((36, 320, 64, 64), False, 2, 2),
                              chip_smoke.PEAK_BF16)[0]
    assert math.isclose(ds1, 0.0563, abs_tol=1e-4)
    assert math.isclose(total, 2.9721, abs_tol=1e-4)


def _gn_cases():
    cases = [(shape, torch.bfloat16) for shape in
             dict.fromkeys(s for s, _, _ in chip_smoke.K6_FORWARD_SHAPES)]
    return cases + [(shape, dt) for shape in VAE_SHAPES
                    for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape,dtype", _gn_cases(),
                         ids=lambda v: str(v).replace(" ", "").replace("torch.", ""))
def test_group_norm_plan(shape, dtype):
    """K6's plan at every shape of the forward and at the VAE's maps: one
    launch where a slice of whole groups fits <= 100 KB a block in a cluster
    of <= 8, or of 16 where none of <= 8 does (and with blocks of up to 227
    KB where none fits 100 KB; rows of >= 64 bytes, the grid
    one block per (slice, rank), the blocks covering every row), else two
    launches over (splits, B); shared memory within the card's limit either
    way."""
    B, C = shape[:2]
    L = math.prod(shape[2:])
    elem = 4 if dtype == torch.float32 else 2
    plan = gn.group_norm_plan(B, L, C, 32, dtype)
    assert plan["smem"] <= SMEM_LIMIT
    if plan["path"] == "one_launch":
        W = plan["gpc"] * C // 32
        assert plan["launches"] == 1 and plan["splits"] == 0
        assert 32 % plan["gpc"] == 0 and plan["cluster"] in (1, 2, 4, 8, 16)
        assert plan["row_bytes"] == W * elem >= 64 and plan["row_bytes"] % 16 == 0
        assert plan["grid"] == (plan["cluster"] * B * 32 // plan["gpc"],)
        assert plan["rows_per_block"] * plan["cluster"] >= L
        assert plan["rows_per_block"] * (plan["cluster"] - 1) < L
        assert plan["smem"] <= gn.GN_SMEM_CAP or plan["cluster"] == 16
        assert plan["smem"] == gn._slice_smem(W, plan["gpc"], plan["rows_per_block"], elem)
    else:
        assert plan["launches"] == 2 and plan["cluster"] == 1
        splits = plan["splits"]
        assert plan["grid"] == (splits, B) and splits * plan["rows_per_block"] >= L
        ncv = C * elem // 16
        assert plan["threads"] == (1 if ncv >= 256 else 256 // ncv) * ncv
        assert plan["smem"] == 2 * (plan["threads"] // ncv) * C * 4


@pytest.mark.parametrize("shape,path,cluster,gpc", [
    ((36, 320, 64, 64), "one_launch", 8, 8),       # ds1: 160-byte rows
    ((36, 1280, 8, 8), "one_launch", 1, 4),        # a slice a block
    ((2, 1280, 18, 8, 8), "one_launch", 8, 1),     # temporal ds8
    ((2, 320, 18, 64, 64), "two_launch", 1, 32),   # temporal ds1: 47 MB a sample
    ((2, 640, 18, 32, 32), "one_launch", 16, 2),   # 108 KB blocks in 16
    ((18, 128, 512, 512), "two_launch", 1, 32),    # the VAE's largest map
    ((36, 960, 64, 64), "one_launch", 16, 4),      # 123 KB blocks in 8
    ((18, 512, 128, 128), "one_launch", 16, 2),    # a VAE decoder map
])
def test_group_norm_plan_paths(shape, path, cluster, gpc):
    plan = gn.group_norm_plan(shape[0], math.prod(shape[2:]), shape[1], 32,
                              torch.bfloat16)
    assert (plan["path"], plan["cluster"], plan["gpc"]) == (path, cluster, gpc)


@pytest.fixture
def fake_launch(monkeypatch):
    """Drive a wrapper's CUDA branch on CPU tensors with a launch that
    records its arguments."""
    calls = []

    def record(name, fn_name, device, *args):
        calls.append((fn_name, args))
        LAUNCHES[name] += 1

    for mod in (gn, ttemp):
        monkeypatch.setattr(mod, "use_plain", lambda *a: False)
        monkeypatch.setattr(mod, "launch", record)
    reset_launch_counts()
    return calls


def test_group_norm_two_launch_hands_partials_and_tickets(fake_launch, monkeypatch):
    """A call the plan gives two launches passes one scratch buffer of its
    own, with room for the partials, mean / inv and the per-sample tickets
    (the kernel zeroes them on the launch stream); a one-launch call passes
    none.  One launch counted each."""
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        sizes.append((out.numel(), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(gn.torch, "empty", recording_empty)
    x = torch.randn(1, 64, 256, 256).contiguous(memory_format=torch.channels_last)
    w = torch.ones(64)
    plan = gn.group_norm_plan(1, 256 * 256, 64, 32, torch.float32)
    assert plan["path"] == "two_launch"
    gn.group_norm_fwd(x, w, w, 32, 1e-5, True)
    args = fake_launch[0][1]
    assert (sizes[0][0], sizes[0][1]) == (2 * 1 * 32 * (plan["splits"] + 1) + 1, torch.float32)
    assert args[6] == sizes[0][2] and args[16] == plan["splits"]
    small = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    gn.group_norm_fwd(small, w, w, 32, 1e-5, False)
    args = fake_launch[1][1]
    assert args[6] is None and args[16] == 0
    assert LAUNCHES["group_norm"] == 2


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_group_norm_plan_takes_the_cards_sm_count(sms):
    """The two-launch grid is at most 4 blocks an SM of the card it runs on
    (one wave), and a one-launch plan's blocks reach two an SM of it where
    the slicings allow."""
    two = gn.group_norm_plan(2, 73728, 320, 32, torch.bfloat16, sms)
    assert two["path"] == "two_launch" and two["grid"] == (4 * sms // 2, 2)
    one = gn.group_norm_plan(36, 4096, 320, 32, torch.bfloat16, sms)
    assert one["path"] == "one_launch" and one["grid"][0] >= 2 * sms


@pytest.mark.parametrize("args,dtype,path,pix,grid,smem", [
    ((2, 18, 4096, 320, 5, 64), torch.bfloat16, "wgmma", 7, 2 * 586, 228440),  # ds1
    ((2, 18, 4097, 320, 5, 64), torch.bfloat16, "wgmma", 7, 2 * 586, 228440),
    ((2, 18, 509, 320, 5, 64), torch.bfloat16, "wgmma", 7, 2 * 73, 228440),
    ((2, 14, 4096, 320, 5, 64), torch.bfloat16, "wgmma", 9, 2 * 456, 228440),
    ((1, 32, 100, 320, 5, 64), torch.bfloat16, "wgmma", 4, 25, 228440),
    ((2, 18, 4096, 320, 5, 64), torch.float32, "fma", 2, 2 * 2048, 131424),
    ((2, 18, 1024, 640, 10, 64), torch.bfloat16, "fma", 2, 2 * 512, 131424),
    ((2, 18, 64, 96, 3, 32), torch.bfloat16, "fma", 2, 2 * 32, None),
])
def test_temporal_block_plan(args, dtype, path, pix, grid, smem):
    """K2's plan: the wgmma + TMA kernel for bf16 at dh = 64 and c = 320
    (128 // t pixels a block, 126 token rows at t = 18 or 14, a block for
    every started group of pixels, 228,440 B: x, the head outputs, k and v
    in 128-row tiles, a 5-slot ring of 6 KB), the FMA kernel otherwise;
    within the card's limit."""
    plan = ttemp.temporal_block_plan(*args, dtype)
    assert (plan["path"], plan["pixels"], plan["grid"]) == (path, pix, grid)
    assert plan["rows"] == pix * args[1] <= (128 if path == "wgmma" else 64)
    assert plan["smem"] <= SMEM_LIMIT
    if smem is not None:
        assert plan["smem"] == smem
    if path == "wgmma":
        assert plan["threads"] == 384 and plan["stages"] == 5


@pytest.mark.parametrize("layout,copied", [("contiguous", False), ("transposed", False),
                                           ("odd", True)])
def test_temporal_block_hands_tma_readable_x(fake_launch, layout, copied):
    """The bf16 wgmma path reads x through a tensor map: strides in
    multiples of 8 elements are passed as they are (a (b, s, t, c) buffer's
    transpose included), others are first copied to a contiguous buffer."""
    b, t, s, c = 1, 18, 12, 320
    if layout == "transposed":
        x = torch.randn(b, s, t, c).to(torch.bfloat16).transpose(1, 2)
    elif layout == "odd":
        x = torch.randn(b, t, s, c + 3).to(torch.bfloat16)[..., :c]
    else:
        x = torch.randn(b, t, s, c).to(torch.bfloat16)
    w = [torch.randn(c, c).to(torch.bfloat16) for _ in range(4)]
    bo = torch.zeros(c, dtype=torch.bfloat16)
    ttemp.temporal_block_fwd(x, *w, bo, 5)
    fn, args = fake_launch[0]
    assert fn == "v3d_temporal_block" and args[8:14] == (b, t, s, c, 5, 64)
    strides = args[14:17]
    assert all(st % 8 == 0 for st in strides)
    assert (args[1] == x.data_ptr()) != copied
    if not copied:
        assert strides == tuple(st if n > 1 else c for st, n in
                                zip(x.stride()[:3], x.shape[:3]))
    assert args[17] is None and LAUNCHES["temporal_block"] == 1
