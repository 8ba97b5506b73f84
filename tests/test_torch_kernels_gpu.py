"""The hand-written kernels against their plain versions on a CUDA device.

Marked ``gpu``; each test skips without a card.  On the card (no JAX there,
so without the repository's conftest):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -o addopts= -q

Ragged, strided and narrow shapes that the main path does not reach
(chip_smoke.py phase 3 covers the main path's shapes), in both dtypes, so
that the f32 FMA variants and the bf16 tensor-core variants, and the
in-place and the copied operands of the TMA kernels, each run; K6's one-
and two-launch paths.  Tolerances:

- float32: max |kernel - plain| <= 1e-4 * max |plain| (f32 sums in another
  order than cuBLAS);
- bfloat16: PSNR >= 40 dB of the bf16 kernel against the plain version in
  float32 on the same (bf16-rounded) inputs, the bound chip_smoke.py states
  (bf16 rounding of q/k/v, P and o);
- the 3DGS compositor (T10 / T11, float32), the bounds chip_smoke.py
  states: rgb and acc max abs <= 1e-4, depth <= 1e-3 (a pair whose
  transmittance sits at the 1e-4 stop may count on one side only); the slab
  gradient per attribute max abs <= 1e-3 x max |plain| of that attribute
  (T11 divides T back and sums with atomics, in another order); T10's
  checkpoints against ``composite_checkpoints_plain``: ts within rtol 1e-5,
  last and k_stop equal except at pixels whose T at the stop lies within
  1e-5 relative of 1e-4 (``chip_smoke.gs_checkpoints_mismatch``);
- K10 (LayerNorm) against LayerNormF32's chain (upcast, PyTorch's f32
  LayerNorm, downcast): in bf16 every element within one bf16 ulp of the
  larger of the two values, that ulp taken at 2^-10 or above, and < 0.1%
  of elements differing.  The f32 values before the rounding differ by
  ~1e-7 of the row's scale (Welford against two passes over the
  registers, another summation order), so a bf16 rounding flips only where
  that lands on a rounding boundary; an output within ~1e-4 of zero (x
  near the row's mean, or cancelled by the bias) has a bf16 ulp below that
  absolute difference, hence the floor.  In f32 max |kernel - plain| <=
  1e-5 x max |plain| (the same f32 differences, on outputs of order 1).
"""

import dataclasses
import math

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu

BF16_MIN_PSNR = 40.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(kernel, plain, *args):
    """Run the kernel on ``args`` and hold it to the plain version."""
    out = kernel(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if out.dtype == torch.float32:
        ref = plain(*args)
        err = float((out - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err
    else:
        ref = plain(*(a.float() if torch.is_tensor(a) else a for a in args))
        mse = float(((out.float() - ref) ** 2).mean())
        psnr = 10 * math.log10(float(ref.abs().max()) ** 2 / mse) if mse else math.inf
        assert psnr >= BF16_MIN_PSNR, psnr


def _strided(shape, dev, dtype, pad=0):
    """A view of ``shape`` whose last dim lies in a row ``pad`` wider: pad 3
    makes the row strides odd, so the kernels take their scalar loads."""
    base = torch.randn(*shape[:-1], shape[-1] + pad, device=dev).to(dtype)
    return base[..., :shape[-1]]


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,pad", [(1, 2, 100, 130, 0), (2, 1, 64, 64, 0),
                                           (1, 3, 1, 257, 0), (2, 2, 70, 200, 3)])
def test_flash_kernel_ragged(dev, dtype, b, h, sq, sk, pad):
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.attention import flash_attn_fwd, flash_attn_fwd_plain

    q = _strided((b, sq, h, 64), dev, dtype, pad).transpose(1, 2)
    k = _strided((b, h, sk, 64), dev, dtype, pad)
    v = _strided((b, sk, h, 64), dev, dtype, pad).transpose(1, 2)
    before = LAUNCHES["flash_attn_fwd"]
    _close(flash_attn_fwd, flash_attn_fwd_plain, q, k, v)
    assert LAUNCHES["flash_attn_fwd"] == before + 1


@pytest.mark.parametrize("which", [0, 1], ids=["qk_k_major", "pv_mn_major"])
def test_k1_wgmma_product_alone(dev, which):
    """Each wgmma product of K1's bf16 kernel alone against torch.matmul on
    the same bf16 inputs (f32 sums): Q K^T with both operands K-major, P V
    with P in registers and V MN-major; a descriptor or fragment-layout
    fault gives errors of the order of the values."""
    from v3d_tpu_torch.ops.attention import wgmma_probe

    gen = torch.Generator(device=dev).manual_seed(which)
    sa, sb = ((64, 64), (128, 64)) if which == 0 else ((64, 128), (128, 64))
    a, b = (torch.randn(*s_, device=dev, generator=gen).to(torch.bfloat16)
            for s_ in (sa, sb))
    got = wgmma_probe(which, a, b)
    torch.cuda.synchronize()
    want = a.float() @ (b.float().t() if which == 0 else b.float())
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("b,h,sq,sk,pad", [(1, 3, 1, 257, 0), (2, 2, 70, 200, 0),
                                           (2, 3, 100, 1, 0), (2, 2, 70, 200, 3),
                                           (1, 2, 300, 129, 3)])
def test_flash_bf16_lse_and_aligned_copy(dev, b, h, sq, sk, pad):
    """K1's bf16 kernel at ragged and tiny sequences (sq = 1, sk = 1, 70 x
    200): PSNR >= 40 dB and log-sum-exp within 1e-3 of the plain version.
    With pad 3 the row strides are no 16-byte multiple, so no tensor map
    can read the views: the wrapper makes aligned copies and launches the
    same kernel once."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops import attention as A

    dt = torch.bfloat16
    q = _strided((b, sq, h, 64), dev, dt, pad).transpose(1, 2)
    k = _strided((b, h, sk, 64), dev, dt, pad)
    v = _strided((b, sk, h, 64), dev, dt, pad).transpose(1, 2)
    for x in (q, k, v):
        copied = A.tma_operand(x) is not x
        assert copied == (pad == 3) == (A.tma_strides(x) is None)
    before = LAUNCHES["flash_attn_fwd"]
    o, lse = A.flash_attn_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attn_fwd"] == before + 1
    ref, lse_ref = A.flash_attn_fwd_plain(q.float(), k.float(), v.float(), with_lse=True)
    assert torch.isfinite(o).all() and _psnr(o, ref) >= BF16_MIN_PSNR, _psnr(o, ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s,heads,pad", [(7, 3, 3), (9, 2, 0), (40, 5, 3)])
def test_temporal_core_kernel_strided(dev, dtype, s, heads, pad):
    """K3 at t = 18, dh = 64 on q/k/v that are slices of one (2, 18, s,
    3 heads*64 + pad) buffer: pad 3 makes the strides odd (element loads),
    pad 0 leaves 16-byte strides (cp.async); one launch."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.temporal_attention import temporal_core, temporal_core_plain

    hd = heads * 64
    qkv = _strided((2, 18, s, 3 * hd), dev, dtype, pad)
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    before = LAUNCHES["temporal_core"]
    _close(temporal_core, temporal_core_plain, q, k, v, heads)
    assert LAUNCHES["temporal_core"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [80, 128, 512])
@pytest.mark.parametrize("b,h,sq,sk,pad", [(1, 2, 100, 130, 0), (2, 1, 64, 1, 0),
                                           (1, 3, 1, 257, 0), (2, 2, 70, 45, 3)])
def test_flash_wide_kernel_ragged(dev, dtype, d, b, h, sq, sk, pad):
    """K9 at each head width: ragged sq and sk (sk down to 1), strided
    (b, h, s, d) views, odd row strides for the scalar-load path."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.flash_attention import (
        flash_attn_fwd_wide,
        flash_attn_fwd_wide_plain,
    )

    q = _strided((b, sq, h, d), dev, dtype, pad).transpose(1, 2)
    k = _strided((b, h, sk, d), dev, dtype, pad)
    v = _strided((b, sk, h, d), dev, dtype, pad).transpose(1, 2)
    before = LAUNCHES["flash_attn_fwd_wide"]
    _close(flash_attn_fwd_wide, flash_attn_fwd_wide_plain, q, k, v)
    assert LAUNCHES["flash_attn_fwd_wide"] == before + 1


@pytest.mark.parametrize("d,which", [(80, 0), (80, 1), (128, 0), (128, 1), (512, 0),
                                     (512, 1)])
def test_k9_wgmma_product_alone(dev, d, which):
    """Each wgmma product of K9's bf16 kernel alone against torch.matmul on
    the same bf16 inputs (f32 sums): Q K^T K-major (d = 80: the 128-byte
    atom and the 32-byte one; d = 512: 32 k-steps of n32 by one
    warpgroup), P V with V MN-major (d = 512: half the columns a
    warpgroup)."""
    from v3d_tpu_torch.ops.flash_attention import WIDE_BF16, flash_wide_probe

    bk = WIDE_BF16[d]["block_k"]
    gen = torch.Generator(device=dev).manual_seed(which)
    sa, sb = ((64, d), (bk, d)) if which == 0 else ((64, bk), (bk, d))
    a, b = (torch.randn(*s_, device=dev, generator=gen).to(torch.bfloat16)
            for s_ in (sa, sb))
    got = flash_wide_probe(d, which, a, b)
    torch.cuda.synchronize()
    want = a.float() @ (b.float().t() if which == 0 else b.float())
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("route,d", [("bh", 64), ("heads", 64), ("packed", 64),
                                     ("bh", 512), ("packed", 80), ("packed", 128)])
def test_flash_routes_launch_their_kernel(dev, dtype, route, d):
    """T2 (bh), T3 (heads-resident) and T4 (packed) on (b, s, h, d) input:
    K1 at d = 64, K9 otherwise, one launch each, against the bshd formula."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops import flash_attention as fa

    fn = {"bh": lambda q, k, v: fa.flash_attention(q, k, v, 64, 64),
          "heads": lambda q, k, v: fa.flash_attention(q, k, v, 64, 64, heads_resident=True),
          "packed": lambda q, k, v: fa.flash_attention_packed(q, k, v, 128, 128)}[route]
    s = 257 if route == "packed" else 192
    q, k, v = (torch.randn(2, s, 3, d, device=dev).to(dtype) for _ in range(3))
    name = "flash_attn_fwd" if d == 64 else "flash_attn_fwd_wide"
    before = LAUNCHES[name]
    _close(fn, fa.xla_reference_bshd, q, k, v)
    assert LAUNCHES[name] == before + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mxu", [False, True])
def test_temporal_batched_routes_launch_k3(dev, dtype, mxu):
    """T5 / T6 on (B, t, h, d): K3 on the (B, t, 1, h*d) view, one launch."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops import temporal_attention as ta

    fn = ta.temporal_attention_mxu if mxu else ta.temporal_attention
    q, k, v = (torch.randn(40, 18, 5, 64, device=dev).to(dtype) for _ in range(3))
    before = LAUNCHES["temporal_core"]
    _close(fn, ta.temporal_attention_packed, q, k, v)
    assert LAUNCHES["temporal_core"] == before + 1


def test_flash_wide_refuses_other_widths(dev):
    from v3d_tpu_torch.ops.flash_attention import flash_attn_fwd_wide

    q = torch.randn(1, 2, 8, 96, device=dev)
    with pytest.raises(ValueError, match="80, 128, 512"):
        flash_attn_fwd_wide(q, q, q)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s,heads,dh", [(18, 7, 3, 64), (5, 3, 2, 100), (32, 2, 1, 16)])
def test_temporal_core_kernel(dev, dtype, t, s, heads, dh):
    from v3d_tpu_torch.ops.temporal_attention import temporal_core, temporal_core_plain

    qkv = torch.randn(2, t, s, 3 * heads * dh, device=dev).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    _close(temporal_core, temporal_core_plain, q, k, v, heads)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("t,s,c,heads,pad", [(18, 5, 96, 3, 0), (4, 64, 64, 1, 0),
                                             (18, 64, 320, 5, 0), (18, 6, 96, 3, 3)])
def test_temporal_block_kernel(dev, dtype, t, s, c, heads, pad):
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
    )

    x = _strided((2, t, s, c), dev, dtype, pad)
    w = [(torch.randn(c, c, device=dev) * c ** -0.5).to(dtype) for _ in range(4)]
    bo = (torch.randn(c, device=dev) * 0.1).to(dtype)
    _close(temporal_block_attention, temporal_block_attention_plain, x, *w, bo, heads)


def _k2_inputs(dev, t, s, layout, c=320, heads=5, b=2):
    """bf16 x (b, t, s, c) contiguous, as a (b, s, t, c) buffer's transpose
    (strides in place for TMA), or with rows 3 elements wider (odd strides:
    the wrapper copies); weights of the ds1 layer."""
    if layout == "transposed":
        x = torch.randn(b, s, t, c, device=dev).to(torch.bfloat16).transpose(1, 2)
    else:
        x = _strided((b, t, s, c), dev, torch.bfloat16, 3 if layout == "odd" else 0)
    w = [(torch.randn(c, c, device=dev) * c ** -0.5).to(torch.bfloat16) for _ in range(4)]
    bo = (torch.randn(c, device=dev) * 0.1).to(torch.bfloat16)
    return x, w, bo


@pytest.mark.parametrize("t,s,layout", [(18, 4096, "contiguous"), (18, 4097, "contiguous"),
                                        (18, 509, "odd"), (14, 4096, "contiguous"),
                                        (14, 509, "transposed"), (18, 100, "transposed")])
def test_temporal_block_wgmma_kernel(dev, t, s, layout):
    """K2's bf16 wgmma + TMA kernel at the ds1 layer's width: ds1 itself, a
    ragged s (4096 + 1 and the prime 509: the last block's pixels past s
    are zero-filled and not stored), t = 14 and 18, strides read in place
    or copied first; one launch counted a call."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
        temporal_block_plan,
    )

    x, w, bo = _k2_inputs(dev, t, s, layout)
    assert temporal_block_plan(2, t, s, 320, 5, 64)["path"] == "wgmma"
    before = LAUNCHES["temporal_block"]
    _close(temporal_block_attention, temporal_block_attention_plain, x, *w, bo, 5)
    assert LAUNCHES["temporal_block"] == before + 1


def test_temporal_block_wgmma_under_autograd(dev):
    """K2 forward under autograd: the output is the kernel's (one launch) and
    the gradients of x and every weight are the plain recompute's
    (``_block_bwd``), equal to autograd through the plain version."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
    )

    x, w, bo = _k2_inputs(dev, 18, 300, "contiguous")
    args = [a.detach().requires_grad_() for a in (x, *w, bo)]
    before = LAUNCHES["temporal_block"]
    out = temporal_block_attention(*args, 5)
    assert LAUNCHES["temporal_block"] == before + 1
    cot = torch.randn(out.shape, device=dev).to(out.dtype)
    got = torch.autograd.grad(out, args, cot)
    ref_args = [a.detach().requires_grad_() for a in args]
    ref_out = temporal_block_attention_plain(*ref_args, 5)
    want = torch.autograd.grad(ref_out, ref_args, cot)
    assert _psnr(out, ref_out) >= BF16_MIN_PSNR
    for g, r in zip(got, want):
        assert torch.allclose(g.float(), r.float(), rtol=0, atol=1e-6 * float(r.abs().max()))


def test_kernels_refuse_instead_of_falling_back(dev):
    from v3d_tpu_torch.ops import reference_mode
    from v3d_tpu_torch.ops.attention import flash_attn_fwd

    q = torch.randn(1, 1, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attn_fwd(q, q, q)
    with reference_mode():  # the explicit switch is the only way to plain
        assert flash_attn_fwd(q, q, q).shape == q.shape


def _gs_slab(dev, n, res, kc, opacity=None, seed=0):
    """A real slab: n seeded gaussians (the trainer's random init) projected
    from one orbit camera at res^2 and binned with Kc = kc (coarse cells when
    the n + 64 slots exceed kc, else one global depth sort)."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.gaussians import from_pcd, random_init_pcd
    from v3d_tpu_torch.gs.render import RasterizeConfig, build_slabs, project_gaussians

    xyz, colors = random_init_pcd(np.random.RandomState(seed), n, radius=2.0)
    g = from_pcd(xyz, colors, capacity=n + 64, device=dev)
    if opacity is not None:
        g = dataclasses.replace(g, opacity=torch.full_like(g.opacity, opacity))
    cam = orbit_cameras(18, resolution=res)[3]
    cfg = RasterizeConfig(coarse_factor=8 if res >= 256 else 2, max_per_coarse=kc)
    return build_slabs(project_gaussians(g, cam), res, res, cfg)


@pytest.mark.parametrize("n,res,kc,opacity", [(3000, 64, 256, None),
                                              (3000, 64, 256, 6.0),
                                              (20000, 256, 1000, None),
                                              (500, 48, 1024, None)])
def test_gs_composite_kernels(dev, n, res, kc, opacity):
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops import gs_composite as gc

    s = _gs_slab(dev, n, res, kc, opacity)
    args = (s.slab.detach(), s.live_count, s.cell_of_tile, s.tile_xy)
    before = dict(LAUNCHES)
    (rgb, acc, dep), saved = gc.composite_fwd(*args)
    torch.cuda.synchronize()
    ref = gc.composite_plain(*args)
    for name, out, r, tol in (("rgb", rgb, ref[0], 1e-4), ("acc", acc, ref[1], 1e-4),
                              ("depth", dep, ref[2], 1e-3)):
        assert torch.isfinite(out).all()
        err = float((out - r).abs().max())
        assert err <= tol, (name, err)
    assert float(acc.max()) > 0.5
    if opacity is not None:   # pixels saturate and stop at T < 1e-4
        assert float(acc.max()) > 1 - 1e-4
    # K4's checkpoints, which K5 reads below, against their plain version
    ckpt = chip_smoke.gs_checkpoints_mismatch(saved, gc.composite_checkpoints_plain(*args))
    print(f"K4 checkpoints: {ckpt}")
    assert ckpt["last"] == ckpt["k_stop"] == 0, ckpt
    assert ckpt["ts_rel"] <= chip_smoke.GS_TS_REL, ckpt

    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(x.shape, device=dev, generator=gen) for x in (rgb, acc, dep)]
    dslab = gc.composite_bwd(args[0], s.cell_of_tile, s.tile_xy, saved, *cot)
    torch.cuda.synchronize()
    slab = args[0].clone().requires_grad_(True)
    (want,) = torch.autograd.grad(gc.composite_plain(slab, *args[1:]), slab, cot)
    for a in range(gc.ATTR):
        scale = float(want[..., a].abs().max())
        err = float((dslab[..., a] - want[..., a]).abs().max())
        assert err <= 1e-3 * scale + 1e-12, (a, err, scale)
    assert LAUNCHES["gs_composite_fwd"] == before["gs_composite_fwd"] + 1
    assert LAUNCHES["gs_composite_bwd"] == before["gs_composite_bwd"] + 1


@pytest.mark.parametrize("n,res,kc,opacity", [(3000, 64, 256, None),
                                              (3000, 64, 256, 6.0),
                                              (20000, 256, 1000, None)])
def test_gs_composite_fwd_cull_count(dev, n, res, kc, opacity):
    """K4's cull admits, per band of a tile, the live gaussians of its cell
    whose box in whole pixels (``reach_boxes``, its plain version, float64
    on the card) meets the band: the kernel's count (clock64 buffer)
    equals the plain count (a boundary case may round either way: within
    2), is at least the exact 1/255 boxes', and the outputs with the
    buffer equal those without, bit for bit."""
    from v3d_tpu_torch.ops import gs_composite as gc

    s = _gs_slab(dev, n, res, kc, opacity)
    args = (s.slab.detach(), s.live_count, s.cell_of_tile, s.tile_xy)
    prof = torch.zeros(len(s.tile_xy), gc.FWD_PROF_SLOTS, dtype=torch.int64, device=dev)
    out0, saved0 = gc.composite_fwd(*args)
    out1, saved1 = gc.composite_fwd(*args, prof=prof)
    torch.cuda.synchronize()
    for x0, x1 in zip(out0 + saved0[1:], out1 + saved1[1:]):
        assert torch.equal(x0, x1)
    cell = s.cell_of_tile.long()
    live = (torch.arange(args[0].shape[1], device=dev)[None]
            < s.live_count.long()[cell][:, None])
    rows = gc.TILE // gc.FWD_SPLIT
    x0, y0 = s.tile_xy[:, 0, None], s.tile_xy[:, 1, None]
    counts = []
    for exact in (False, True):
        boxes = gc.reach_boxes(args[0], exact=exact)[cell]
        counts.append(sum(int((gc.pixel_boxes_meet(
            boxes, x0, x0 + gc.TILE - 1, y0 + k * rows, y0 + k * rows + rows - 1)
            & live).sum()) for k in range(gc.FWD_SPLIT)))
    got = int(prof[:, 4].sum())
    assert abs(got - counts[0]) <= 2 and got >= counts[1], (got, counts)
    # a tile's blocks stage what their culls admitted (no block stops early
    # in one segment), and take some time
    assert (prof[:, 5] <= prof[:, 4]).all() and (prof[:, 0] > 0).all()
    assert (prof[:, 0] >= prof[:, 1]).all() and (prof[:, 0] >= prof[:, 2]).all()


@pytest.mark.parametrize("n,res,kc", [(3000, 64, 256), (20000, 256, 1000)])
def test_gs_composite_bwd_cull_count(dev, n, res, kc):
    """K5's cull admits, per tile, the gaussians tile_reach (its plain
    version, float64 on the card) admits up to the tile's last composited
    one: the kernel's count (clock64 buffer) equals the plain count (a
    boundary case may round either way: within 2), is at least the exact
    1/255 boxes', and the gradient with the buffer equals the one
    without."""
    from v3d_tpu_torch.ops import gs_composite as gc

    s = _gs_slab(dev, n, res, kc)
    args = (s.slab.detach(), s.live_count, s.cell_of_tile, s.tile_xy)
    _, saved = gc.composite_fwd(*args)
    gen = torch.Generator(device=dev).manual_seed(2)
    cot = [torch.randn(shape, device=dev, generator=gen)
           for shape in ((len(s.tile_xy), gc.P, 3), (len(s.tile_xy), gc.P),
                         (len(s.tile_xy), gc.P))]
    prof = torch.zeros(len(s.tile_xy), gc.BWD_PROF_SLOTS, dtype=torch.int64, device=dev)
    d0 = gc.composite_bwd(args[0], s.cell_of_tile, s.tile_xy, saved, *cot)
    d1 = gc.composite_bwd(args[0], s.cell_of_tile, s.tile_xy, saved, *cot, prof=prof)
    torch.cuda.synchronize()
    assert float((d0 - d1).abs().max()) <= 1e-6 * float(d0.abs().max()) + 1e-12
    rows = args[0][s.cell_of_tile.long()]
    block_last = saved[1].max(1).values
    upto = torch.arange(kc, device=dev)[None] <= block_last[:, None]
    plain = int((gc.tile_reach(rows, s.tile_xy) & upto).sum())
    exact = int((gc.tile_reach(rows, s.tile_xy, exact=True) & upto).sum())
    got = int(prof[:, 4].sum())
    assert abs(got - plain) <= 2 and got >= exact, (got, plain, exact)
    assert (prof[:, 0] > 0).all()


def test_gs_render_gradients_through_kernels(dev):
    """render + backward with GSComposite (T10/T11) against the same in
    reference_mode(): parameter gradients within 1e-3 of the largest."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.gaussians import from_pcd, random_init_pcd
    from v3d_tpu_torch.gs.render import RasterizeConfig, render
    from v3d_tpu_torch.ops import reference_mode

    xyz, colors = random_init_pcd(np.random.RandomState(2), 5000, radius=2.0)
    cam = orbit_cameras(18, resolution=128)[5]
    cfg = RasterizeConfig(coarse_factor=4, max_per_coarse=1024)

    def grads():
        g = from_pcd(xyz, colors, capacity=5100, device=dev)
        fields = {k: getattr(g, k).requires_grad_() for k in ("xyz", "opacity", "scaling", "f_dc")}
        out = render(dataclasses.replace(g, **fields), cam, torch.ones(3, device=dev),
                     config=cfg)
        (out.image.square().sum() + out.alpha.sum() + 0.1 * out.depth.sum()).backward()
        return {k: v.grad for k, v in fields.items()}

    got = grads()
    with reference_mode():
        want = grads()
    for k in got:
        scale = float(want[k].abs().max())
        assert scale > 0 and float((got[k] - want[k]).abs().max()) <= 1e-3 * scale, k


def _psnr(out, ref):
    mse = float(((out.float() - ref.float()) ** 2).mean())
    return 10 * math.log10(float(ref.abs().max()) ** 2 / mse) if mse else math.inf


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,silu,scale_dtype", [
    ((3, 64, 9, 7), True, torch.float32),
    ((2, 320, 16, 16), False, torch.float32),
    ((2, 96, 5, 4, 3), True, torch.bfloat16),     # NCTHW, channels_last_3d
    ((1, 2560, 2, 2), True, torch.float32),       # wide C, one row group
    ((40, 128, 3, 1), False, torch.bfloat16)])
def test_group_norm_kernel(dev, dtype, shape, silu, scale_dtype):
    """K6 (T9) against its plain version, in both memory formats it takes."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.group_norm import group_norm_act_plain, group_norm_fwd

    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    x = (torch.randn(*shape, device=dev) * 2 + 0.5).to(dtype).contiguous(memory_format=fmt)
    c = shape[1]
    scale = (1 + 0.1 * torch.randn(c, device=dev)).to(scale_dtype)
    bias = (0.1 * torch.randn(c, device=dev)).to(scale_dtype)
    before = LAUNCHES["group_norm"]
    _close(group_norm_fwd, group_norm_act_plain, x, scale, bias, 32, 1e-5, silu)
    assert LAUNCHES["group_norm"] == before + 1
    assert group_norm_fwd(x, scale, bias, 32, 1e-5, silu).is_contiguous(memory_format=fmt)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,C,spatial,silu,scale_dtype,path", [
    (1, 128, (8, 8), True, torch.float32, "one_launch"),
    (1, 128, (96, 96), False, torch.bfloat16, "one_launch"),
    (2, 320, (18, 64, 64), True, torch.float32, "two_launch"),   # L = 73,728
    (2, 640, (18, 8, 8), True, torch.bfloat16, "one_launch"),
    (36, 2560, (8, 8), False, torch.float32, "one_launch"),
    (36, 320, (16, 16), True, torch.bfloat16, "one_launch"),
    (2, 1280, (18, 16, 16), False, torch.float32, "one_launch"),
    (36, 960, (64, 64), True, torch.bfloat16, "one_launch"),     # clusters of 16
    (2, 640, (18, 32, 32), True, torch.bfloat16, "one_launch"),  # 16, one an SM (bf16)
    (1, 256, (288, 256), True, torch.bfloat16, "two_launch")])
def test_group_norm_one_and_two_launch_paths(dev, dtype, B, C, spatial, silu,
                                             scale_dtype, path):
    """K6's two paths (``group_norm_plan``) against the plain version, one
    launch counted a call; a second call gives the same bits (fixed
    summation order; the two-launch path's tickets are back at 0)."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.group_norm import (
        group_norm_act_plain,
        group_norm_fwd,
        group_norm_plan,
    )

    fmt = torch.channels_last if len(spatial) == 2 else torch.channels_last_3d
    x = (torch.randn(B, C, *spatial, device=dev) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=fmt)
    assert group_norm_plan(B, x[0, 0].numel(), C, 32, dtype)["path"] == path
    scale = (1 + 0.1 * torch.randn(C, device=dev)).to(scale_dtype)
    bias = (0.1 * torch.randn(C, device=dev)).to(scale_dtype)
    before = LAUNCHES["group_norm"]
    _close(group_norm_fwd, group_norm_act_plain, x, scale, bias, 32, 1e-5, silu)
    assert LAUNCHES["group_norm"] == before + 1
    first = group_norm_fwd(x, scale, bias, 32, 1e-5, silu)
    assert torch.equal(first, group_norm_fwd(x, scale, bias, 32, 1e-5, silu))
    assert LAUNCHES["group_norm"] == before + 3


def test_group_norm_two_launch_on_two_streams(dev):
    """Two-launch calls running at once on two streams: each call zeroes
    the tickets in its own scratch, so both give the one-stream bits."""
    from v3d_tpu_torch.ops.group_norm import group_norm_fwd, group_norm_plan

    xs = [(torch.randn(2, 320, 18, 64, 64, device=dev) + k).to(torch.bfloat16)
          .contiguous(memory_format=torch.channels_last_3d) for k in range(2)]
    assert group_norm_plan(2, 73728, 320, 32, torch.bfloat16)["path"] == "two_launch"
    w = torch.ones(320, device=dev)
    want = [group_norm_fwd(x, w, w, 32, 1e-5, True) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    got = [None, None]
    for _ in range(3):
        for k, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                got[k] = group_norm_fwd(x, w, w, 32, 1e-5, True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_group_norm_refuses_nchw(dev):
    from v3d_tpu_torch.ops.group_norm import group_norm_fwd

    x = torch.randn(2, 64, 8, 8, device=dev)
    w = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="channels-last"):
        group_norm_fwd(x, w, w)


@pytest.mark.parametrize("b,h,sq,sk,pad", [(1, 2, 100, 130, 0), (2, 1, 64, 64, 0),
                                           (1, 3, 1, 257, 0), (2, 2, 70, 200, 3),
                                           (1, 5, 1024, 1024, 0),
                                           (1, 5, 4096, 4096, 0),    # ds1 rows
                                           (2, 2, 130, 40, 0),       # sk < 64
                                           (1, 2, 257, 1000, 3),     # sq != sk, copied
                                           (2, 10, 1024, 1024, 0)])  # ds2
def test_flash_bwd_kernels(dev, b, h, sq, sk, pad):
    """K1's log-sum-exp, then K8 (dq) and K7 (dk, dv) against the plain
    backward on the same inputs in float32: PSNR >= 40 dB each.  With pad 3
    no tensor map can read the views, so the wrapper copies them first.  A
    second call gives bitwise the same gradients (no atomics)."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.attention import (
        flash_attn_bwd,
        flash_attn_bwd_plain,
        flash_attn_fwd,
        flash_attn_fwd_plain,
    )

    dt = torch.bfloat16
    q = _strided((b, sq, h, 64), dev, dt, pad).transpose(1, 2)
    k = _strided((b, h, sk, 64), dev, dt, pad)
    v = _strided((b, sk, h, 64), dev, dt, pad).transpose(1, 2)
    do = _strided((b, sq, h, 64), dev, dt, pad).transpose(1, 2)
    o, lse = flash_attn_fwd(q, k, v, with_lse=True)
    _, lse_ref = flash_attn_fwd_plain(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    before = dict(LAUNCHES)
    got = flash_attn_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = flash_attn_bwd_plain(*(x.float() for x in (q, k, v, o)), lse, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _psnr(g, w) >= BF16_MIN_PSNR, (name, _psnr(g, w))
    assert LAUNCHES["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 1
    assert LAUNCHES["flash_attn_bwd_dkv"] == before["flash_attn_bwd_dkv"] + 1
    again = flash_attn_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("which", [0, 1], ids=["rs_k_major", "rs_mn_major"])
def test_k7_wgmma_product_alone(dev, which):
    """K7's register-A products alone against torch.matmul on the same bf16
    inputs (f32 sums): a (64, 64) read into A fragments as K7 reads K and
    V, times b^T with b K-major (the new ``wgmma_m64n64k16_rs_k``, S^T = K
    Q^T) or times b with b MN-major from a 64-row tile (dV += P^T dO)."""
    from v3d_tpu_torch.ops.attention import flash_bwd_wgmma_probe

    gen = torch.Generator(device=dev).manual_seed(10 + which)
    a, b = (torch.randn(64, 64, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    got = flash_bwd_wgmma_probe(which, a, b)
    torch.cuda.synchronize()
    want = a.float() @ (b.float().t() if which == 0 else b.float())
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_attention_and_temporal_gradients_through_kernels(dev):
    """flash_attention, temporal_core and temporal_block_attention under
    autograd (K1 + K8/K7; K3, K2 forwards with recomputed plain backwards)
    against the same in reference_mode(): every gradient PSNR >= 40 dB."""
    from v3d_tpu_torch.ops import reference_mode
    from v3d_tpu_torch.ops.attention import flash_attention
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_core,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    qkv = leaf(2, 256, 3, 2, 64)
    xt = leaf(1, 18, 64, 128)
    wt = [leaf(128, 128, scale=128 ** -0.5) for _ in range(4)] + [leaf(128, scale=0.1)]
    ct = leaf(1, 18, 16, 3 * 128)

    def grads():
        ins = [t.clone().requires_grad_() for t in (qkv, xt, *wt, ct)]
        q, k, v = ins[0].unbind(2)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        blk = temporal_block_attention(ins[1], *ins[2:7], 2)
        c = ins[7]
        core = temporal_core(c[..., :128], c[..., 128:256], c[..., 256:], 2)
        loss = (out.float() ** 2).sum() + (blk.float() ** 2).sum() + (core.float() ** 2).sum()
        loss.backward()
        return [t.grad for t in ins]

    got = grads()
    with reference_mode():
        want = grads()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all() and _psnr(g, w) >= BF16_MIN_PSNR, (i, _psnr(g, w))


def test_every_groupnorm_input_on_the_paths_is_channels_last(dev, monkeypatch):
    """K6 raises on memory that is not channels-last rather than copy; a
    tiny generation (UNet, VAE encode and temporal decode) and a tiny
    fine-tune step (bf16 compute, checkpointing) run through it on the card,
    5-D temporal GroupNorms included."""
    import chip_smoke
    from v3d_tpu_torch.apps.generate import sample_one
    from v3d_tpu_torch.apps.train_diffusion import batches
    from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer
    from v3d_tpu_torch.ops import group_norm as gn

    seen = []
    fwd = gn.group_norm_fwd

    def checked(x, *args):
        seen.append((tuple(x.shape), gn.channels_last_rows(x) is not None))
        return fwd(x, *args)

    monkeypatch.setattr(gn, "group_norm_fwd", checked)
    engine = build_tiny_engine(num_frames=4, num_steps=1, device=dev)
    sample_one(chip_smoke.synthetic_image(96), engine=engine, resolution=64)
    n_gen = len(seen)
    engine = build_tiny_engine(num_frames=4, device=dev, unet_overrides=dict(
        use_checkpoint=True, compute_dtype=torch.bfloat16))
    trainer = DiffusionTrainer(engine, num_frames=4)
    trainer.fit(batches(engine, SyntheticOrbitDataset(2, 4, 8, clip_dim=64), 1, 4),
                max_steps=1, log_fn=lambda s: None)
    torch.cuda.synchronize()
    assert n_gen > 50 and len(seen) > n_gen
    assert [s for s, ok in seen if not ok] == []
    assert any(len(s) == 5 for s, _ in seen)


# K10's shapes: both UNets' levels and CLIP ViT-H's rows (chip_smoke's
# tables), an odd row count, widths that take the generic instance (16-byte
# packs at 1000, single elements at 333), rows at a wider pitch
K10_SHAPES = ([s for s, _ in chip_smoke.K10_FORWARD_SHAPES + chip_smoke.K10_IMAGE_SHAPES]
              + [(257, 1280), (1001, 320), (300, 1000), (77, 333), (500, 4096)])
K10_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


def _bf16_ulp(a, b):
    """One bf16 ulp at the larger magnitude of a and b and 2^-10,
    elementwise (8 significant bits: 2^(e - 8) for |v| = m 2^e, m in [0.5,
    1)); the floor: module docstring."""
    big = torch.maximum(a.float().abs(), b.float().abs()).clamp(min=2.0 ** -10)
    _, e = torch.frexp(big)
    return torch.ldexp(torch.ones_like(big), e - 8)


def _hold_k10(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape and torch.isfinite(out).all()
    if out.dtype == torch.float32:
        err = float((out - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
    else:
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= _bf16_ulp(out, ref)).all()), float(diff.max())
        assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("dtype,pdtype", K10_DTYPES,
                         ids=["bf16", "bf16_f32params", "f32", "f32_bf16params"])
@pytest.mark.parametrize("rows,C", K10_SHAPES)
def test_layer_norm_kernel(dev, rows, C, dtype, pdtype):
    """K10 against its plain version (LayerNormF32's chain), one launch
    counted a call."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_f32_plain

    gen = torch.Generator(device=dev).manual_seed(rows + C)
    x = (torch.randn(rows, C, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(C, device=dev, generator=gen)).to(pdtype)
    b = (0.1 * torch.randn(C, device=dev, generator=gen)).to(pdtype)
    before = LAUNCHES["layer_norm"]
    out = layer_norm_f32(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_norm"] == before + 1
    _hold_k10(out, layer_norm_f32_plain(x, w, b, 1e-5))


def test_layer_norm_kernel_strided_rows(dev):
    """Rows at a pitch wider than C: 16-byte packs at a pitch of 400 bf16,
    single elements at 321; 3-D tokens whose leading dims collapse."""
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_f32_plain

    w = torch.rand(320, device=dev).to(torch.bfloat16)
    b = torch.rand(320, device=dev).to(torch.bfloat16)
    for pitch in (400, 321):
        x = torch.randn(999, pitch, device=dev).to(torch.bfloat16)[:, :320]
        _hold_k10(layer_norm_f32(x, w, b), layer_norm_f32_plain(x, w, b))
    x = torch.randn(4, 18, 70, 400, device=dev).to(torch.bfloat16)[..., 40:360]
    _hold_k10(layer_norm_f32(x, w, b), layer_norm_f32_plain(x, w, b))


def test_layer_norm_kernel_refuses(dev):
    """C above K10's maximum, a non-unit stride on C, and parameters on
    another device raise; nothing launches."""
    from v3d_tpu_torch.ops import LAUNCHES
    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32

    w = torch.ones(320, device=dev)
    before = LAUNCHES["layer_norm"]
    with pytest.raises(ValueError, match="above"):
        layer_norm_f32(torch.randn(4, 4097, device=dev), torch.ones(4097, device=dev),
                       torch.ones(4097, device=dev))
    with pytest.raises(ValueError, match="unit stride"):
        layer_norm_f32(torch.randn(320, 4, device=dev).t(), w, w)
    with pytest.raises(ValueError, match="several devices"):
        layer_norm_f32(torch.randn(4, 320, device=dev), w.cpu(), w)
    assert LAUNCHES["layer_norm"] == before


def test_layer_norm_in_a_ds1_spatial_video_transformer(dev):
    """V3D's ds1 SpatialVideoTransformer (320 channels, 5 heads of 64, the
    CFG-doubled 36 frames at 64^2) under no_grad: its 7 LayerNorms take K10,
    and the block agrees with the same forward in ``reference_mode()``
    (PSNR >= 40 dB, this file's bf16 bound)."""
    from v3d_tpu_torch.models.layers import LayerNormF32
    from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from v3d_tpu_torch.ops import LAUNCHES, reference_mode

    torch.manual_seed(0)
    block = SpatialVideoTransformer(320, 5, 64, context_dim=1024).to(dev)
    for m in block.modules():
        if isinstance(m, LayerNormF32):
            torch.nn.init.normal_(m.weight, 1.0, 0.1)
            torch.nn.init.normal_(m.bias, 0.0, 0.1)
    block = block.to(torch.bfloat16)
    x = torch.randn(36, 320, 64, 64, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(36, 1, 1024, device=dev).to(torch.bfloat16)
    ind = torch.zeros(2, 18, device=dev)
    with torch.no_grad():
        before = LAUNCHES["layer_norm"]
        out = block(x, ctx, 18, ind)
        torch.cuda.synchronize()
        assert LAUNCHES["layer_norm"] == before + 7
        with reference_mode():
            ref = block(x, ctx, 18, ind)
    assert torch.isfinite(out).all()
    assert _psnr(out, ref) >= BF16_MIN_PSNR, _psnr(out, ref)
