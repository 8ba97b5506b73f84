"""Host-side logic of the redesigned K9 (wide-head flash forward) and K5
(3DGS compositor backward), on the CPU: K9's launch plan at chip_smoke.py's
phase-3 shapes in both dtypes, what its wrapper hands the kernel (recorded
by a stand-in launch), the plain version of K5's per-tile cull
(``tile_reach``) against the compositor's own alpha test, and phase 3's
recounted K4 / K5 pairs.

Tolerances: plans, arguments and counts are exact; the cull must admit
every (tile, gaussian) pair in which ``composite_plain``'s alpha test
passes at some pixel (no tolerance: one miss fails).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
from v3d_tpu_torch.ops import attention as tattn
from v3d_tpu_torch.ops import flash_attention as fa
from v3d_tpu_torch.ops import gs_composite as gc

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100

# (b, sq, sk, h, d) -> dtype -> (grid, threads, smem, key tiles); smem as
# the library's v3d_flash_attn_fwd_wide_smem reports it on the card
# (chip_smoke.py phase 3 holds the plan to it there)
WIDE_PLANS = {
    ((18, 4096, 4096, 1, 512), torch.bfloat16): ((64, 18), 384, 208968, 128),
    ((18, 4096, 4096, 1, 512), torch.float32): ((64, 18), 256, 201728, 64),
    ((1, 257, 257, 16, 80), torch.bfloat16): ((5, 16), 256, 93256, 3),
    ((1, 257, 257, 16, 80), torch.float32): ((5, 16), 256, 103424, 5),
    ((4, 1024, 1024, 4, 128), torch.bfloat16): ((8, 16), 384, 164936, 8),
    ((4, 1024, 1024, 4, 128), torch.float32): ((16, 16), 256, 103424, 16),
    ((18, 4096, 1, 1, 512), torch.bfloat16): ((64, 18), 384, 208968, 1),
    ((18, 4096, 1, 1, 512), torch.float32): ((64, 18), 256, 201728, 1),
    ((1, 4608, 4608, 24, 128), torch.bfloat16): ((36, 24), 384, 164936, 36),
    ((1, 4608, 4608, 24, 128), torch.float32): ((72, 24), 256, 103424, 72),
}


def test_wide_plans_cover_phase3_shapes():
    assert {shape for shape, _ in WIDE_PLANS} == {s for _, s in chip_smoke.WIDE_SHAPES}


@pytest.mark.parametrize("shape,dtype", list(WIDE_PLANS), ids=[
    f"{s[0]}x{s[1]}x{s[2]}x{s[3]}x{s[4]}-{str(dt).split('.')[-1]}" for s, dt in WIDE_PLANS])
def test_flash_wide_plan(shape, dtype):
    """Grid, threads, shared memory (<= 227 KB), key tiles and one split at
    each phase-3 shape; bf16's TMA boxes are 64-column atoms of 128-byte
    rows and, at d = 80, one 16-column box of 32-byte rows (64 + 16)."""
    b, sq, sk, h, d = shape
    plan = fa.flash_wide_plan(b, h, sq, sk, d, dtype)
    grid, threads, smem, tiles = WIDE_PLANS[shape, dtype]
    assert (plan["grid"], plan["threads"], plan["smem"], plan["kv_tiles"]) == (
        grid, threads, smem, tiles)
    assert plan["smem"] <= SMEM_LIMIT and plan["splits"] == 1
    if dtype == torch.float32:
        assert plan["route"] == "fma"
        assert plan["chunks"] == ({"k": 1, "v": 1} if d == 80 else
                                  {"k": d // 64, "v": 64 // (4096 // d)})
        return
    assert plan["route"] == "wgmma"
    cols = [64] * (d // 64) + ([16] if d == 80 else [])
    bq, bk = fa.WIDE_BF16[d]["block_q"], fa.WIDE_BF16[d]["block_k"]
    assert plan["q_boxes"] == [(bq, n, 2 * n) for n in cols]
    assert plan["kv_boxes"] == [(bk, n, 2 * n) for n in cols]
    assert sum(n for _, n, _ in plan["kv_boxes"]) == d
    # d = 512: two warpgroups share 64 rows and split d; else 64 rows each
    assert plan["split_d"] == (d == 512)
    assert bq == (64 if d == 512 else 64 * plan["consumers"])


def test_flash_wide_plan_refuses_other_widths():
    with pytest.raises(ValueError):
        fa.flash_wide_plan(1, 1, 64, 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_wide_plan(1, 1, 64, 64, 80, torch.float16)


@pytest.fixture
def fake_launch(monkeypatch):
    """Drive a wrapper's CUDA branch on CPU tensors with a launch that
    records its arguments."""
    calls = []

    def record(name, fn_name, device, *args):
        calls.append((fn_name, args))
        LAUNCHES[name] += 1

    for mod in (fa, gc):
        monkeypatch.setattr(mod, "use_plain", lambda *a: False)
        monkeypatch.setattr(mod, "launch", record)
    reset_launch_counts()
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d,pad", [(80, 0), (512, 0), (128, 3)])
def test_flash_wide_hands_its_kernel(fake_launch, monkeypatch, dtype, d, pad):
    """K9's wrapper passes (b, h, s) strides of q/k/v views of (b, s, h, d)
    buffers and of a (b, s, h, d) output; in bf16 an operand a tensor map
    cannot read (rows 3 elements wider) is copied first, with the strides
    of the copy, and a readable one is passed in place; f32 takes any
    strides.  One launch is counted."""
    calls = []
    real = tattn.tma_ready
    monkeypatch.setattr(fa, "tma_ready", lambda x: calls.append(x) or real(x))
    b, s, h = 2, 9, 3
    base = torch.randn(b, s, h, d + pad).to(dtype)
    q = k = v = base[..., :d].transpose(1, 2)
    out = fa.flash_attn_fwd_wide(q, k, v)
    assert out.shape == (b, h, s, d) and out.transpose(1, 2).is_contiguous()
    ((fn, args),) = fake_launch
    assert fn == "v3d_flash_attn_fwd_wide"
    assert args[:2] == (1 if dtype == torch.bfloat16 else 0, d)
    assert args[6:10] == (b, h, s, s)
    strides = args[10:19]
    if dtype == torch.bfloat16:
        assert len(calls) == 3
        # the copy is (b, h, s, d)-contiguous
        want = (h * s * d, s * d, d) if pad else tattn.tma_strides(q)
        assert strides == want * 3
        assert (args[2] == q.data_ptr()) == (not pad)
    else:
        assert not calls and strides == q.stride()[:3] * 3
        assert args[2] == q.data_ptr()
    assert args[19:22] == out.stride()[:3]
    assert LAUNCHES["flash_attn_fwd_wide"] == 1


def test_composite_bwd_hands_prof(fake_launch):
    """K5's wrapper passes the clock64 buffer where one is given, None
    otherwise, after the zeroed dslab."""
    kc, n_tiles = 130, 2
    slab = torch.zeros(1, kc, gc.ATTR)
    cell = torch.zeros(n_tiles, dtype=torch.int32)
    xy = torch.zeros(n_tiles, 2, dtype=torch.int32)
    nch = -(-kc // gc.CHUNK)
    saved = (torch.ones(n_tiles, nch + 1, gc.P), torch.full((n_tiles, gc.P), -1,
             dtype=torch.int32), torch.zeros(n_tiles, dtype=torch.int32))
    cot = (torch.zeros(n_tiles, gc.P, 3), torch.zeros(n_tiles, gc.P),
           torch.zeros(n_tiles, gc.P))
    prof = torch.zeros(n_tiles, gc.BWD_PROF_SLOTS, dtype=torch.int64)
    gc.composite_bwd(slab, cell, xy, saved, *cot)
    gc.composite_bwd(slab, cell, xy, saved, *cot, prof=prof)
    (fn0, a0), (fn1, a1) = fake_launch
    assert fn0 == fn1 == "v3d_gs_composite_bwd"
    assert a0[3:6] == (n_tiles, kc, nch) and len(a0) == 14
    assert a0[-1] is None and a1[-1] == prof.data_ptr()
    assert LAUNCHES["gs_composite_bwd"] == 2


# -- K5's cull: tile_reach against composite_plain's alpha test --

def _slab(rng, n_tiles, k, kind):
    """Random per-tile rows around 2 x 2 tiles: means within 40 px of the
    tiles, covariances of scales 0.3-30 px at any angle, opacities in (0, 1];
    ``kind`` adds the edge cases."""
    mean = rng.uniform(-40, 72, size=(n_tiles, k, 2))
    s1, s2 = np.exp(rng.uniform(math.log(0.3), math.log(30), size=(2, n_tiles, k)))
    th = rng.uniform(0, np.pi, size=(n_tiles, k))
    if kind == "near_degenerate":
        s1 = np.full_like(s1, 200.0)
        s2 = np.exp(rng.uniform(math.log(1e-3), math.log(0.05), size=s2.shape))
    cos, sin = np.cos(th), np.sin(th)
    # conic = inverse covariance of R diag(s1^2, s2^2) R^T
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    a = cos * cos * i1 + sin * sin * i2
    b = cos * sin * (i1 - i2)
    c = sin * sin * i1 + cos * cos * i2
    op = rng.uniform(0, 1, size=(n_tiles, k))
    if kind == "threshold":
        eps = rng.choice([-1e-6, -1e-7, 0.0, 1e-7, 1e-6], size=op.shape)
        op = np.float32(1 / 255) * (1 + eps)
    rows = np.zeros((n_tiles, k, gc.ATTR))
    rows[..., 0:2], rows[..., 2], rows[..., 3], rows[..., 4] = mean, a, b, c
    rows[..., 5:8] = rng.uniform(0, 1, size=(n_tiles, k, 3))
    rows[..., 8], rows[..., 9] = op, rng.uniform(1, 5, size=(n_tiles, k))
    if kind == "zero_rows":
        rows[:, ::3] = 0.0
    if kind == "not_positive_definite":
        rows[:, ::4, 3] = np.sqrt(rows[:, ::4, 2] * rows[:, ::4, 4]) * 1.5
        rows[:, 1::4, 2] *= -1
    return torch.from_numpy(rows.astype(np.float32))


def _passes(slab, tile_xy):
    """(n_tiles, 256, K): composite_plain's alpha test (power <= 0, alpha >=
    1/255) at every pixel, in its float32 order of operations."""
    pix = gc.tile_pixels(tile_xy)
    dx = pix[:, :, None, 0] - slab[:, None, :, 0]
    dy = pix[:, :, None, 1] - slab[:, None, :, 1]
    con = slab[:, None, :, 2:5]
    power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
             - con[..., 1] * dx * dy)
    alpha = torch.clamp(slab[:, None, :, 8] * torch.exp(power), max=gc.ALPHA_MAX)
    return (power <= 0) & (alpha >= gc.ALPHA_MIN)


@pytest.mark.parametrize("kind", ["random", "threshold", "near_degenerate", "zero_rows",
                                  "not_positive_definite"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_reach_is_conservative(kind, seed):
    """No (pixel, gaussian) pair that passes composite_plain's alpha test
    lies in a (tile, gaussian) pair tile_reach rejects; the exact box admits
    no more than the cull; the random slab's cull rejects most pairs."""
    rng = np.random.RandomState(seed)
    tile_xy = torch.tensor([[0, 0], [16, 0], [0, 16], [16, 16]], dtype=torch.int32)
    slab = _slab(rng, 4, 512, kind)
    reach = gc.tile_reach(slab, tile_xy)
    exact = gc.tile_reach(slab, tile_xy, exact=True)
    passing = _passes(slab, tile_xy).any(1)
    assert not (passing & ~reach).any(), int((passing & ~reach).sum())
    assert not (exact & ~reach).any()
    assert not (passing & ~exact).sum() > 0.01 * max(1, int(passing.sum()))
    if kind == "random":
        assert 0 < int(reach.sum()) < 0.5 * reach.numel()
    if kind == "zero_rows":
        assert not reach[:, ::3].any()
    if kind == "not_positive_definite":
        for rows in (slice(0, None, 4), slice(1, None, 4)):
            assert reach[:, rows][slab[:, rows, 8] >= gc.ALPHA_MIN].all()
    if kind == "threshold":
        faint = slab[..., 8] < gc.ALPHA_MIN
        assert faint.any() and not reach[faint].any()


def test_tile_reach_admits_non_finite_rows():
    tile_xy = torch.zeros(1, 2, dtype=torch.int32)
    rows = torch.zeros(1, 3, gc.ATTR)
    rows[..., 2] = rows[..., 4] = 1.0
    rows[..., 0:2] = 1e4                      # far away
    rows[..., 8] = 0.5
    rows[0, 1, 3] = float("nan")
    rows[0, 2, 8] = float("nan")
    assert gc.tile_reach(rows, tile_xy).tolist() == [[False, True, True]]


# -- phase 3's recounted K4 / K5 pairs --

def _t10_saved(slabs):
    """T10's checkpoints on the CPU from the plain formulas: ts (n_tiles,
    n_chunks + 1, 256), each pixel's last composited gaussian, k_stop; T
    stays where it fell below 1e-4, a block stops at a batch start where no
    pixel is live, or after its cell's live gaussians."""
    slab, kc = slabs.slab.detach(), slabs.slab.shape[1]
    n_chunks = -(-kc // gc.CHUNK)
    rows = slab[slabs.cell_of_tile.long()]
    alpha = _passes(rows, slabs.tile_xy) * torch.clamp(
        rows[:, None, :, 8] * torch.exp(_power(rows, slabs.tile_xy)), max=gc.ALPHA_MAX)
    t_excl = torch.cat([torch.ones_like(alpha[..., :1]),
                        torch.cumprod(1 - alpha, -1)[..., :-1]], -1)
    comp = (alpha > 0) & (t_excl >= gc.T_EPS)
    t_run = torch.cat([torch.ones_like(alpha[..., :1]),
                       torch.cumprod(1 - alpha * comp, -1)], -1)  # before each, and after all
    j = torch.arange(kc)
    last = torch.where(comp, j, -1).max(-1).values.int()
    chunks = -(-slabs.live_count.long()[slabs.cell_of_tile.long()] // gc.CHUNK)
    ts = torch.zeros(len(rows), n_chunks + 1, gc.P)
    k_stop = torch.zeros(len(rows), dtype=torch.int32)
    for t in range(len(rows)):
        k = 0
        while k < int(chunks[t]) and (t_run[t, :, k * gc.CHUNK] >= gc.T_EPS).any():
            ts[t, k] = t_run[t, :, k * gc.CHUNK]
            k += 1
        ts[t, k] = t_run[t, :, min(k * gc.CHUNK, kc)]
        k_stop[t] = k
    return (ts, last, k_stop), comp


def _power(slab, tile_xy):
    pix = gc.tile_pixels(tile_xy)
    dx = pix[:, :, None, 0] - slab[:, None, :, 0]
    dy = pix[:, :, None, 1] - slab[:, None, :, 1]
    con = slab[:, None, :, 2:5]
    return -0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy) - con[..., 1] * dx * dy


def test_gs_pairs_count_the_work_the_inputs_need():
    """chip_smoke.gs_pairs on a small fit slab (CPU, T10's checkpoints from
    the plain formulas): composited pairs are those of the plain composite;
    the pairs whose exact 1/255 box meets the tile are at most the
    cell-wide sweep's and at least the composited ones, and the (tile,
    gaussian) pairs of those boxes lie within the cull's; the K4 / K5 bounds
    built from them are below the cell-wide sweep's."""
    slabs = chip_smoke.fit_scene_slabs(torch.device("cpu"), n=3000, res=64, kc=256)
    saved, comp = _t10_saved(slabs)
    pairs = chip_smoke.gs_pairs(slabs, saved)
    last = saved[1].long()
    assert pairs["composited"] == int(comp.sum()) > 0
    assert pairs["tested_bwd"] == int((last + 1).sum())
    assert pairs["composited"] <= pairs["needed_bwd"] <= pairs["tested_bwd"]
    assert pairs["needed_bwd"] <= pairs["needed"] <= pairs["tested"]
    rows = slabs.slab.detach()[slabs.cell_of_tile.long()]
    assert pairs["reach"] == int(gc.tile_reach(rows, slabs.tile_xy, exact=True).sum())
    assert pairs["reach"] <= int(gc.tile_reach(rows, slabs.tile_xy).sum())
    assert (pairs["needed_bwd"] * chip_smoke.GS_FLOPS_TEST
            < pairs["tested_bwd"] * chip_smoke.GS_FLOPS_TEST)
