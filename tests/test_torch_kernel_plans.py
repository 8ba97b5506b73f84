"""Host-side logic around the redesigned kernels K1 (flash forward, wgmma +
TMA), K3 (temporal core) and K7/K8 (flash backward, wgmma + TMA), on the
CPU: which operands a tensor map can read in place and the aligned copy
made of the others, each kernel's launch plan at the main path's shapes,
the phase-3 work and bound formulas of chip_smoke.py, and CPU tensors
reaching the plain versions with no launch (against the JAX package's
Pallas kernels in interpret mode, or jax.vjp of its attention formula).

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
from v3d_tpu_torch.ops import LAUNCHES
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
