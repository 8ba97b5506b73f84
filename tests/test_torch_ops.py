"""The port's kernel wrappers on the CPU: each plain version against the JAX
kernel it stands for (Pallas in interpret mode, as the JAX package's own tests
run it, or its plain reference), and the dispatch rules (plain version only
for CPU tensors or inside reference_mode, validation before any launch, the
launch counter).

Tolerances: float32 on both sides; the Pallas kernels use an online softmax
or another summation order than the port's two-matmul formula, so results
agree to ~1e-6 and are held to rtol 2e-4 / atol 2e-5, the bound the JAX
package's own flash test uses (tests/test_flash_attention.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import rand, t
from v3d_tpu.ops import flash_attention as jfa
from v3d_tpu.ops.attention import attention_bhsd, xla_attention
from v3d_tpu.ops.temporal_attention import _block_xla, _pallas_block, _pallas_core
from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts
from v3d_tpu_torch.ops import _dispatch
from v3d_tpu_torch.ops import attention as tattn
from v3d_tpu_torch.ops import group_norm, layer_norm
from v3d_tpu_torch.ops import temporal_attention as ttemp

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("b,h,sq,sk", [(2, 3, 256, 256), (1, 2, 128, 384)])
def test_flash_plain_matches_pallas_flash_interpret(b, h, sq, sk):
    """K1's plain version vs the JAX package's Pallas flash kernel (T2, the
    same math as the stock kernel T1) in interpret mode."""
    q, k, v = rand((b, h, sq, 64), 0), rand((b, h, sk, 64), 1), rand((b, h, sk, 64), 2)
    ref = jfa._flash_forward(*(jnp.asarray(x.reshape(b * h, -1, 64)) for x in (q, k, v)),
                             128, 128, interpret=True)
    got = tattn.flash_attn_fwd(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, h, sq, 64),
                               rtol=RTOL, atol=ATOL)


def test_flash_wrapper_takes_projection_views():
    """q/k/v as (b, h, s, d) views of (b, s, h, d) projections: same result
    as contiguous inputs, and as the JAX bhsd attention (plain on CPU)."""
    b, s, h = 2, 192, 3
    x = [rand((b, s, h, 64), i) for i in range(3)]
    views = [t(a).transpose(1, 2) for a in x]
    got = tattn.flash_attn_fwd(*views)
    ref = attention_bhsd(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    contiguous = tattn.flash_attn_fwd(*(v.contiguous() for v in views))
    np.testing.assert_allclose(got.numpy(), contiguous.numpy(), rtol=0, atol=0)


def test_attention_plain_matches_xla_attention():
    """The plain formula used at every non-kernel site (cross-attention, CLIP
    d=80, the VAE's d=512) vs xla_attention on the bshd layout."""
    q, k, v = rand((2, 50, 4, 80), 3), rand((2, 7, 4, 80), 4), rand((2, 7, 4, 80), 5)
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tattn.attention_plain(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_attention_plain_batch_chunking(monkeypatch):
    """Chunking the batch to bound the logits' memory changes nothing."""
    q, k, v = (t(rand((5, 33, 2, 16), i)) for i in range(3))
    whole = tattn.attention_plain(q, k, v)
    monkeypatch.setattr(tattn, "_LOGIT_BYTES_PER_CHUNK", 2 * 33 * 33 * 4 * 2)
    assert len(tattn._batch_chunks(5, 2 * 33 * 33 * 4)) == 3
    np.testing.assert_allclose(tattn.attention_plain(q, k, v).numpy(),
                               whole.numpy(), rtol=0, atol=0)


def _to_core(x, heads):
    """(b, t, s, h*d) -> the JAX core's (t, d, n) layout, n = (b, s, h)."""
    b, tt, s, hd = x.shape
    d = hd // heads
    return x.reshape(b, tt, s, heads, d).transpose(1, 4, 0, 2, 3).reshape(tt, d, -1)


@pytest.mark.parametrize("b,s,heads,d", [(2, 5, 3, 16), (1, 16, 2, 64)])
def test_temporal_core_plain_matches_pallas_core_interpret(b, s, heads, d):
    """K3's plain version vs _pallas_core (T7) in interpret mode."""
    tt = 18
    q, k, v = (rand((b, tt, s, heads * d), i + 10) for i in range(3))
    ref = _pallas_core(*(jnp.asarray(_to_core(x, heads)) for x in (q, k, v)),
                       block=16, interpret=True)
    got = ttemp.temporal_core(t(q), t(k), t(v), heads)
    np.testing.assert_allclose(_to_core(got.numpy(), heads), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_temporal_block_plain_matches_pallas_block_interpret():
    """K2's plain version (torch Linear weights, (out, in)) vs _pallas_block
    (T8) in interpret mode and vs its plain reference _block_xla."""
    b, tt, s, c, heads = 1, 18, 64, 32, 2
    x = rand((b, tt, s, c), 20)
    wq, wk, wv, wo = (rand((c, c), 21 + i, c ** -0.5) for i in range(4))
    bo = rand((c,), 25, 0.1)
    jargs = [jnp.asarray(a) for a in (x, wq.T, wk.T, wv.T, wo.T, bo)]
    ref_kernel = _pallas_block(*jargs, heads, interpret=True)
    ref_plain = _block_xla(*jargs, heads)
    got = ttemp.temporal_block_attention(t(x), t(wq), t(wk), t(wv), t(wo), t(bo), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_plain), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_plain_versions_without_counting():
    reset_launch_counts()
    x = torch.randn(1, 18, 8, 32)
    ttemp.temporal_core(x, x, x, 2)
    ttemp.temporal_block_attention(x, *(torch.randn(32, 32) for _ in range(4)),
                                   torch.randn(32), 2)
    q = torch.randn(1, 1, 64, 64)
    tattn.flash_attn_fwd(q, q, q)
    g = torch.randn(2, 64, 3, 4, 1)
    w = torch.ones(64)
    group_norm.group_norm_apply_fwd(g, group_norm.group_norm_stats_fwd(g, 32), w, w, 32,
                                    3 * 4 * 2)
    layer_norm.layer_norm_f32(x, torch.ones(32), torch.zeros(32))
    assert LAUNCHES == {"flash_attn_fwd": 0, "temporal_block": 0, "temporal_core": 0,
                        "gs_composite_fwd": 0, "gs_composite_bwd": 0,
                        "group_norm": 0, "group_norm_stats": 0, "group_norm_apply": 0,
                        "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
                        "flash_attn_fwd_wide": 0, "layer_norm": 0}


def test_reference_mode_is_scoped():
    assert not _dispatch._REFERENCE
    with pytest.raises(RuntimeError):
        with reference_mode():
            assert _dispatch._REFERENCE
            raise RuntimeError("leave the block")
    assert not _dispatch._REFERENCE


def test_devices_without_a_path_raise():
    meta = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        tattn.flash_attn_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match="several devices"):
        _dispatch.use_plain(torch.zeros(1), meta)


@pytest.fixture
def kernel_path(monkeypatch):
    """Drive the wrappers' CUDA branch on CPU tensors: no plain version, and
    a launch that records its arguments instead of calling the library."""
    calls = []

    def fake_launch(name, fn_name, device, *args):
        calls.append((name, fn_name, args))
        _dispatch.LAUNCHES[name] += 1

    monkeypatch.setattr(tattn, "use_plain", lambda *a: False)
    monkeypatch.setattr(ttemp, "use_plain", lambda *a: False)
    monkeypatch.setattr(tattn, "launch", fake_launch)
    monkeypatch.setattr(ttemp, "launch", fake_launch)
    reset_launch_counts()
    return calls


def test_flash_wrapper_validates_and_counts(kernel_path):
    q = torch.randn(2, 7, 3, 64).transpose(1, 2)  # projection view
    o = tattn.flash_attn_fwd(q, q, q)
    assert o.shape == (2, 3, 7, 64) and o.transpose(1, 2).is_contiguous()
    name, fn, args = kernel_path[0]
    assert (fn, args[0], args[5:9]) == ("v3d_flash_attn_fwd", 0, (2, 3, 7, 7))
    assert args[9:12] == q.stride()[:3] and args[18:21] == o.stride()[:3]
    assert LAUNCHES["flash_attn_fwd"] == 1
    for bad in (torch.randn(2, 3, 7, 32),                     # d != 64
                torch.randn(2, 3, 7, 64, dtype=torch.float16),  # dtype
                torch.randn(2, 3, 64, 7).transpose(2, 3)):       # d strided
        with pytest.raises((ValueError, TypeError)):
            tattn.flash_attn_fwd(bad, bad, bad)
    with pytest.raises(ValueError):
        tattn.flash_attn_fwd(q, torch.randn(2, 4, 7, 64), torch.randn(2, 4, 7, 64))
    assert LAUNCHES["flash_attn_fwd"] == 1


def test_temporal_core_wrapper_validates_and_counts(kernel_path):
    qkv = torch.randn(2, 18, 5, 3 * 128)
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    o = ttemp.temporal_core(q, k, v, 2)
    assert o.shape == (2, 18, 5, 128) and o.is_contiguous()
    _, fn, args = kernel_path[0]
    assert fn == "v3d_temporal_core" and args[5:10] == (2, 18, 5, 2, 64)
    assert args[10:13] == q.stride()[:3]
    for bad_args in ((q, k, v, 3),                              # 128 % 3
                     (torch.randn(1, 33, 2, 64),) * 3 + (1,),   # t > 32
                     (torch.randn(1, 4, 2, 256),) * 3 + (1,)):  # dh > 128
        with pytest.raises(ValueError):
            ttemp.temporal_core(*bad_args)
    assert LAUNCHES["temporal_core"] == 1


def test_temporal_block_wrapper_validates_and_counts(kernel_path):
    x = torch.randn(1, 18, 64, 32)
    w = [torch.randn(32, 32) for _ in range(4)] + [torch.randn(32)]
    out = ttemp.temporal_block_attention(x, *w, 2)
    assert out.shape == x.shape
    _, fn, args = kernel_path[0]
    assert fn == "v3d_temporal_block" and args[8:14] == (1, 18, 64, 32, 2, 16)
    with pytest.raises(ValueError, match="wo"):
        ttemp.temporal_block_attention(x, *w[:3], w[3][:, :16].contiguous(),
                                       w[4], 2)
    # f32, c = 704 in 11 heads of 64: the FMA kernel's tiles need 242,016 B
    big = torch.randn(1, 18, 64, 704)
    wb = [torch.randn(704, 704) for _ in range(4)] + [torch.randn(704)]
    assert ttemp.temporal_block_plan(1, 18, 64, 704, 11, 64, torch.float32)["smem"] > 232448
    with pytest.raises(ValueError, match="shared memory"):
        ttemp.temporal_block_attention(big, *wb, 11)
    assert LAUNCHES["temporal_block"] == 1
