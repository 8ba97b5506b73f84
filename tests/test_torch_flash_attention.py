"""The port's attention routes against the JAX package's on the CPU: T2
(``flash_attention``'s bh path), T3 (``heads_resident``), T4
(``flash_attention_packed``), the backend pickers and ``attention()``; T5 and
T6 (``temporal_attention`` / ``temporal_attention_mxu``); C4.

On the JAX side the Pallas forwards run in interpret mode, as
tests/test_flash_attention.py runs them (pytest's monkeypatch on
``v3d_tpu.ops.flash_attention._flash_forward`` / ``_flash_heads_forward`` /
``_flash_packed_forward``); a counter shows the kernel, and not the JAX
wrapper's fallback, ran.  The port's CPU path is the kernels' plain version.

Tolerances, float32 on both sides: rtol 2e-4 / atol 2e-5 for forwards and
atol 2e-4 for gradients, the bounds of the JAX package's own flash tests
(online softmax against the two-matmul formula, ~1e-6 apart); the batched
temporal APIs atol 1e-4, the bound of tests/test_temporal_attention.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import TPUJax, rand, t
from v3d_tpu.ops import attention as jattn
from v3d_tpu.ops import flash_attention as jfa
from v3d_tpu.ops import temporal_attention as jta
from v3d_tpu_torch.ops import attention as pattn
from v3d_tpu_torch.ops import flash_attention as pfa
from v3d_tpu_torch.ops import temporal_attention as pta

FWD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Pallas forwards in interpret mode; returns their call counts."""
    calls = {"T2": 0, "T3": 0, "T4": 0}
    for tag, name in (("T2", "_flash_forward"), ("T3", "_flash_heads_forward"),
                      ("T4", "_flash_packed_forward")):
        orig = getattr(jfa, name)

        def run(*args, _orig=orig, _tag=tag):
            calls[_tag] += 1
            return _orig(*args, interpret=True)

        monkeypatch.setattr(jfa, name, run)
    return calls


def _qkv(b, sq, sk, h, d, seed):
    return rand((b, sq, h, d), seed), rand((b, sk, h, d), seed + 1), rand((b, sk, h, d), seed + 2)


# (b, sq, sk, h, d, block_q, block_k, JAX kernel runs): d = 16 and 80 fail
# the JAX wrapper's d test, (100, 64) does not tile: the plain formula there
FLASH_CASES = [
    (2, 128, 128, 2, 64, 64, 64, True),
    (2, 96, 1, 3, 128, 256, 256, True),     # one key: block_k clamps to 1
    (1, 64, 64, 1, 512, 32, 32, True),      # the VAE's single head
    (1, 100, 100, 2, 64, 64, 64, False),    # untiled: the fallback
    (1, 64, 64, 2, 80, 32, 32, False),      # CLIP's d
    (2, 32, 32, 2, 16, 32, 32, False),
]


@pytest.mark.parametrize("b,sq,sk,h,d,bq,bk,kernel", FLASH_CASES)
def test_flash_attention_bh_matches_t2(interpret, b, sq, sk, h, d, bq, bk, kernel):
    q, k, v = _qkv(b, sq, sk, h, d, 0)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq, bk)
    assert interpret["T2"] == int(kernel)
    got = pfa.flash_attention(t(q), t(k), t(v), bq, bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("h", [3, 10])
def test_flash_attention_heads_resident_matches_t3(interpret, h):
    q, k, v = _qkv(2, 128, 128, h, 64, 3)
    ref = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), 64, 64,
                              heads_resident=True)
    assert interpret == {"T2": 0, "T3": 1, "T4": 0}
    got = pfa.flash_attention(t(q), t(k), t(v), 64, 64, heads_resident=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 128, 128, 3, 64), (1, 64, 64, 2, 80),
                                         (1, 64, 1, 2, 128), (1, 64, 64, 1, 512)])
def test_flash_attention_packed_matches_t4(interpret, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, 6)
    ref = jfa.flash_attention_packed(*(jnp.asarray(x) for x in (q, k, v)), 64, 64)
    assert interpret["T4"] == 1
    got = pfa.flash_attention_packed(t(q), t(k), t(v), 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("packed,d", [(False, 64), (False, 128), (True, 64), (True, 80)])
def test_flash_routes_gradients_match_jax_grad(interpret, packed, d):
    """The port's recompute backward against jax.grad through the JAX custom
    VJPs (_flash_bh_bwd / _flash_packed_bwd), the forwards interpreted."""
    q, k, v = _qkv(1, 64, 64, 2, d, 9)
    w = rand((1, 64, 2, d), 12)
    jfn = jfa.flash_attention_packed if packed else jfa.flash_attention
    pfn = pfa.flash_attention_packed if packed else pfa.flash_attention

    def loss(q, k, v):
        return jnp.sum(jfn(q, k, v, 32, 32) * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    assert interpret["T4" if packed else "T2"] >= 1
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    (pfn(*ins, 32, 32) * t(w)).sum().backward()
    for r, x in zip(ref, ins):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), rtol=2e-3, atol=2e-4)


@pytest.fixture
def overrides():
    """Restore both packages' backend setters after the test."""
    yield
    for mod in (jattn, pattn):
        mod.set_default_backend("auto")
        mod.set_spatial_override(None)


@pytest.mark.parametrize("override", [None, "packed", "flash", "flash_jax"])
def test_pickers_match_jax(monkeypatch, overrides, override):
    """``_pick_backend_dims`` / ``_pick_backend_bhsd`` against the JAX pickers,
    on the card (the JAX side told it runs on a TPU) and off it."""
    jattn.set_spatial_override(override)
    pattn.set_spatial_override(override)
    grid = [(sq, sk, d) for sq in (64, 256, 512, 1000, 1024, 1536, 2048, 2560, 4096)
            for sk in (1, sq) for d in (32, 64, 80, 512)]
    off = [(jattn._pick_backend_dims(*g), jattn._pick_backend_bhsd(*g)) for g in grid]
    monkeypatch.setattr(jattn, "jax", TPUJax())
    on = [(jattn._pick_backend_dims(*g), jattn._pick_backend_bhsd(*g)) for g in grid]
    for g, want_on, want_off in zip(grid, on, off):
        assert (pattn._pick_backend_dims(*g, True),
                pattn._pick_backend_bhsd(*g, True)) == want_on, g
        assert (pattn._pick_backend_dims(*g, False),
                pattn._pick_backend_bhsd(*g, False)) == want_off == ("xla", "xla"), g
    assert {p for pair in on for p in pair} >= {"xla", override or "flash_jax"}


# (backend, shape, route): "auto" picks "xla" off the card; a "flash" call
# whose blocks do not tile falls back to "xla" on both sides.  (200 tokens
# under "packed" is C4, tested below.)
DISPATCH_CASES = [(backend, shape, route)
                  for shape in ((2, 256, 256, 2, 64), (2, 256, 1, 2, 64), (1, 256, 256, 1, 128))
                  for backend, route in (("xla", "xla"), ("flash", "flash"),
                                         ("packed", "packed"), ("auto", "xla"))]
DISPATCH_CASES += [("flash", (1, 200, 200, 2, 64), "xla"), ("auto", (1, 200, 200, 2, 64), "xla")]


@pytest.mark.parametrize("backend,shape,route", DISPATCH_CASES)
def test_attention_dispatcher_matches_jax(interpret, overrides, backend, shape, route):
    """``attention()`` under each backend the CPU can run on both sides."""
    b, sq, sk, h, d = shape
    q, k, v = _qkv(b, sq, sk, h, d, 15)
    jattn.set_default_backend(backend)
    pattn.set_default_backend(backend)
    ref = jattn.attention(*(jnp.asarray(x) for x in (q, k, v)))
    got = pattn.attention(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    assert pattn.attention_route(sq, sk, d, torch.float32, False) == route
    assert interpret["T2"] + interpret["T4"] == (route in ("flash", "packed"))


def test_attention_bhsd_matches_jax(interpret, overrides):
    """The bhsd layout's routes: "flash" runs T2 on both sides."""
    q, k, v = (rand((2, 2, 256, 64), 20 + i) for i in range(3))
    for backend, kernel in (("xla", 0), ("flash", 1)):
        ref = jattn.attention_bhsd(*(jnp.asarray(x) for x in (q, k, v)), backend=backend)
        got = pattn.attention_bhsd(t(q), t(k), t(v), backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
        assert interpret["T2"] == kernel


def test_route_kernel_names_the_launches():
    assert pattn.route_kernel("xla", 64) is None
    assert [pattn.route_kernel(r, 64) for r in ("flash", "flash_jax", "packed")] == [
        "flash_attn_fwd"] * 3
    assert [pattn.route_kernel("packed", d) for d in (80, 128, 512)] == [
        "flash_attn_fwd_wide"] * 3
    assert pattn.flash_blocks(torch.bfloat16, 4096, 1) == (512, 128)
    assert pattn.flash_blocks(torch.float32, 1024, 1024) == (256, 512)
    with pytest.raises(ValueError):
        pattn.set_default_backend("sdpa")


def test_c4_packed_untiled_sequence_is_reference_side(interpret):
    """C4: the JAX channel-packed kernel on CLIP's 257 tokens with 128-row
    blocks (what ``attention()`` picks under "packed") tiles only 256 rows and
    keys: row 256 comes back non-finite and the others miss key 256.  The
    port's ``flash_attention_packed`` equals ``xla_attention`` there."""
    b, s, h, d = 1, 257, 2, 80
    q, k, v = _qkv(b, s, s, h, d, 30)
    ref = np.asarray(jfa._xla_reference_bshd(*(jnp.asarray(x) for x in (q, k, v))))
    bad = np.asarray(jfa._flash_packed_forward(
        *(jnp.asarray(x.reshape(b, s, h * d)) for x in (q, k, v)), h, 128, 128)
    ).reshape(b, s, h, d)
    assert not np.isfinite(bad[:, 256]).all()
    assert np.abs(bad[:, :256] - ref[:, :256]).max() > 1e-2
    # without key 256 the JAX kernel computes softmax over keys 0..255
    trunc = np.asarray(jfa._xla_reference_bshd(
        jnp.asarray(q[:, :256]), jnp.asarray(k[:, :256]), jnp.asarray(v[:, :256])))
    np.testing.assert_allclose(bad[:, :256], trunc, **FWD)
    got = pfa.flash_attention_packed(t(q), t(k), t(v), 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.xla_attention(
        *(jnp.asarray(x) for x in (q, k, v)))), **FWD)
    np.testing.assert_allclose(got.numpy(), ref, **FWD)


# -- the batched temporal APIs (T5, T6) -----------------------------------------


def test_temporal_batched_apis_match_t5_t6():
    """T5 and T6 (interpret mode off the TPU, as the JAX package runs them
    there) and the XLA packed formula, at tests/test_temporal_attention.py's
    (30, 18, 3, 16)."""
    q, k, v = (rand((30, 18, 3, 16), 40 + i) for i in range(3))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for jfn, pfn in ((jta.temporal_attention, pta.temporal_attention),
                     (jta.temporal_attention_mxu, pta.temporal_attention_mxu),
                     (jta.temporal_attention_packed, pta.temporal_attention_packed)):
        ref = np.asarray(jfn(jq, jk, jv))
        got = pfn(t(q), t(k), t(v))
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_temporal_batched_takes_strided_heads():
    """A (B, t, h, d) view whose (h, d) are not contiguous gets one copy
    before K3's (B, t, 1, h*d) view; the result is the same."""
    base = t(rand((6, 18, 16, 3), 50))
    q = base.transpose(2, 3)  # (6, 18, 3, 16), strided heads
    k, v = (t(rand((6, 18, 3, 16), 51 + i)) for i in range(2))
    got = pta.temporal_attention(q, k, v)
    want = pta.temporal_attention(q.contiguous(), k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.xla_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))), atol=1e-4)
