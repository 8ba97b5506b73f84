"""K6's plain version and its autograd backward against the JAX package's
GroupNorm (v3d_tpu/ops/fused_groupnorm.py: the Pallas kernel T9 in
interpret mode, its plain reference ``_reference`` and ``jax.vjp`` of
``group_norm_act``), and the wrapper's kernel-path validation, on the CPU.

Tolerances: float32 rtol/atol 2e-5 (the Pallas kernel folds mean and scale
into y = x a + b, the plain version computes (x - mean) inv scale + bias;
the two differ by f32 rounding, ~1e-6 at |y| ~ 3); bfloat16 outputs within
one bf16 step (rtol/atol 2^-7): both sides compute in f32 from the same bf16
input and round once, so a value near a rounding boundary may land on
either neighbour; gradients (f32) rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import numpy_init_, rand, t, to_flax
from v3d_tpu.models import layers as JL
from v3d_tpu.ops.fused_groupnorm import _pallas_group_norm, _reference, group_norm_act
from v3d_tpu_torch.models import layers as PL
from v3d_tpu_torch.ops import LAUNCHES, _dispatch, reset_launch_counts
from v3d_tpu_torch.ops import group_norm as gn

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# channels-last (B, *spatial, C) numpy shapes: an NHWC map and an NTHWC video
SHAPES = {"4d": (2, 8, 6, 64), "5d": (2, 3, 4, 4, 96)}


def _port(x: np.ndarray, dtype) -> torch.Tensor:
    """(B, *spatial, C) numpy -> (B, C, *spatial) in channels-last memory."""
    xt = t(x).to(dtype)
    return xt.permute(0, xt.dim() - 1, *range(1, xt.dim() - 1))


def _back(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, *range(2, y.dim()), 1).float().detach().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind", ["4d", "5d"])
def test_plain_matches_pallas_interpret_and_reference(kind, silu, dtype):
    shape = SHAPES[kind]
    c = shape[-1]
    x = rand(shape, 1, 2.0) + 0.7
    scale, bias = 1 + rand((c,), 2, 0.1), rand((c,), 3, 0.1)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    xj = jnp.asarray(x).astype(jdt)
    x3 = xj.reshape(shape[0], -1, c)
    kern = _pallas_group_norm(x3, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5,
                              silu, True).reshape(shape)
    ref = _reference(xj, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, silu)
    got = gn.group_norm_act_plain(_port(x, tdt), t(scale), t(bias), 32, 1e-5, silu)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (kern, ref):
        np.testing.assert_allclose(_back(got), np.asarray(want.astype(jnp.float32)),
                                   **tol)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind", ["4d", "5d"])
def test_backward_matches_jax_vjp(kind, silu):
    """group_norm_act's autograd (plain recompute, ``_gn_bwd``) against
    jax.vjp of the JAX package's group_norm_act, same cotangent."""
    shape = SHAPES[kind]
    c = shape[-1]
    x = rand(shape, 4, 1.5) - 0.2
    scale, bias = 1 + rand((c,), 5, 0.1), rand((c,), 6, 0.1)
    g = rand(shape, 7)
    _, vjp = jax.vjp(lambda a, s, b: group_norm_act(a, s, b, 32, 1e-6, silu),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    xs = _port(x, torch.float32).detach().requires_grad_()
    ss, bs = t(scale).requires_grad_(), t(bias).requires_grad_()
    y = gn.group_norm_act(xs, ss, bs, 32, 1e-6, silu)
    y.backward(_port(g, torch.float32))
    np.testing.assert_allclose(_back(xs.grad), np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(ss.grad.numpy(), np.asarray(want[1]), **GRAD_TOL)
    np.testing.assert_allclose(bs.grad.numpy(), np.asarray(want[2]), **GRAD_TOL)


def test_groupnorm32_fused_silu_matches_norm_then_silu():
    """GroupNorm32(act="silu") equals the JAX package's GroupNorm32 followed
    by nn.silu, the pair it replaces in the ResBlocks, UNet out and VAE."""
    x = rand((2, 5, 7, 64), 8, 2.0)
    port = numpy_init_(PL.GroupNorm32(64, act="silu"), 9)
    params = to_flax(port, lambda k: (("GroupNorm_0", {"weight": "scale", "bias": "bias"}[k]),
                                      lambda v: v.detach().numpy()))
    ref = jax.nn.silu(JL.GroupNorm32().apply(params, jnp.asarray(x)))
    got = port(_port(x, torch.float32))
    np.testing.assert_allclose(_back(got), np.asarray(ref), **F32_TOL)


def test_resblock_keeps_its_state_dict_keys():
    """The fused SiLU leaves an Identity at its index: the checkpoint's
    in_layers.{0,2} / out_layers.{0,3} names are unchanged."""
    keys = set(PL.ResBlock(32, 16, 64).state_dict())
    assert {"in_layers.0.weight", "in_layers.2.weight", "out_layers.0.bias",
            "out_layers.3.weight", "emb_layers.1.weight"} <= keys
    assert not any(k.startswith(("in_layers.1", "out_layers.1")) for k in keys)


@pytest.fixture
def kernel_path(monkeypatch):
    """Drive the wrapper's CUDA branch on CPU tensors with a launch that
    records its arguments."""
    calls = []

    def fake_launch(name, fn_name, device, *args):
        calls.append((fn_name, args))
        _dispatch.LAUNCHES[name] += 1

    monkeypatch.setattr(gn, "use_plain", lambda *a: False)
    monkeypatch.setattr(gn, "launch", fake_launch)
    reset_launch_counts()
    return calls


def test_wrapper_validates_and_counts(kernel_path):
    x = torch.randn(3, 64, 5, 7).contiguous(memory_format=torch.channels_last)
    w = torch.ones(64)
    y = gn.group_norm_fwd(x, w, w, 32, 1e-5, True)
    assert y.shape == x.shape and y.is_contiguous(memory_format=torch.channels_last)
    fn, args = kernel_path[0]
    assert fn == "v3d_group_norm" and args[0] == 0 and args[5] == 0
    B, L, C, G = args[7:11]
    assert (B, L, C, G) == (3, 35, 64, 32) and args[11:13] == (1e-5, 1)
    plan = gn.group_norm_plan(B, L, C, G, torch.float32)
    assert args[13:17] == (plan["gpc"], plan["cluster"], plan["rows_per_block"],
                           plan["splits"]) and args[17] is None
    v = torch.randn(2, 32, 18, 4, 4).contiguous(memory_format=torch.channels_last_3d)
    gn.group_norm_fwd(v.bfloat16(), torch.ones(32).bfloat16(), torch.ones(32).bfloat16())
    assert kernel_path[1][1][7:10] == (2, 18 * 16, 32) and kernel_path[1][1][5] == 1
    assert LAUNCHES["group_norm"] == 2
    for bad, match in ((torch.randn(2, 64, 4, 4), "channels-last"),          # NCHW
                       (torch.randn(2, 48, 4, 4).contiguous(
                           memory_format=torch.channels_last), "multiple"),  # 48 % 32
                       (x.half(), "float32 or bfloat16")):
        with pytest.raises((ValueError, TypeError), match=match):
            gn.group_norm_fwd(bad, torch.ones(bad.shape[1]), torch.ones(bad.shape[1]))
    assert LAUNCHES["group_norm"] == 2

