"""The hand-written kernels against their plain versions on a CUDA device.

Marked ``gpu``; each test skips without a card.  On the card (no JAX there,
so without the repository's conftest):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -o addopts= -q

Ragged, strided and narrow shapes that the main path does not reach
(chip_smoke.py phase 3 covers the main path's shapes), in both dtypes, so
that the f32 FMA variants and the bf16 tensor-core variants, and the 16-byte
and the scalar load paths of the latter, each run.  Tolerances:

- float32: max |kernel - plain| <= 1e-4 * max |plain| (f32 sums in another
  order than cuBLAS);
- bfloat16: PSNR >= 40 dB of the bf16 kernel against the plain version in
  float32 on the same (bf16-rounded) inputs, the bound chip_smoke.py states
  (bf16 rounding of q/k/v, P and o).
"""

import math

import pytest
import torch

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


def test_kernels_refuse_instead_of_falling_back(dev):
    from v3d_tpu_torch.ops import reference_mode
    from v3d_tpu_torch.ops.attention import flash_attn_fwd

    q = torch.randn(1, 1, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attn_fwd(q, q, q)
    with reference_mode():  # the explicit switch is the only way to plain
        assert flash_attn_fwd(q, q, q).shape == q.shape
