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
  (bf16 rounding of q/k/v, P and o);
- the 3DGS compositor (T10 / T11, float32), the bounds chip_smoke.py
  states: rgb and acc max abs <= 1e-4, depth <= 1e-3 (a pair whose
  transmittance sits at the 1e-4 stop may count on one side only); the slab
  gradient per attribute max abs <= 1e-3 x max |plain| of that attribute
  (T11 divides T back and sums with atomics, in another order).
"""

import dataclasses
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
