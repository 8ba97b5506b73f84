"""The port's plain tile compositor (v3d_tpu_torch/ops/gs_composite.py
``composite_plain``, the CPU path and the oracle of kernels T10/T11) against
the JAX package's Pallas kernels ``composite_tiles_fwd`` /
``composite_tiles_bwd`` in interpret mode, on the same slab (the JAX side
takes it attribute-major, as render.py's custom VJP hands it over).

Tolerances, those of tests/test_pallas_raster.py between the same two
formulations inside the JAX package: rgb and acc atol 2e-5, depth atol 2e-4
(float32 sums in another order); the slab gradient rtol 2e-5, atol 2e-6.
As there, the saturated case (opacity logit 6, alpha at the 0.99 clamp) is
checked forward only: its gradient divides by 1 - alpha = 0.01, and the JAX
package's own XLA and Pallas gradients differ there by 6e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v3d_tpu.data.cameras import Camera, get_uniform_poses
from v3d_tpu.gs.gaussians import from_pcd, random_init_pcd
from v3d_tpu.gs.pallas_raster import ATTR, D, composite_tiles_bwd, composite_tiles_fwd
from v3d_tpu.gs.render import RasterizeConfig, _build_slabs, project_gaussians
from v3d_tpu_torch.ops import gs_composite

torch.set_num_threads(1)

# name -> (points, opacity logit or None, RasterizeConfig fields)
CASES = {
    "coarse": (600, None, dict(coarse_factor=2, max_per_coarse=256)),
    "global_sort": (200, None, dict(coarse_factor=2, max_per_coarse=512)),
    "early_exit": (600, 6.0, dict(coarse_factor=2, max_per_coarse=256,
                                  force_coarse=True)),
}


def _slab_case(name, res=64, seed=0):
    n, opacity, cfg = CASES[name]
    rng = np.random.RandomState(seed)
    xyz, colors = random_init_pcd(rng, n, radius=2.0)
    g = from_pcd(xyz, colors, sh_degree=0, capacity=n + 40)
    if opacity is not None:
        g = g._replace(opacity=jnp.full_like(g.opacity, opacity))
    cam = Camera.from_c2w(get_uniform_poses(4, 2.0, 15.0)[1], 60.0, res, res)
    slab, live, cell, xy, _ = _build_slabs(project_gaussians(g, cam), res, res,
                                           RasterizeConfig(**cfg))
    return np.asarray(slab), np.asarray(live), cell, xy


def _attr_major(slab):
    n_cells, kq, _ = slab.shape
    pad = np.zeros((n_cells, (-kq) % D, 10), np.float32)
    padded = np.concatenate([slab, pad], axis=1)
    padded = np.concatenate([padded, np.zeros(padded.shape[:2] + (ATTR - 10,),
                                              np.float32)], axis=2)
    return jnp.asarray(padded.transpose(0, 2, 1))        # (cells, ATTR, K)


def _port_inputs(slab, live, cell, xy):
    return (torch.from_numpy(slab.copy()), torch.from_numpy(live.astype(np.int32)),
            torch.from_numpy(cell.astype(np.int32)),
            torch.from_numpy(xy.astype(np.int32)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_pallas_kernel(name):
    slab, live, cell, xy = _slab_case(name)
    out, _ = composite_tiles_fwd(_attr_major(slab), cell, xy,
                                 live_count=jnp.asarray(live), interpret=True)
    out = np.asarray(out)
    rgb, acc, dep = gs_composite.composite_plain(
        *_port_inputs(slab, live, cell, xy), depth_chunk=128, tile_chunk=5)
    np.testing.assert_allclose(rgb.numpy(), out[:, 0:3].transpose(0, 2, 1), atol=2e-5)
    np.testing.assert_allclose(acc.numpy(), out[:, 3], atol=2e-5)
    np.testing.assert_allclose(dep.numpy(), out[:, 4], atol=2e-4)
    assert acc.max() > 0.5  # the case composites something


@pytest.mark.parametrize("name", ["coarse", "global_sort"])
def test_plain_gradient_matches_pallas_kernel(name):
    slab, live, cell, xy = _slab_case(name)
    am = _attr_major(slab)
    out, ts = composite_tiles_fwd(am, cell, xy, live_count=jnp.asarray(live),
                                  interpret=True)
    k_stop = out[:, 6, 0].astype(jnp.int32)
    n_tiles = cell.shape[0]
    rng = np.random.RandomState(1)
    g5 = rng.randn(n_tiles, 5, gs_composite.P).astype(np.float32)
    g8 = np.concatenate([g5, np.zeros((n_tiles, 3, gs_composite.P), np.float32)], 1)
    d_am = composite_tiles_bwd(am, jnp.asarray(g8), ts, k_stop, cell, xy,
                               interpret=True)
    want = np.asarray(d_am)[:, :10, :slab.shape[1]].transpose(0, 2, 1)

    s, lc, ct, txy = _port_inputs(slab, live, cell, xy)
    s.requires_grad_(True)
    outs = gs_composite.composite_plain(s, lc, ct, txy, depth_chunk=128,
                                        tile_chunk=5)
    cot = (torch.from_numpy(g5[:, 0:3].transpose(0, 2, 1).copy()),
           torch.from_numpy(g5[:, 3].copy()), torch.from_numpy(g5[:, 4].copy()))
    (got,) = torch.autograd.grad(outs, s, cot)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    assert np.abs(want).max() > 0


def test_dispatch_takes_plain_on_cpu_and_counts_nothing():
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    slab, live, cell, xy = _slab_case("coarse")
    reset_launch_counts()
    outs = gs_composite.composite(*_port_inputs(slab, live, cell, xy))
    ref = gs_composite.composite_plain(*_port_inputs(slab, live, cell, xy))
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert LAUNCHES["gs_composite_fwd"] == LAUNCHES["gs_composite_bwd"] == 0


def test_tile_pixels_layout():
    xy = torch.tensor([[0, 0], [32, 16]], dtype=torch.int32)
    pix = gs_composite.tile_pixels(xy)
    assert pix.shape == (2, 256, 2)
    # pixel p = 16 * y + x within the tile, as the Pallas kernel's iota
    assert pix[1, 0].tolist() == [32.0, 16.0]
    assert pix[1, 17].tolist() == [33.0, 17.0]
    assert pix[0, 255].tolist() == [15.0, 15.0]
