"""Tile-sharded 3DGS rasterization: the port's ``rasterize_sharded`` on 2 and
3 ranks spawned on the CPU over gloo (tests/torch_dist_helpers.py; 3 ranks
pad the 16 tiles of a 64^2 image to 18) against the JAX package's
``rasterize_sharded`` over conftest's 8 CPU devices, on
test_gs_sharded.py's scene (512 points, coarse cells of 2x2 tiles, Kc 256,
forced coarse).

Tolerances are test_gs_sharded.py's for JAX's own sharded render against
its single-device one: image and alpha atol 2e-5 (depth 2e-4, as
test_torch_gs_render.py), the mean absolute error loss 1e-6, the xyz /
opacity / scaling gradients atol 1e-5.  Every rank holds the whole render
and the whole gradient (the slab's cotangent is summed over the ranks), so
every rank is held; the plain compositor runs on the CPU, no kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_gs_sharded import _setup
from torch_dist_helpers import gs_sharded, run_ranks
from v3d_tpu.gs.gaussians import GaussianParams
from v3d_tpu.gs.render import project_gaussians, rasterize_sharded
from v3d_tpu.parallel.mesh import DATA_AXIS, make_mesh
from v3d_tpu_torch.core.convert import gaussians_from_jax
from v3d_tpu_torch.data import cameras

FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
PORT_CFG = dict(max_per_tile=64, tile_chunk=4, coarse_factor=2, max_per_coarse=256,
                force_coarse=True)


@pytest.fixture(scope="module")
def jax_ref():
    fp, cam, cfg = _setup()
    mesh = make_mesh(model=1)
    with mesh:
        out = jax.jit(lambda p: rasterize_sharded(
            p, cam.height, cam.width, jnp.ones(3), mesh, DATA_AXIS, cfg))(
                project_gaussians(fp, cam))
    target = np.random.RandomState(1).rand(cam.height, cam.width, 3).astype(np.float32)

    def loss(fd):
        g = GaussianParams(alive=fp.alive, **fd)
        o = rasterize_sharded(project_gaussians(g, cam), cam.height, cam.width,
                              jnp.zeros(3), mesh, DATA_AXIS, cfg)
        return jnp.mean(jnp.abs(o.image - jnp.asarray(target)))

    with mesh:
        value, grads = jax.jit(jax.value_and_grad(loss))({k: getattr(fp, k) for k in FIELDS})
    return dict(fp=fp, out=out, target=target, loss=float(value),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, jax_ref, tmp_path_factory):
    pose = cameras.get_uniform_poses(4, 2.0, 15.0, opengl=False)[1]
    cam = cameras.Camera.from_c2w(pose, 60.0, 64, 64)
    return run_ranks(gs_sharded, request.param, tmp_path_factory.mktemp("gs"),
                     gaussians_from_jax(jax_ref["fp"]), cam, PORT_CFG,
                     torch.from_numpy(jax_ref["target"]))


def test_sharded_render_matches_jax(ranks, jax_ref):
    out = jax_ref["out"]
    for r in ranks:
        assert r["foreign"] == []
        np.testing.assert_allclose(r["image"].numpy(), np.asarray(out.image), atol=2e-5)
        np.testing.assert_allclose(r["alpha"].numpy(), np.asarray(out.alpha), atol=2e-5)
        np.testing.assert_allclose(r["depth"].numpy(), np.asarray(out.depth), atol=2e-4)


def test_sharded_grads_match_jax(ranks, jax_ref):
    for r in ranks:
        assert abs(r["loss"] - jax_ref["loss"]) < 1e-6
        for k in ("xyz", "opacity", "scaling"):
            np.testing.assert_allclose(r["grads"][k].numpy(), jax_ref["grads"][k],
                                       atol=1e-5, err_msg=f"grad mismatch on {k}")
        for k in FIELDS:            # every rank holds the whole gradient
            assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
