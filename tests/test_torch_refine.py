"""The port's texture refinement (v3d_tpu_torch/meshops/refine.py,
apps/refine.py) against the JAX package's, on the CPU, float32.

The JAX test's sphere (tests/test_meshops.py test_texture_refine_converges:
a 24^3 isosurface, 4 views at 32^2 painted green where the mesh covers
them, max_per_tile 512, tile_chunk 2) refined for 10 steps on both sides
from the same logits, with the same view draws: losses within rel 1e-5,
logits within max abs 1e-5.  At the shipped learning rate, 1e-3: the
sphere's axis-aligned views put a few pixel centres exactly on triangle
edges, where XLA's fused multiply-adds and PyTorch's separate roundings
may hand the pixel to different triangles.  Adam turns such a vertex's
gradient difference into up to lr per step, so with the JAX test's lr 0.05
the logits of those vertices drift apart by up to 3e-4 after 10 steps
(the losses still agree to 2e-6), with lr 1e-3 by up to 2.2e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.meshops.mcubes import isosurface
from v3d_tpu.meshops.mesh import Mesh as JMesh
from v3d_tpu.meshops.refine import RefineConfig as JConfig
from v3d_tpu.meshops.refine import TextureRefiner as JRefiner
from v3d_tpu_torch.apps.refine import do_refine
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner

CFG = dict(iters=150, num_opt_views=4, max_per_tile=512, tile_chunk=2, radius=2.0,
           lr=1e-3)


@pytest.fixture(scope="module")
def sphere():
    verts, faces = isosurface(lambda p: np.linalg.norm(p, axis=-1) - 0.6,
                              radius=1.0, resolution=24, coarse_resolution=12)
    T, res = 4, 32
    r = JRefiner(JMesh(verts, faces), np.ones((T, res, res, 3), np.float32),
                 JConfig(**CFG))
    frames = np.ones((T, res, res, 3), np.float32)
    for i in range(T):
        _, m = jax.jit(r.render)(r.logits, i)
        frames[i][np.asarray(m) > 0.5] = [0.1, 0.8, 0.1]
    return verts, faces, frames


def test_refine_steps_match_jax(sphere):
    verts, faces, frames = sphere
    jr = JRefiner(JMesh(verts, faces), frames, JConfig(**CFG))
    pr = TextureRefiner(Mesh(verts, faces), frames, RefineConfig(**CFG), device="cpu")
    np.testing.assert_array_equal(pr.logits.detach().numpy(), np.asarray(jr.logits))
    jl, pl = jr.run(10), pr.run(10)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pr.logits.detach().numpy(), np.asarray(jr.logits),
                               rtol=0, atol=1e-5)
    got, want = pr.export(), jr.export()
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertex_colors, want.vertex_colors, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vertex_normals, want.vertex_normals, rtol=0, atol=1e-6)


def test_refine_lpips_term_matches_jax(sphere):
    """``lpips_fn`` adds ``lambda_lpips`` times its value when both are
    given (a stand-in perceptual term: mean |img - target|), as the JAX
    package adds it; 3 steps, losses within rel 1e-5."""
    verts, faces, frames = sphere
    cfg = dict(CFG, lambda_lpips=0.5)
    jr = JRefiner(JMesh(verts, faces), frames, JConfig(**cfg),
                  lpips_fn=lambda a, b: jnp.mean(jnp.abs(a - b)))
    pr = TextureRefiner(Mesh(verts, faces), frames, RefineConfig(**cfg), device="cpu",
                        lpips_fn=lambda a, b: torch.mean(torch.abs(a - b)))
    plain = TextureRefiner(Mesh(verts, faces), frames, RefineConfig(**CFG), device="cpu")
    jl, pl = jr.run(3), pr.run(3)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[0] > plain.run(1)[0]


def test_do_refine_writes_the_refined_mesh(sphere, tmp_path):
    verts, faces, frames = sphere
    mesh_path = tmp_path / "mesh.obj"
    Mesh(verts, faces).write_obj(str(mesh_path))
    np.save(tmp_path / "frames.npy", (frames * 255).astype(np.uint8))
    out = do_refine(str(mesh_path), str(tmp_path / "frames.npy"), str(tmp_path / "out"),
                    iters=3, num_opt_views=4, device="cpu")
    assert len(out.vertices) == len(verts)
    back = Mesh.read_obj(str(tmp_path / "out" / "refined.obj"))
    np.testing.assert_allclose(back.vertex_colors, out.vertex_colors, atol=1e-6)
    assert (tmp_path / "out" / "refined.glb").stat().st_size > 0
    spiral = np.load(tmp_path / "out" / "refined_spiral.npy")
    assert spiral.shape == frames.shape and spiral.dtype == np.uint8
    with pytest.raises(NotImplementedError, match="LPIPS"):
        do_refine(str(mesh_path), str(tmp_path / "frames.npy"), str(tmp_path / "o2"),
                  iters=1, lambda_lpips=0.1, device="cpu")
