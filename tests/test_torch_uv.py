"""The port's UV atlas (v3d_tpu_torch/meshops/uv.py) and ``Mesh.auto_uv``
against the JAX package's, on the CPU: ``atlas_unwrap``'s vmapping, ft and
vt equal on a cube and on a 24^3 sphere isosurface, and the OBJ and GLB
files of the unwrapped meshes equal byte for byte (with vertex colours and
normals, with ``vmap`` and from the ``_uv.npz`` cache)."""

import numpy as np
import pytest

from v3d_tpu.meshops.mcubes import isosurface
from v3d_tpu.meshops.mesh import Mesh as JMesh
from v3d_tpu.meshops.uv import atlas_unwrap as j_unwrap
from v3d_tpu_torch.meshops.mesh import Mesh
from v3d_tpu_torch.meshops.uv import atlas_unwrap


def _cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float32) * 0.5
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                 np.int32)
    return v, f


def _sphere():
    return isosurface(lambda p: np.linalg.norm(p, axis=-1) - 0.6, radius=1.0,
                      resolution=24, coarse_resolution=12)


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_atlas_unwrap_equals_jax(shape):
    v, f = _cube() if shape == "cube" else _sphere()
    got, want = atlas_unwrap(v, f), j_unwrap(v, f)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    vmapping, ft, vt = got
    assert len(vmapping) >= len(v) and ft.max() < len(vt)
    assert vt.min() >= 0 and vt.max() <= 1


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_auto_uv_files_equal_jax_bytes(shape, tmp_path):
    v, f = _cube() if shape == "cube" else _sphere()
    colors = np.random.RandomState(0).rand(len(v), 3).astype(np.float32)
    port = Mesh(v, f, vertex_colors=colors).auto_normal().auto_uv()
    ref = JMesh(v, f, vertex_colors=colors).auto_normal().auto_uv()
    for ext in ("obj", "glb"):
        getattr(port, f"write_{ext}")(str(tmp_path / f"p.{ext}"))
        getattr(ref, f"write_{ext}")(str(tmp_path / f"j.{ext}"))
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    # the cache: a second unwrap reads <path>_uv.npz and gives the same mesh
    cache = str(tmp_path / "mesh.obj")
    first = Mesh(v, f).auto_uv(cache_path=cache)
    assert (tmp_path / "mesh_uv.npz").exists()
    again = Mesh(v, f).auto_uv(cache_path=cache)
    np.testing.assert_array_equal(first.uvs, again.uvs)
    np.testing.assert_array_equal(first.faces, again.faces)
    # without vmap the vertices stay and the uvs carry their own faces
    flat = Mesh(v, f).auto_uv(vmap=False)
    np.testing.assert_array_equal(flat.vertices, v)
    np.testing.assert_array_equal(flat._ft, ref.faces)
