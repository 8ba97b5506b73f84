"""The port's mesh extraction and mesh files (v3d_tpu_torch/meshops,
v3d_tpu_torch/native) against the JAX package's, on the CPU.

- marching tets: the port's numpy version equals the JAX package's numpy
  version exactly; the C++ core (built into build/native by the port's
  loader) gives the same triangles, each vertex within 1e-5 (float32
  interpolation against the numpy version's float64), welded on edges;
- ``isosurface`` with ``grid_fn`` equals it with ``sdf_fn``;
- OBJ, PLY and GLB files byte for byte those of the JAX package's ``Mesh``;
- a failed build of the C++ core raises.
"""

import numpy as np
import pytest

from v3d_tpu.meshops import mcubes as jmc
from v3d_tpu.meshops.mesh import Mesh as JMesh
from v3d_tpu_torch import native
from v3d_tpu_torch.meshops import mcubes
from v3d_tpu_torch.meshops.mesh import Mesh


def _grid_sdf(n, fn):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    return fn(g.reshape(-1, 3)).reshape(n, n, n).astype(np.float32)


def _sphere(p):
    return np.linalg.norm(p, axis=-1) - 0.6


def _blob(p):   # a sphere with a box carved out: concave, several patterns
    box = np.max(np.abs(p - np.array([0.4, 0.1, 0.0])) - 0.3, axis=-1)
    return np.maximum(_sphere(p), -box)


def _triangles(v, f):
    """Each face as its three vertices (F, 9), rotated to start at its
    least one (orientation kept)."""
    tri = v[f].astype(np.float64)                                # (F, 3, 3)
    first = np.lexsort(np.round(tri, 4).transpose(2, 0, 1)[::-1], axis=-1)[:, 0]
    idx = (first[:, None] + np.arange(3)) % 3
    return np.take_along_axis(tri, idx[..., None], 1).reshape(-1, 9)


def assert_same_triangles(a, b, atol=1e-5):
    """Each triangle of ``a`` has one of ``b`` within ``atol`` (per
    coordinate), one to one."""
    from scipy.spatial import cKDTree

    ta, tb = _triangles(*a), _triangles(*b)
    assert ta.shape == tb.shape
    dist, j = cKDTree(tb).query(ta, p=np.inf)
    assert dist.max() <= atol, dist.max()
    assert len(np.unique(j)) == len(j)


@pytest.mark.parametrize("shape", ["sphere", "blob"])
def test_marching_tets_native_numpy_and_jax(shape):
    sdf = _grid_sdf(24, {"sphere": _sphere, "blob": _blob}[shape])
    sp = 2.0 / 23
    v_np, f_np = mcubes.marching_tets(sdf, spacing=sp, use_native=False)
    v_j, f_j = jmc.marching_tets(sdf, spacing=sp, use_native=False)
    np.testing.assert_array_equal(v_np, v_j)
    np.testing.assert_array_equal(f_np, f_j)
    v_cc, f_cc = mcubes.marching_tets(sdf, spacing=sp)
    assert len(v_cc) == len(v_np) and len(f_cc) == len(f_np)
    assert_same_triangles((v_cc, f_cc), (v_np, f_np))
    # welded: every edge of the closed surface is shared by two faces
    e = np.sort(np.concatenate([f_cc[:, [0, 1]], f_cc[:, [1, 2]], f_cc[:, [2, 0]]]), 1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert np.all(counts == 2)
    if shape == "sphere":
        r = np.linalg.norm(v_cc, axis=1)
        assert abs(r.mean() - 0.6) < 0.01 and r.std() < 0.01


def test_isosurface_grid_fn_matches_sdf_fn():
    def grid_fn(lo, hi, *, resolution):
        axes = [np.linspace(lo[i], hi[i], resolution, dtype=np.float32) for i in range(3)]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
        return _blob(g.reshape(-1, 3)).reshape((resolution,) * 3)

    v1, f1 = mcubes.isosurface(_blob, radius=1.0, resolution=24, coarse_resolution=12)
    v2, f2 = mcubes.isosurface(None, radius=1.0, resolution=24, coarse_resolution=12,
                               grid_fn=grid_fn)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(f1, f2)
    v3, f3 = jmc.isosurface(_blob, radius=1.0, resolution=24, coarse_resolution=12)
    assert_same_triangles((v1, f1), (v3, f3))
    empty = mcubes.isosurface(lambda p: np.ones(len(p)), radius=1.0, resolution=8,
                              coarse_resolution=8)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


@pytest.mark.parametrize("colours", [False, True])
def test_mesh_files_match_jax_bytes(tmp_path, colours):
    v, f = mcubes.isosurface(_sphere, radius=1.0, resolution=16, coarse_resolution=8)
    c = np.random.RandomState(0).rand(len(v), 3).astype(np.float32) if colours else None
    port, ref = Mesh(v, f, vertex_colors=c).auto_normal(), JMesh(v, f, vertex_colors=c).auto_normal()
    np.testing.assert_array_equal(port.vertex_normals, ref.vertex_normals)
    for ext in ("obj", "ply", "glb"):
        getattr(port, f"write_{ext}")(str(tmp_path / f"port.{ext}"))
        getattr(ref, f"write_{ext}")(str(tmp_path / f"jax.{ext}"))
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes(), ext
    back = Mesh.read_obj(str(tmp_path / "port.obj"))
    np.testing.assert_allclose(back.vertices, v, rtol=1e-6)
    np.testing.assert_array_equal(back.faces, f)
    if colours:
        np.testing.assert_allclose(back.vertex_colors, c, rtol=1e-6)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
