"""The port's mesh rasterizer (v3d_tpu_torch/meshops/rasterize.py) against
the JAX package's, on the CPU, float32.

- The candidate lists: ``tile_candidates`` (binned (face, tile) pairs, two
  stable sorts) equals ``jax.lax.top_k`` of the JAX package's scores over
  every face, on the same bboxes and zmin: random faces, equal zmin
  straddling the K-th place, bboxes that end exactly on a tile edge or
  reach off screen, faces behind the camera.  Exactly: the same ids in the
  same order where top_k's score is finite, the same count per tile.
- The rasterizer at 32x32 and 48x40 (partial tiles) with max_per_tile 4 on
  a scene with those cases: ``mask`` equal; ``attr``, ``depth``, ``bary``,
  ``alpha`` and the attributes' gradient within max abs 1e-5.  The scene's
  screen coordinates are dyadic (1/16 px), so every edge function and
  product is exact in float32 on both sides: XLA contracts a*b - c*d into
  fused multiply-adds and PyTorch does not, and on a pixel that lies on an
  edge the two roundings may pick different triangles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.meshops import rasterize as J
from v3d_tpu_torch.meshops import rasterize as P

TOL = 1e-5


def _scene(W, H, seed=0):
    """Clip-space vertices (w = 1, x/y on a 1/256 grid of the NDC square,
    i.e. dyadic pixels) and faces: 40 random triangles, 6 faces of equal
    zmin over one tile, a face whose bbox ends on
    x = 16 and one that starts on x = 32 (tile edges), one reaching off
    screen, one with a vertex behind the camera (w < 0)."""
    rs = np.random.RandomState(seed)

    def vert(sx, sy, z, w=1.0):
        u, v = (sx + 0.5) / W, (sy + 0.5) / H
        return [(2 * u - 1) * w, (1 - 2 * v) * w, z * w, w]

    def snap(s, n):   # a screen coordinate on the 1/256 NDC grid
        return np.round((s + 0.5) / n * 256) / 256 * n - 0.5

    verts, faces = [], []
    for _ in range(40):
        c = rs.uniform(-4, [W + 4, H + 4])
        i = len(verts)
        for _ in range(3):
            p = c + rs.uniform(-9, 9, 2)
            verts.append(vert(snap(p[0], W), snap(p[1], H), rs.uniform(0.2, 0.9)))
        faces.append([i, i + 1, i + 2] if rs.rand() < 0.5 else [i, i + 2, i + 1])
    # six faces of equal zmin (their nearest vertices at one depth) over one
    # tile, ids interleaved with the others; separate vertices, so that no
    # pixel lies on an edge two of them share
    for k, a in enumerate(np.linspace(0, 2 * np.pi, 7)[:-1]):
        i = len(verts)
        p = [(20.3 + 2 * np.cos(a), 9.7 + 2 * np.sin(a)),
             (20.3 + 9 * np.cos(a + 0.4), 9.7 + 9 * np.sin(a + 0.4)),
             (20.3 + 9 * np.cos(a - 0.5), 9.7 + 9 * np.sin(a - 0.5))]
        verts += [vert(snap(x, W), snap(y, H), z)
                  for (x, y), z in zip(p, (0.1, *rs.uniform(0.3, 0.8, 2)))]
        faces.insert(3 * k + 1, [i, i + 1, i + 2])
    # bboxes ending exactly on tile edges (x = 16, x = 32, y = 16)
    for xs, ys in (((4.0, 16.0, 10.0), (3.0, 5.0, 14.0)),
                   ((32.0, 40.0, 36.0), (20.0, 22.0, 30.0)),
                   ((6.0, 12.0, 9.0), (16.0, 16.0, 26.0))):
        i = len(verts)
        verts += [vert(x, y, rs.uniform(0.2, 0.9)) for x, y in zip(xs, ys)]
        faces.append([i, i + 1, i + 2])
    # off screen on two sides, and one vertex behind the camera
    i = len(verts)
    verts += [vert(-20.0, -10.0, 0.5), vert(W + 10.0, 4.0, 0.6), vert(8.0, H + 12.0, 0.7)]
    faces.append([i, i + 1, i + 2])
    i = len(verts)
    verts += [vert(10.0, 10.0, 0.4), vert(14.0, 20.0, 0.4), vert(5.0, 5.0, 0.5, w=-1.0)]
    faces.append([i, i + 1, i + 2])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _jax_candidates(xmin, xmax, ymin, ymax, zmin, f_ok, W, H, K):
    """rasterize.py:73-93: per tile top_k(-score) over every face."""
    n_tx, n_ty = -(-W // 16), -(-H // 16)
    ids = jnp.arange(n_tx * n_ty)
    tx = (ids % n_tx).astype(jnp.float32)[:, None] * 16
    ty = (ids // n_tx).astype(jnp.float32)[:, None] * 16
    overlap = ((xmax[None] >= tx) & (xmin[None] <= tx + 16)
               & (ymax[None] >= ty) & (ymin[None] <= ty + 16))
    score = jnp.where(overlap, jnp.where(f_ok, zmin, jnp.inf)[None], jnp.inf)
    neg, idx = jax.lax.top_k(-score, K)
    return np.asarray(idx), np.asarray(jnp.isfinite(neg))


@pytest.mark.parametrize("W,H,K", [(32, 32, 4), (48, 40, 4), (40, 56, 7), (64, 48, 300)])
def test_candidates_equal_lax_top_k(W, H, K):
    rs = np.random.RandomState(W + H + K)
    F = 400
    c = rs.uniform(-10, [W + 10, H + 10], (F, 2)).astype(np.float32)
    half = rs.uniform(0, 12, (F, 2)).astype(np.float32)
    xmin, xmax = c[:, 0] - half[:, 0], c[:, 0] + half[:, 0]
    ymin, ymax = c[:, 1] - half[:, 1], c[:, 1] + half[:, 1]
    # bboxes ending exactly on tile edges, and far off screen
    xmax[:40] = 16.0 * rs.randint(0, W // 16 + 1, 40)
    xmin[40:80] = 16.0 * rs.randint(0, W // 16 + 1, 40)
    ymax[80:100] = 16.0 * rs.randint(0, H // 16 + 1, 20)
    xmin[100:105], xmax[100:105] = -1e6, 1e6
    ymin[105:110] = 1e5
    # zmin: ties in groups (shared nearest vertices), one at -0.0 / 0.0 avoided
    zmin = rs.uniform(0.1, 1.0, F).astype(np.float32)
    zmin[rs.randint(0, F, 150)] = zmin[rs.randint(0, 12, 150)]
    f_ok = rs.rand(F) > 0.1
    idx, ok = _jax_candidates(*(jnp.asarray(a) for a in (xmin, xmax, ymin, ymax,
                                                         zmin, f_ok)), W, H, K)
    cand = P.tile_candidates(*(torch.tensor(a) for a in (xmin, xmax, ymin, ymax,
                                                         zmin, f_ok)),
                             -(-W // 16), -(-H // 16), K).numpy()
    np.testing.assert_array_equal(cand >= 0, ok)
    np.testing.assert_array_equal(np.where(ok, cand, -1), np.where(ok, idx, -1))
    # the cases happened: with a small K some tile's K-th candidate ties with
    # an overlapping face left out; with K = 300 every tile has fewer
    n_tx = -(-W // 16)
    tiles = np.arange(cand.shape[0])
    tx, ty = (tiles % n_tx)[:, None] * 16.0, (tiles // n_tx)[:, None] * 16.0
    meets = f_ok & (xmax >= tx) & (xmin <= tx + 16) & (ymax >= ty) & (ymin <= ty + 16)
    straddles = [t for t in tiles if ok[t].all() and any(
        zmin[f] == zmin[cand[t, -1]] for f in np.flatnonzero(meets[t])
        if f not in cand[t])]
    assert (len(straddles) > 0) if K < 300 else not ok.all(1).any()


@pytest.mark.parametrize("H,W", [(32, 32), (48, 40)])
def test_rasterizer_matches_jax(H, W):
    verts, faces = _scene(W, H)
    attrs = np.random.RandomState(1).rand(len(verts), 3).astype(np.float32)
    g_out = np.random.RandomState(2).randn(H, W, 3).astype(np.float32)
    jr = J.MeshRasterizer(H, W, max_per_tile=4, tile_chunk=2)
    pr = P.MeshRasterizer(H, W, max_per_tile=4, tile_chunk=2)

    def jloss(a):
        out = jr(jnp.asarray(verts), jnp.asarray(faces), a)
        return jnp.sum(out.attr * g_out), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(attrs))
    a = torch.tensor(attrs, requires_grad=True)
    pout = pr(torch.tensor(verts), torch.tensor(faces), a)
    (pout.attr * torch.tensor(g_out)).sum().backward()
    np.testing.assert_array_equal(pout.mask.numpy(), np.asarray(jout.mask))
    assert 0 < pout.mask.numpy().mean() < 1
    for name in ("attr", "depth", "bary", "alpha"):
        got, want = getattr(pout, name).detach().numpy(), np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), rtol=0, atol=TOL)
    # soft edge pixels exist (uncovered, alpha > 0) and took attributes
    soft = (~pout.mask.numpy()) & (pout.alpha.detach().numpy() > 0)
    assert soft.any() and np.abs(pout.attr.detach().numpy()[soft]).sum() > 0


def test_rasterizer_position_gradient_matches_jax():
    """alpha is differentiable w.r.t. the vertex positions (the antialiased
    silhouette): the gradient of sum(alpha * g) w.r.t. the clip-space
    vertices, within rtol 1e-4 / atol 1e-5."""
    H = W = 32
    verts, faces = _scene(W, H, seed=3)
    attrs = np.random.RandomState(1).rand(len(verts), 3).astype(np.float32)
    g_out = np.random.RandomState(4).randn(H, W).astype(np.float32)
    jr = J.MeshRasterizer(H, W, max_per_tile=4, tile_chunk=2)
    jg = jax.grad(lambda v: jnp.sum(jr(v, jnp.asarray(faces), jnp.asarray(attrs)).alpha
                                    * g_out))(jnp.asarray(verts))
    v = torch.tensor(verts, requires_grad=True)
    pr = P.MeshRasterizer(H, W, max_per_tile=4, tile_chunk=2)
    (pr(v, torch.tensor(faces), torch.tensor(attrs)).alpha * torch.tensor(g_out)).sum().backward()
    assert np.abs(np.asarray(jg)).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=TOL)


def test_projection_helpers_match_jax():
    P_np = P.perspective_from_fov(50.0, 1.25, 0.1, 10.0)
    np.testing.assert_array_equal(P_np, J.perspective_from_fov(50.0, 1.25, 0.1, 10.0))
    v = np.random.RandomState(0).randn(20, 3).astype(np.float32)
    np.testing.assert_allclose(
        P.verts_to_clip(torch.tensor(v), torch.tensor(P_np)).numpy(),
        np.asarray(J.verts_to_clip(jnp.asarray(v), jnp.asarray(P_np))), rtol=1e-6, atol=1e-6)
