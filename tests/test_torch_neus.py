"""The port's NeuS pieces (v3d_tpu_torch/nerf: encoding, fields, occupancy,
renderer, the losses, normals) against the JAX package's, on the CPU, in
float32, on the same parameters (carried by ``core.convert
.neus_group_state``) and the same random draws (taken from the JAX keys).

Tolerances: outputs rtol 1e-5 / atol 1e-6 (elementwise float32; sums of a
few terms in another order), except the central differences: they divide
the SDF's rounding (~2.4e-7, an ulp at |sdf| ~ 1) by 2 eps and by eps^2, so
the finite-difference gradient has atol 4e-7 / eps and the Laplacian
2e-6 / eps^2 (1.3e-5 and 2.2e-3 at eps = 0.03); gradients through the fields (first and
second order) rtol 1e-4 / atol 1e-6 (one to three backward passes of
small MLPs); the occupancy grid's binary mask and the chamfer distance
exactly; the blurred silhouette normals atol 1e-5 (OpenCV's blur sums its
taps in another order, ~2 ulps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.nerf import encoding as JE
from v3d_tpu.nerf import fields as JF
from v3d_tpu.nerf import normals as JN
from v3d_tpu.nerf import occupancy as JO
from v3d_tpu.nerf import renderer as JR
from v3d_tpu.nerf import system as JS
from v3d_tpu_torch.core.convert import neus_group_state
from v3d_tpu_torch.nerf import encoding as PE
from v3d_tpu_torch.nerf import fields as PF
from v3d_tpu_torch.nerf import normals as PN
from v3d_tpu_torch.nerf import occupancy as PO
from v3d_tpu_torch.nerf import renderer as PR
from v3d_tpu_torch.nerf import system as PS

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def load(module, jax_params):
    module.load_state_dict({k: torch.tensor(v)
                            for k, v in neus_group_state(jax_params).items()})
    return module


def points(n, seed, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


# hash grid: levels at 4 and 8 are dense ((res+1)^3 <= 2^12), 16 and 32 hashed
HG = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
          base_resolution=4, per_level_scale=2.0)


@pytest.mark.parametrize("masked", [False, True])
def test_hashgrid_dense_and_hashed(masked):
    jhg = JE.HashGrid(**HG)
    x = np.concatenate([points(64, 0), [[0, 0, 0], [1, 1, 1], [0.5, 1.0, 0.0]]])
    x = x.astype(np.float32)
    params = jhg.init(jax.random.PRNGKey(0), x)
    # a table of order 1, so that every level's rows matter
    table = np.random.RandomState(1).randn(*params["params"]["table"].shape)
    params = {"params": {"table": jnp.asarray(table, jnp.float32)}}
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32) if masked else None
    assert [r for r in jhg.resolutions()] == [4, 8, 16, 32]
    phg = load(PE.HashGrid(**HG), params)
    want = jhg.apply(params, x, None if mask is None else jnp.asarray(mask))
    got = phg(t(x), None if mask is None else t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the table's gradient: the same rows, the same weights
    w = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jhg.apply(p, x) * w))(params)
    (phg(t(x)) * t(w)).sum().backward()
    np.testing.assert_allclose(phg.table.grad.numpy(),
                               np.asarray(jg["params"]["table"]), **GTOL)


def test_frequency_encoding_and_schedules():
    je, pe = JE.VanillaFrequency(4, 100), PE.VanillaFrequency(4, 100)
    x = points(16, 3)
    for step in (0, 10, 37, 100, 200):
        np.testing.assert_array_equal(pe.mask(step), je.mask(step))
        np.testing.assert_allclose(
            pe(t(x), t(pe.mask(step))).numpy(),
            np.asarray(je(jnp.asarray(x), jnp.asarray(je.mask(step)))), **TOL)
    np.testing.assert_allclose(pe(t(x)).numpy(), np.asarray(je(jnp.asarray(x))), **TOL)
    for step in (0, 999, 2500, 10_000):
        args = (step, 10, 2, 4, 0, 1000)
        np.testing.assert_array_equal(PE.progressive_level_mask(*args),
                                      JE.progressive_level_mask(*args))
        args = (step, 1.0, 32, 1.3195, 4, 0, 1000, 10)
        assert PE.progressive_fd_eps(*args) == JE.progressive_fd_eps(*args)
    d = points(10, 4, -1, 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for degree in (1, 2, 3, 4):
        np.testing.assert_allclose(
            PE.spherical_harmonics_basis(t(d), degree).numpy(),
            np.asarray(JE.spherical_harmonics_basis(jnp.asarray(d), degree)), **TOL)


SDF_CASES = {
    "analytic": dict(encoding_type="frequency", grad_type="analytic"),
    "analytic_fwd": dict(encoding_type="frequency", grad_type="analytic_fwd"),
    "finite_difference": dict(encoding_type="hashgrid", grad_type="finite_difference"),
    "laplace": dict(encoding_type="hashgrid", grad_type="finite_difference"),
}


def _sdf_pair(case):
    kw = dict(radius=1.0, n_frequencies=4, n_neurons=16, n_hidden_layers=2,
              n_levels=4, log2_hashmap_size=12, base_resolution=4,
              per_level_scale=2.0, **SDF_CASES[case])
    jgeo = JF.VolumeSDF(**kw)
    x = points(32, 5, -0.9, 0.9)
    params = jgeo.init(jax.random.PRNGKey(0), jnp.asarray(x), eps=1e-2)
    if kw["encoding_type"] == "hashgrid":   # tables of order 1e-2
        p = params["params"]
        tab = np.random.RandomState(6).randn(*p["encoding"]["table"].shape) * 1e-2
        params = {"params": {**p, "encoding": {"table": jnp.asarray(tab, jnp.float32)}}}
    pgeo = load(PF.VolumeSDF(**{k: v for k, v in kw.items()}), params)
    return jgeo, params, pgeo, x


@pytest.mark.parametrize("case", sorted(SDF_CASES))
def test_volume_sdf_gradient_modes(case):
    jgeo, params, pgeo, x = _sdf_pair(case)
    laplace = case == "laplace"
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 0] if jgeo.encoding_type == "hashgrid"
                    else [1, 1, 1, 0.5], np.float32)
    eps = 3e-2
    want = jgeo.apply(params, jnp.asarray(x), eps=eps, level_mask=jnp.asarray(mask),
                      with_laplace=laplace)
    got = pgeo(t(x), eps=eps, level_mask=t(mask), with_laplace=laplace)
    assert len(got) == len(want) == (4 if laplace else 3)
    fd = jgeo.grad_type == "finite_difference"
    atols = (1e-6, 4e-7 / eps if fd else 1e-6, 1e-6, 2e-6 / eps ** 2)
    for g, w, atol in zip(got, want, atols):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)
    sdf, feat = pgeo(t(x), with_grad=False)
    np.testing.assert_allclose(sdf.detach().numpy(), np.asarray(want[0]), **TOL)

    # second order: the eikonal term's gradient through the SDF gradient
    def jloss(p):
        s, gr, _ = jgeo.apply(p, jnp.asarray(x), eps=eps)[:3]
        return jnp.mean((jnp.linalg.norm(gr, axis=-1) - 1) ** 2) + jnp.mean(s ** 2)

    jg = neus_group_state(jax.grad(jloss)(params))
    s, gr, _ = pgeo(t(x), eps=eps)[:3]
    (((gr.norm(dim=-1) - 1) ** 2).mean() + (s ** 2).mean()).backward()
    for name, p in pgeo.named_parameters():
        scale = np.abs(jg[name]).max()
        assert np.abs(p.grad.numpy() - jg[name]).max() <= 1e-4 * scale + 1e-7, name


def test_fields_radiance_density_variance():
    feats, nrm = points(20, 7, -1, 1), points(20, 8, -1, 1)
    feats = np.concatenate([feats] * 5, 1)[:, :13]
    jtex = JF.VolumeRadiance()
    ptex_params = jtex.init(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(nrm))
    ptex = load(PF.VolumeRadiance(), ptex_params)
    np.testing.assert_allclose(
        ptex(t(feats), t(nrm)).detach().numpy(),
        np.asarray(jtex.apply(ptex_params, jnp.asarray(feats), jnp.asarray(nrm))), **TOL)
    far = np.array([[0, 0, 0], [0.5, 0, 0], [10, 0, 0], [0, -1e4, 0], [3, 4, 0]],
                   np.float32)
    np.testing.assert_allclose(
        PF.contract_to_unisphere(t(far), 1.0).numpy(),
        np.asarray(JF.contract_to_unisphere(jnp.asarray(far), 1.0)), **TOL)
    z = np.linspace(-30, 30, 13).astype(np.float32)
    np.testing.assert_allclose(PF.trunc_exp(t(z)).numpy(),
                               np.asarray(JF.trunc_exp(jnp.asarray(z))), **TOL)
    pts = points(16, 9, -3, 3)
    jden = JF.VolumeDensity(radius=1.0)
    dparams = jden.init(jax.random.PRNGKey(2), jnp.asarray(pts))
    pden = load(PF.VolumeDensity(radius=1.0), dparams)
    for g, w in zip(pden(t(pts)), jden.apply(dparams, jnp.asarray(pts))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    jbg = JF.VolumeRadianceBg()
    bparams = jbg.init(jax.random.PRNGKey(3), jnp.asarray(feats), jnp.asarray(nrm))
    pbg = load(PF.VolumeRadianceBg(), bparams)
    np.testing.assert_allclose(
        pbg(t(feats), t(nrm)).detach().numpy(),
        np.asarray(jbg.apply(bparams, jnp.asarray(feats), jnp.asarray(nrm))), **TOL)
    jvar = JF.VarianceNetwork(0.3)
    vparams = jvar.init(jax.random.PRNGKey(0))
    pvar = load(PF.VarianceNetwork(0.3), vparams)
    np.testing.assert_allclose(float(pvar().detach()), float(jvar.apply(vparams)),
                               rtol=1e-6)


def _sphere(xp):
    def sdf_only(p):
        return xp.sqrt((p * p).sum(-1) + 1e-12) - 0.5

    def sdf_grad_feat(p):
        n = xp.sqrt((p * p).sum(-1) + 1e-12)
        feat = xp.concatenate([p] * 4 + [p[:, :1]], -1)
        return n - 0.5, p / n[:, None], feat

    def rgb_fn(feat, nrm):
        return xp.abs(nrm) * 0.5 + 0.25 * feat[:, :3]

    return sdf_only, sdf_grad_feat, rgb_fn


class _TorchNp:   # the few array functions _sphere needs, for torch
    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, axis)


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.3, 0.3, (n, 3)) + np.array([-2.0, 0, 0])
    d = np.array([1.0, 0, 0]) + rs.uniform(-0.4, 0.4, (n, 3))
    d[-2:] = [[0, 1.0, 0], [1.0, 2.0, 0]]     # misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jitter(key, R, S, chunk=0):
    if chunk and R > chunk and R % chunk == 0:
        keys = jax.random.split(key, R // chunk)
        return np.concatenate([np.asarray(jax.random.uniform(k, (chunk, S)))
                               for k in keys])
    return np.asarray(jax.random.uniform(key, (R, S)))


RENDER_CASES = {
    "uniform": dict(num_samples=48),
    "uniform_occ_chunked": dict(num_samples=48, ray_chunk=8),
    "coarse_to_fine": dict(num_samples=32, coarse_samples=16),
    "coarse_to_fine_chunked": dict(num_samples=32, coarse_samples=16, ray_chunk=4),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_renderer_matches_jax(case):
    kw = RENDER_CASES[case]
    o, d = _rays(16, 0)
    key = jax.random.PRNGKey(4)
    jitter = _jitter(key, 16, kw["num_samples"], kw.get("ray_chunk", 0))
    binary = None
    if "occ" in case:
        binary = np.random.RandomState(1).rand(8, 8, 8) > 0.3
    j_only, j_sgf, j_rgb = _sphere(jnp)
    p_only, p_sgf, p_rgb = _sphere(_TorchNp)
    want = JR.NeusRenderer(radius=1.0, **kw)(
        jnp.asarray(o), jnp.asarray(d), j_sgf, j_rgb, jnp.asarray(60.0), 0.7,
        None if binary is None else jnp.asarray(binary), jnp.ones(3), key,
        sdf_fn=j_only)
    got = PR.NeusRenderer(radius=1.0, **kw)(
        t(o), t(d), p_sgf, p_rgb, torch.tensor(60.0), 0.7,
        None if binary is None else torch.from_numpy(binary), torch.ones(3),
        t(jitter), sdf_fn=p_only)
    for name, g, w in zip(PR.RenderResult._fields, got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), err_msg=name, **TOL)
    assert got.opacity.max() > 0.9 and got.opacity.min() < 0.1
    # chunked against unchunked, the same jitter
    if kw.get("ray_chunk"):
        whole = PR.NeusRenderer(radius=1.0, **{**kw, "ray_chunk": 0})(
            t(o), t(d), p_sgf, p_rgb, torch.tensor(60.0), 0.7,
            None if binary is None else torch.from_numpy(binary), torch.ones(3),
            t(jitter), sdf_fn=p_only)
        for name, g, w in zip(PR.RenderResult._fields, got, whole):
            torch.testing.assert_close(g, w, msg=name, rtol=0, atol=1e-6)
    # no jitter: the cell centres on both sides
    want = JR.NeusRenderer(radius=1.0, **kw)(
        jnp.asarray(o), jnp.asarray(d), j_sgf, j_rgb, jnp.asarray(60.0), sdf_fn=j_only)
    got = PR.NeusRenderer(radius=1.0, **kw)(t(o), t(d), p_sgf, p_rgb,
                                             torch.tensor(60.0), sdf_fn=p_only)
    np.testing.assert_allclose(got.comp_rgb.numpy(), np.asarray(want.comp_rgb), **TOL)


def test_bg_renderer_matches_jax():
    o, d = _rays(8, 1)
    key = jax.random.PRNGKey(5)
    jitter = np.asarray(jax.random.uniform(key, (8, 1)))

    def dens(xp):
        def f(p):
            r = xp.sqrt((p * p).sum(-1) + 1e-12)
            return 0.05 + 0.01 * r, xp.concatenate([p] * 4 + [p[:, :1]], -1)
        return f

    def rgb(xp):
        return lambda feat, dirs: xp.abs(dirs) * 0.5 + 0.1 * feat[:, :3]

    for j in (None, jitter):
        want = JR.BgRenderer(radius=1.0, num_samples=32, far_plane=50.0)(
            jnp.asarray(o), jnp.asarray(d), dens(jnp), rgb(jnp),
            background_color=jnp.ones(3), rng=None if j is None else key)
        got = PR.BgRenderer(radius=1.0, num_samples=32, far_plane=50.0)(
            t(o), t(d), dens(_TorchNp), rgb(_TorchNp), background_color=torch.ones(3),
            jitter=None if j is None else t(j))
        for name, g, w in zip(PR.BgRenderResult._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                       rtol=2e-5, atol=1e-6)


def test_occupancy_update_and_lookup():
    kw = dict(radius=1.0, resolution=8, update_interval=2, warmup_steps=2)
    jocc, pocc = JO.OccupancyGrid(**kw), PO.OccupancyGrid(device="cpu", **kw)

    def occ_fn(xp):
        return lambda p: xp.exp(-4.0 * (p * p).sum(-1)) * 0.01

    for step in range(6):
        key = jax.random.PRNGKey(10 + step)
        jocc.update(step, occ_fn(jnp), key)
        offs = torch.tensor(np.asarray(jax.random.uniform(key, (8 ** 3, 3))))
        pocc.update(step, occ_fn(torch), offsets=offs)
        np.testing.assert_allclose(pocc.occs.numpy(), np.asarray(jocc.occs), **TOL)
        np.testing.assert_array_equal(pocc.binary.numpy(), np.asarray(jocc.binary))
    assert 0 < int(pocc.binary.sum()) < 8 ** 3
    q = points(200, 11, -1.2, 1.2)
    np.testing.assert_array_equal(
        pocc.lookup(t(q)).numpy(), np.asarray(JO.grid_lookup(jocc.binary, jnp.asarray(q), 1.0)))


def test_losses_match_jax():
    rs = np.random.RandomState(12)
    err = rs.rand(40).astype(np.float32)
    mask = rs.rand(40) > 0.3
    for ratio, red in ((1.0, "mean"), (0.7, "mean"), (0.8, "sum")):
        for m in (None, mask):
            np.testing.assert_allclose(
                float(PS.ranking_loss(t(err), ratio, None if m is None else torch.from_numpy(m), red)),
                float(JS.ranking_loss(jnp.asarray(err), ratio, None if m is None else jnp.asarray(m), red)),
                rtol=1e-6)
    w, m, iv = (rs.rand(6, 16).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        float(PS.distortion_loss(t(w), t(np.cumsum(m, 1)), t(iv))),
        float(JS.distortion_loss(jnp.asarray(w), jnp.asarray(np.cumsum(m, 1)), jnp.asarray(iv))),
        rtol=1e-5)
    p = rs.uniform(0.01, 0.99, 10).astype(np.float32)
    np.testing.assert_allclose(PS.binary_cross_entropy(t(p), t(p > 0.5)).numpy(),
                               np.asarray(JS.binary_cross_entropy(jnp.asarray(p), p > 0.5)),
                               **TOL)


def _silhouettes(n=3, h=40, w=48):
    yy, xx = np.mgrid[:h, :w]
    out = []
    for i in range(n):
        m = ((yy - h / 2 - i) ** 2 / (h / 3) ** 2 + (xx - w / 2 + 2 * i) ** 2 / (w / 4) ** 2) < 1
        m[5:9, 30 + i:40] = True
        out.append(m.astype(np.float32))
    return np.stack(out)


def test_silhouette_normals_match_jax_with_cv2():
    cv2 = pytest.importorskip("cv2")
    from v3d_tpu.data.cameras import get_uniform_poses

    masks = _silhouettes()
    m = (masks > 0.5).astype(np.uint8)
    for i in range(len(m)):   # the port's numpy to OpenCV's definition
        np.testing.assert_array_equal(PN.chamfer_distance_5x5(m[i]),
                                      cv2.distanceTransform(m[i], cv2.DIST_L2, 5))
        d = cv2.distanceTransform(m[i], cv2.DIST_L2, 5)
        np.testing.assert_allclose(PN.gaussian_blur_7x7(d),
                                   cv2.GaussianBlur(d, (7, 7), 0), rtol=0, atol=1e-5)
    poses = get_uniform_poses(3, 2.0, 10.0, opengl=True)
    np.testing.assert_allclose(PN.normals_from_mask_distance(masks, poses),
                               JN.normals_from_mask_distance(masks, poses),
                               rtol=0, atol=1e-5)


def test_dpt_world_normals_match_jax():
    from v3d_tpu.data.cameras import get_uniform_poses

    rs = np.random.RandomState(13)
    dpt = rs.rand(3, 12, 10, 3).astype(np.float32)
    masks = _silhouettes(3, 12, 10)
    poses = get_uniform_poses(3, 2.0, 15.0, opengl=True)
    np.testing.assert_allclose(PN.dpt_world_normals(dpt, masks, poses),
                               JN.dpt_world_normals(dpt, masks, poses), **TOL)
    np.testing.assert_allclose(PN.inv_RT(poses[1]), JN.inv_RT(poses[1]), **TOL)
