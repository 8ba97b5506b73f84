"""Shared pieces of the NeuS trainer parity tests (tests/test_torch_neus_train*.py,
tests/test_torch_neus_export.py): a tiny scene, the two recipes, both
trainers in one state, and the JAX trainer's next draws as the port's
``NeusDraws``."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from v3d_tpu.data.cameras import get_ray_directions as jdirs
from v3d_tpu.data.cameras import get_uniform_poses as jposes
from v3d_tpu.nerf.occupancy import OccupancyGrid as JGrid
from v3d_tpu.nerf.system import NeusConfig as JConfig
from v3d_tpu.nerf.system import NeusTrainer as JTrainer
from v3d_tpu_torch.core.convert import trainer_state_from_jax
from v3d_tpu_torch.data.cameras import get_ray_directions, get_uniform_poses
from v3d_tpu_torch.nerf.occupancy import OccupancyGrid
from v3d_tpu_torch.nerf.system import NeusConfig, NeusDraws, NeusTrainer

torch.set_num_threads(1)

RES, VIEWS = 16, 3
# both trainers' occupancy grid: 16^3, updated (with jittered cells) every step
GRID = dict(radius=1.0, resolution=16, update_interval=1, warmup_steps=0)
RECIPES = {
    "card": dict(geometry_encoding="frequency", grad_type="analytic_fwd",
                 n_frequencies=4, geo_neurons=16, geo_hidden_layers=2,
                 freq_masking_steps=4, use_occ_lookup=False,
                 coarse_to_fine_samples=16, num_samples_per_ray=16,
                 ray_chunk=16, train_num_rays=32, max_train_num_rays=32,
                 max_steps=8,
                 constant_steps=1, cos_anneal_end=4),
    "reference": dict(geometry_encoding="hashgrid",
                      grad_type="finite_difference", n_levels=4,
                      base_resolution=4, per_level_scale=2.0, start_level=2,
                      update_steps=1, geo_neurons=16, num_samples_per_ray=32,
                      train_num_rays=32, max_train_num_rays=32,
                      max_steps=8, constant_steps=1,
                      cos_anneal_end=4, lambda_distortion=0.1),
}


def scene(with_normals):
    """A coloured ball on a black background from VIEWS orbit cameras."""
    yy, xx = np.mgrid[:RES, :RES]
    r2 = (yy - RES / 2 + 0.5) ** 2 + (xx - RES / 2 + 0.5) ** 2
    mask = (r2 < (RES / 3) ** 2).astype(np.float32)
    colour = np.stack([0.2 + yy / RES, 0.8 - xx / RES, 0.5 + 0 * xx], -1) * 0.8
    images = np.stack([colour * mask[..., None] * (1 - 0.1 * i)
                       for i in range(VIEWS)]).astype(np.float32)
    fg = np.repeat(mask[None], VIEWS, 0)
    poses = jposes(VIEWS, 2.0, 0.0, opengl=True)
    dirs = jdirs(RES, RES, RES / (2 * np.tan(np.deg2rad(30))))
    normals = None
    if with_normals:
        n = np.random.RandomState(0).randn(VIEWS, RES, RES, 3)
        normals = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return images, fg, dirs, poses, normals


def _jitter(key, R, S, chunk):
    if chunk and R > chunk and R % chunk == 0:
        return np.concatenate([np.asarray(jax.random.uniform(k, (chunk, S)))
                               for k in jax.random.split(key, R // chunk)])
    return np.asarray(jax.random.uniform(key, (R, S)))


def jax_draws(jt: JTrainer, num_rays: int):
    """What ``jt.train_iter()`` will draw next, as the port's NeusDraws and
    the occupancy update's cell offsets."""
    _, rng_step, rng_occ = jax.random.split(jt.rng, 3)
    draws = step_draws(jt, rng_step, num_rays)
    occ = None
    if jt.global_step >= jt.occ.warmup_steps:
        occ = torch.tensor(np.asarray(jax.random.uniform(rng_occ, (jt.occ.resolution ** 3, 3))))
    return draws, occ


def chunk_draws(jt: JTrainer, n: int, num_rays: int):
    """What ``jt.train_chunk(n)`` will draw, step by step (its chunk key's
    n split keys, each a step's key), as the port's NeusDraws."""
    _, rng_chunk = jax.random.split(jt.rng)
    return [step_draws(jt, r, num_rays) for r in jax.random.split(rng_chunk, n)]


def step_draws(jt: JTrainer, rng_step, num_rays: int) -> NeusDraws:
    """The draws of the JAX ``_train_step`` on the key ``rng_step``."""
    cfg, R = jt.cfg, num_rays
    rng_batch, rng_render, rng_sparse, rng_perturb = jax.random.split(rng_step, 4)
    r1, r2, r3 = jax.random.split(rng_batch, 3)
    rng_fg, rng_bg = jax.random.split(rng_render)

    def tt(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype)

    return NeusDraws(
        idx=tt(jax.random.randint(r1, (R,), 0, jt.n_images), torch.int64),
        x=tt(jax.random.randint(r2, (R,), 0, jt.w), torch.int64),
        y=tt(jax.random.randint(r3, (R,), 0, jt.h), torch.int64),
        jitter=tt(_jitter(rng_fg, R, cfg.num_samples_per_ray, cfg.ray_chunk)),
        rand_pts=tt(jax.random.uniform(rng_sparse, (R, 3), minval=-cfg.radius,
                                       maxval=cfg.radius)),
        perturb=tt(jax.random.normal(rng_perturb, (R, 3))),
        bg_jitter=(tt(jax.random.uniform(rng_bg, (R, 1)))
                   if cfg.learned_background else None))


def pair(recipe, n_port=1):
    """The JAX trainer and ``n_port`` port trainers in its state."""
    images, fg, dirs, poses, normals = scene(recipe == "card")
    kw = dict(RECIPES[recipe], lambda_normal=1.0 if normals is not None else 0.0)
    jt = JTrainer(images, fg, dirs, poses, normals=normals, config=JConfig(**kw),
                  seed=0)
    jt.occ = JGrid(occ_threshold=jt.cfg.grid_prune_occ_thre, **GRID)
    ports = []
    for _ in range(n_port):
        pt = NeusTrainer(images, fg, get_ray_directions(RES, RES, RES / (2 * np.tan(
            np.deg2rad(30)))), get_uniform_poses(VIEWS, 2.0, 0.0, opengl=True),
            normals=normals, config=NeusConfig(**kw), seed=0, device="cpu")
        pt.occ = OccupancyGrid(occ_threshold=pt.cfg.grid_prune_occ_thre,
                               device="cpu", **GRID)
        pt.restore(trainer_state_from_jax(jt.capture()))
        ports.append(pt)
    return (jt, *ports)


def close(got, want, rel=1e-4, what=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-9, (what, err, scale)


def check_train_steps(recipe, trainers=None, rel_of=None, chained_steps=3):
    """Three steps of both trainers from one state.  ``chained`` takes the
    steps on its own state: losses, ray and live-sample counts, occupancy.
    ``stepwise`` starts each step from the JAX trainer's state before it:
    gradients, Adam moments and parameters after AdamW (a chained state
    drifts by float32 rounding, ~1e-7, and the hash table's gradient, a
    difference of the +eps and -eps points' contributions, moves ~1e-3 of
    its size under such a drift).  ``trainers``: (JAX trainer, chained,
    stepwise) in one state, in place of ``pair(recipe, 2)``'s; ``rel_of``
    {(group, name): rel} replaces the tolerance of those parameters; below
    three ``chained_steps``, the chained trainer's losses are held only on
    its first steps, and the stepwise trainer's (from the JAX state) on
    every step."""
    jt, chained, stepwise = trainers or pair(recipe, 2)
    for step in range(3):
        num_rays = jt._quantized_rays()
        assert chained._quantized_rays() == num_rays
        draws, occ = jax_draws(jt, num_rays)
        before = trainer_state_from_jax(jt.capture())
        stepwise.restore(before)
        jstats = jt.train_iter()
        pstats = chained.train_iter(draws=draws, occ_offsets=occ)
        sstats = stepwise.train_iter(draws=draws, occ_offsets=occ)
        assert set(pstats) == set(jstats), (sorted(pstats), sorted(jstats))
        for k in jstats:
            if step < chained_steps:
                np.testing.assert_allclose(float(pstats[k]), float(jstats[k]), rtol=1e-4,
                                           atol=1e-8, err_msg=f"step {step} {k}")
            if chained_steps < 3:
                np.testing.assert_allclose(float(sstats[k]), float(jstats[k]), rtol=1e-4,
                                           atol=1e-8, err_msg=f"step {step} {k}")
        assert chained.train_num_rays == jt.train_num_rays
        np.testing.assert_array_equal(chained.occ.binary.numpy(), np.asarray(jt.occ.binary))
        np.testing.assert_allclose(chained.occ.occs.numpy(), np.asarray(jt.occ.occs),
                                   rtol=1e-5, atol=1e-6)
        after = trainer_state_from_jax(jt.capture())
        pstate = stepwise.capture()
        lr = chained.lr_factor(step)
        for group, params in after["params"].items():
            named = dict(stepwise.modules[group].named_parameters())
            for name, want in params.items():
                what = f"step {step} {group}.{name}"
                ja, pa = after["adam"][group][name], pstate["adam"][group][name]
                assert pa["step"] == ja["step"] == step + 1
                if (group, name) in (rel_of or {}):
                    rel = rel_of[group, name]
                elif name == "encoding.table":
                    rel = 1e-2
                elif group == "geometry" and jt.cfg.grad_type == "finite_difference":
                    rel = 1e-3
                else:
                    rel = 1e-4
                close(pa["exp_avg"].numpy(), ja["exp_avg"], rel, what + " mu")
                close(pa["exp_avg_sq"].numpy(), ja["exp_avg_sq"], rel, what + " nu")
                mu0 = before["adam"][group][name]["exp_avg"] if step else 0 * want
                grad = (ja["exp_avg"] - 0.9 * mu0) / 0.1
                close(named[name].grad.numpy(), grad, rel, what + " grad")
                # the update lr m / (sqrt(v) + eps) moves by at most 1.5 r of
                # itself, r the larger relative difference of the entry's
                # moments, and by at most 2 lr
                r = np.maximum(
                    np.abs(pa["exp_avg"].numpy() - ja["exp_avg"]) / (np.abs(ja["exp_avg"]) + 1e-30),
                    np.abs(pa["exp_avg_sq"].numpy() - ja["exp_avg_sq"])
                    / (np.abs(ja["exp_avg_sq"]) + 1e-30))
                diff = np.abs(pstate["params"][group][name].numpy() - want)
                bound = 1e-6 + 2 * lr * chained.base_lr[group] * np.minimum(1.0, 1.5 * r)
                assert np.all(diff <= bound), (what, diff.max())
    assert chained.global_step == jt.global_step == 3
