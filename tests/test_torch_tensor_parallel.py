"""The tensor-parallel forward over "model" (``parallel/tensor.py``): four
CPU ranks spawned over gloo (tests/torch_dist_helpers.py ``tp_run``), in
float32, against the JAX package on conftest's 8-device CPU mesh, the
weights carried over by the JAX converter's key maps.

- One SpatialVideoTransformer at V3D's ds1 ratio (5 heads of 64, 320
  channels, 8^2 pixels, t = 4, context 1024), cut over 2 model ranks (a
  (2, 2) mesh) and over 4 (a (1, 4) mesh): its output and the input's
  gradient each within 1e-5 of its largest value of the JAX module's, and
  every parameter's gradient (made whole) within 1e-5 of the largest of the
  JAX gradients (the mix factor's, a sum over all 164k elements, differs by
  1.4e-5 of its own between the two frameworks, with or without the cut);
  every head straddles at ds1 (3 heads a rank at 2 ranks, 2 at 4), and a
  forward all-reduces 7 times.
- The dry run's tensor-parallel step (``dryrun.tp_train_step``:
  ``training_loss`` and AdamW at optax.adamw's defaults, lr 1e-4; here with
  activation checkpointing, whose recompute runs every collective again) on
  the (2, 2) mesh against __graft_entry__.py:171-207 computed by the JAX
  package on a JAX (2, 2) mesh with ``shard_params``, on the same weights,
  batch and draws: the loss rel 1e-4; every updated parameter within
  2e-6 abs plus 1e-5 relative, elements whose gradient is rounding noise
  within 2 lr (test_torch_dp_train.py's, with the noise at 1e-5 of the
  largest gradient instead of 1e-6: time-stack convolution gradients at
  1.1-1.5e-6 of it differ by ~40% between JAX and the port, and Adam's first
  step, lr g / (|g| + eps), moves such elements by ~2.5e-6).  Every
  gathered gradient within 1e-4 of its tensor's largest value plus 1e-6 of
  the largest of all (test_torch_frames.py's step tolerance) of one
  process's step of the port: the JAX (2, 2) computation's own gradients of
  the time stacks' (3, 1, 1) convolutions are off its one-device gradients
  by several percent of the largest gradient (its (2, 1) and (1, 2) meshes
  agree with one device), which Adam's first step, lr sign(g) where |g| >>
  eps, does not show in the parameters.  The batch is a seeded synthetic
  orbit's (the graft's cond is zeros, which leaves the cross-attention's
  K/V without a gradient).
- The dry run's sampling stage (3 Euler steps, t = 4, c ones, uc zeros)
  with the CFG frames over "data" and the UNet over "model", against the
  graft's sharded JAX sample (:217-254) at test_torch_frames.py's TOL.
- A tiny UNet at 96 channels with heads of 32 (3 heads at ds1, straddling
  2 ranks; 6 at ds2, even) through ``sample_latents(mesh=)`` on the (2, 2)
  mesh against one process's sample (1e-4 of its largest value, as
  test_torch_frames.py); routed as on the card, a rank's forward launches
  what chip_smoke.py counts for one process's.
- ``tp_shard_`` / ``tp_gather`` round-trip every tensor bit for bit; each
  rank's Q/K/V / out / net.2 shard is ``shard_params``' (the JAX shards,
  test_torch_parallel.py); the GEGLU projection holds this rank's value and
  gate rows; a module whose rules place a tensor no layer runs tensor-
  parallel is refused; ``DiffusionTrainer`` makes a cut UNet whole again.
- float64 gradcheck of copy_to_model / reduce_from_model / gather_columns
  on each 2-rank model row, and reduce_from_model's backward hands back the
  cotangent itself (an all-reducing backward would double it).
- The full-size meta stage on the 4 ranks: the denoise step's output
  shape, and a global parameter count equal to the JAX module's
  ``jax.eval_shape`` count; no rank loads jax.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_helpers import T, start_ranks, tp_run
from torch_port_helpers import MAP_SVT, MAP_UNET, numpy_init_, to_flax
from v3d_tpu.diffusion.sigma_sampling import EDMSampling
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.engines.builder import build_v3d_engine as jax_v3d_engine
from v3d_tpu.models import video_attention as JV
from v3d_tpu.parallel import mesh as jmesh
from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
from v3d_tpu_torch.ops.temporal_attention import temporal_block_plan
from v3d_tpu_torch.parallel import dryrun
from v3d_tpu_torch.parallel.tensor import head_plan

SVT_REL = 1e-5              # of the largest value of each JAX tensor
TOL = dict(rtol=1e-3, atol=1e-3)      # test_torch_frames.py's, against JAX
SAMPLE_REL = 1e-4           # test_torch_frames.py's, against one process
LR = dryrun.TP_LR
STRADDLE = dict(model_channels=96, num_head_channels=32)


def _svt_inputs():
    rs = np.random.RandomState(7)
    c, heads, dh, t, b, hw, ctx = 320, 5, 64, T, 2, 8, 1024
    return {"c": c, "heads": heads, "dh": dh, "context_dim": ctx, "t": t,
            "x": rs.randn(b * t, hw, hw, c).astype(np.float32),
            "ctx": rs.randn(b * t, 1, ctx).astype(np.float32),
            "ind": np.zeros((b, t), np.float32),
            "cot": rs.randn(b * t, hw, hw, c).astype(np.float32)}


def _jax_svt(svt, i):
    params = to_flax(svt, MAP_SVT)
    module = JV.SpatialVideoTransformer(i["heads"], i["dh"], num_frames=i["t"])
    ctx, ind, cot = (jnp.asarray(i[k]) for k in ("ctx", "ind", "cot"))

    def f(p, x):
        y = module.apply(p, x, ctx, None, ind)
        return jnp.sum(y * cot), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(i["x"]))
    return {"y": np.asarray(y), "dx": np.asarray(gx), "grads": gp}


def _jax_step(unet_flax, step, jm):
    """__graft_entry__.py:171-207 on the JAX (2, 2) mesh: shard_params, one
    jitted training_loss + optax.adamw(1e-4) step on latents and cond over
    "data"."""
    engine = jax_tiny_engine(num_frames=T, num_steps=2, resolution=64)
    params = jmesh.shard_params(unet_flax, jm)
    opt = optax.adamw(LR)
    put = lambda x: jax.device_put(  # noqa: E731
        x, NamedSharding(jm, P(jmesh.DATA_AXIS, *([None] * (x.ndim - 1)))))

    @jax.jit
    def train_step(p, opt_state, rng, latents, cond):
        loss, grads = jax.value_and_grad(
            lambda q: engine.training_loss(q, rng, latents, cond, num_frames=T))(p)
        updates, opt_state = opt.update(grads, opt_state, p)
        return loss, optax.apply_updates(p, updates)

    with jm:
        loss, new = train_step(
            params, opt.init(params), jax.random.PRNGKey(dryrun.TP_SEED),
            put(jnp.asarray(step["latents"])),
            {k: put(jnp.asarray(v)) for k, v in step["cond"].items()})
    return {"loss": float(loss), "params": jax.tree_util.tree_map(np.asarray, new)}


def _jax_sample(unet_flax, sample, jm):
    """__graft_entry__.py:217-254: the tiny engine's sample with the UNet's
    parameters placed by shard_params and the frames over "data"."""
    engine = jax_tiny_engine(num_frames=T, num_steps=dryrun.SAMPLE_STEPS, resolution=64)
    put = lambda x: jax.device_put(  # noqa: E731
        x, NamedSharding(jm, P(jmesh.DATA_AXIS, *([None] * (x.ndim - 1)))))

    def run(p, noise, c, uc):
        return engine.sample_latents(p, jax.random.PRNGKey(4), c, uc, height=64, width=64,
                                     noise=noise)

    j = lambda tree: {k: put(jnp.asarray(v)) for k, v in tree.items()}  # noqa: E731
    with jm:
        out = jax.jit(run)({"unet": jmesh.shard_params(unet_flax, jm)},
                           put(jnp.asarray(sample["noise"])), j(sample["c"]), j(sample["uc"]))
    return np.asarray(out)


def _jax_v3d_count() -> int:
    engine = jax_v3d_engine(num_frames=18, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: engine.unet.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 8)), jnp.zeros((2,)),
        jnp.zeros((2, 1, 1024)), jnp.zeros((2, 768)), num_video_frames=1,
        image_only_indicator=jnp.zeros((2, 1))))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks started first; the JAX computations meanwhile, the step and
    the sample compiling in threads of their own."""
    inputs = _svt_inputs()
    svt = numpy_init_(SpatialVideoTransformer(inputs["c"], inputs["heads"], inputs["dh"],
                                              inputs["context_dim"]), 8)
    svt_state = {k: v.clone() for k, v in svt.state_dict().items()}
    tiny = build_tiny_engine(num_frames=T, device="cpu")
    numpy_init_(tiny.unet, 9)
    tiny_state = {k: v.clone() for k, v in tiny.unet.state_dict().items()}

    host = next(SyntheticOrbitDataset(1, T, dryrun.TRAIN_HW, seed=3,
                                      clip_dim=64).iter_batches(1))
    cond = {k: v.numpy() for k, v in tiny.training_cond(host, num_frames=T).items()}
    latents = np.asarray(host["latents"], np.float32)
    k_sig, k_noise, _ = jax.random.split(jax.random.PRNGKey(dryrun.TP_SEED), 3)
    step = {"latents": latents, "cond": cond,
            "sigmas": np.asarray(EDMSampling(p_mean=1.5, p_std=2.0)(k_sig, T)),
            "noise": np.asarray(jax.random.normal(k_noise, latents.shape))}
    ones = {"crossattn": (T, 1, 64), "concat": (T, 8, 8, 4), "vector": (T, 768)}
    sample = {"c": {k: np.ones(s, np.float32) for k, s in ones.items()},
              "uc": {k: np.zeros(s, np.float32) for k, s in ones.items()},
              "noise": np.asarray(jax.random.normal(jax.random.PRNGKey(3), (T, 8, 8, 4)))}
    wide = build_tiny_engine(num_frames=T, num_steps=2, device="cpu", unet_overrides=STRADDLE)
    numpy_init_(wide.unet, 10)
    rs = np.random.RandomState(11)
    straddle = {"overrides": STRADDLE,
                "state": {k: v.clone() for k, v in wide.unet.state_dict().items()},
                "forward": {"x": rs.randn(2 * T, 8, 8, 4).astype(np.float32),
                            "c_noise": rs.uniform(0, 3, 2 * T).astype(np.float32),
                            "cond": {"crossattn": rs.randn(2 * T, 1, 64).astype(np.float32),
                                     "concat": rs.randn(2 * T, 8, 8, 4).astype(np.float32),
                                     "vector": rs.randn(2 * T, 768).astype(np.float32)}}}
    wait = start_ranks(tp_run, 4, tmp_path_factory.mktemp("tp"), svt_state, inputs,
                       tiny_state, step, sample, straddle, timeout_s=240)

    jm = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    unet_flax = to_flax(tiny.unet, MAP_UNET)
    out, errors = {}, []

    def in_thread(key, fn, *args):
        def target():
            try:
                out[key] = fn(*args)
            except BaseException as e:      # re-raised below
                errors.append(e)
        th = threading.Thread(target=target)
        th.start()
        return th

    threads = [in_thread("step", _jax_step, unet_flax, step, jm),
               in_thread("sample", _jax_sample, unet_flax, sample, jm)]
    out["svt"] = _jax_svt(svt, inputs)
    out["count"] = _jax_v3d_count()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return dict(out, ranks=wait(), inputs=inputs)


def _flax_get(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


@pytest.mark.parametrize("key", ["svt2", "svt4"])
def test_ds1_transformer_matches_the_jax_module(run, key):
    """Value, input gradient and every parameter's gradient of the ds1
    transformer cut over 2 and 4 model ranks against the JAX module."""
    want = run["svt"]
    top = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want["grads"]))
    for r in run["ranks"]:
        got = r[key]
        for name in ("y", "dx"):
            scale = float(np.abs(want[name]).max())
            assert float(np.abs(got[name].numpy() - want[name]).max()) <= SVT_REL * scale, name
        assert got["grads"].keys() == {n for n, _ in SpatialVideoTransformer(
            320, 5, 64, 1024).named_parameters()}
        for name, g in got["grads"].items():
            path, fn = MAP_SVT(name)
            ref = _flax_get(want["grads"]["params"], path)
            err = float(np.abs(np.asarray(fn(g)) - ref).max())
            assert err <= SVT_REL * top, (name, err)
        # 2 attention sub-layers a block, spatial and temporal; each straddles
        assert got["traffic"]["all_reduce"] == 7
        assert got["traffic"]["all_gather"] == 12
        size = 2 if key == "svt2" else 4
        for first, last, pad in got["plans"].values():
            assert last - first == {2: 3, 4: 2}[size] and pad != (0, 0)


def test_tp_step_matches_the_jax_sharded_step(run):
    want = run["step"]
    grads = run["ranks"][0]["step_one"]["grads"]
    top = max(float(g.abs().max()) for g in grads.values())
    for r in run["ranks"]:
        assert r["step"]["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert r["step"]["grads"].keys() == grads.keys() == r["step"]["params"].keys()
        for name, g in grads.items():
            err = float((r["step"]["grads"][name] - g).abs().max())
            assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * top, (name, err)
        for name, x in r["step"]["params"].items():
            path, fn = MAP_UNET(name)
            a, b = np.asarray(fn(x)), _flax_get(want["params"]["params"], path)
            zero = np.abs(np.asarray(fn(grads[name]))) < 1e-5 * top
            err = np.abs(a - b) - (np.where(zero, 2 * LR, 2e-6) + 1e-5 * np.abs(b))
            assert float(err.max()) <= 0, (name, float(np.abs(a - b).max()))
    # every rank holds the same whole parameters and loss
    for r in run["ranks"][1:]:
        assert r["step"]["loss"] == run["ranks"][0]["step"]["loss"]
        for name, x in r["step"]["params"].items():
            assert torch.equal(x, run["ranks"][0]["step"]["params"][name]), name


def test_tp_sample_matches_the_jax_sharded_sample(run):
    for r in run["ranks"]:
        assert r["sample"].shape == (T, 8, 8, 4)
        np.testing.assert_allclose(r["sample"].numpy(), run["sample"], **TOL)
        assert torch.equal(r["sample"], run["ranks"][0]["sample"])


def test_straddling_heads_sample_matches_one_process(run):
    for r in run["ranks"]:
        # ds1: 3 heads of 32 over 2 ranks -> heads 0-1 and 1-2, half a head
        # padded; ds2: 6 heads, 3 a rank, nothing gathered
        plans = set(r["plans"].values())
        model = r["coord"][1]
        assert plans == {((0, 2, (0, 16)) if model == 0 else (1, 3, (16, 0))),
                         ((0, 3, (0, 0)) if model == 0 else (3, 6, (0, 0)))}
        one, got = r["straddle_one"], r["straddle"]
        assert float((got - one).abs().max()) <= SAMPLE_REL * float(one.abs().max())
        assert torch.equal(got, run["ranks"][0]["straddle"])


def test_launches_of_a_tp_rank_are_one_process_counts(run):
    for r in run["ranks"]:
        got, want = r["launches"]
        assert got == want
        assert got["temporal_block"] > 0 and got["temporal_core"] > 0


def test_shard_and_gather_round_trip_and_match_shard_params(run):
    for r in run["ranks"]:
        assert r["round_trip"]
        assert r["local_vs_placed"] and all(r["local_vs_placed"].values())
        model = r["coord"][1]
        for name, (local, whole) in r["geglu"].items():
            value, gate = whole.chunk(2, 0)
            half = value.shape[0] // 2
            rows = slice(model * half, (model + 1) * half)
            assert torch.equal(local, torch.cat([value[rows], gate[rows]])), name
        tp_bytes, placed_bytes, bias_bytes = r["local_bytes"]
        # the same bytes as the JAX shards, less half of each GEGLU bias
        # (JAX replicates the 1-D biases, the re-cut keeps this rank's rows)
        assert tp_bytes == placed_bytes - bias_bytes // 2
        assert r["clip_refused"] and "placements and the tensor-parallel layers" in \
            r["clip_refused"]
        assert r["trainer_whole"]


def test_collectives_pass_gradcheck_and_reduce_does_not_reduce_its_gradient(run):
    for r in run["ranks"]:
        c = r["checks"]
        assert c["copy"] and c["reduce"] and c["gather"]
        grad, g = c["reduce_from_model"]
        assert torch.equal(grad, g)
        grad, g = c["all_reduce_sum"]
        assert torch.equal(grad, 2 * g)


def test_fullsize_meta_stage_and_no_rank_loads_jax(run):
    for r in run["ranks"]:
        f = r["fullsize"]
        assert f["out_shape"] == f["want_shape"] == [18, 64, 64, 4]
        assert f["out_device"] == "meta"
        assert f["params"] == f["params_gathered"] == run["count"]
        assert f["local_bytes"] < f["full_bytes"]
        assert f["traffic"]["model"]["all_reduce"] == 112
        assert r["foreign"] == []


@pytest.mark.parametrize("size", [2, 4])
def test_head_plans_of_v3d_widths(size):
    """Each rank's run heads cover its columns; ds1 (5 heads) straddles at 2
    and 4 ranks, ds2 (10) at 4 only, ds4 / ds8 (20) never; K2's wgmma plan
    takes a rank's 3 or 2 heads at ds1."""
    for heads, straddles in ((5, True), (10, size == 4), (20, False)):
        covered = []
        for index in range(size):
            p = head_plan(heads, 64, size, index)
            a, b = p.cols
            assert p.first * 64 + p.pad[0] == a and p.last * 64 - p.pad[1] == b
            assert p.even != straddles
            covered.append((a, b))
        assert covered[0][0] == 0 and covered[-1][1] == heads * 64
        assert all(x[1] == y[0] for x, y in zip(covered, covered[1:]))
    local = head_plan(5, 64, size, 0).heads
    plan = temporal_block_plan(2, 18, 4096, 320, local, 64)
    assert plan["path"] == "wgmma" and plan["grid"] * plan["pixels"] >= 2 * 4096
