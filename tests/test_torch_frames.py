"""The frame-parallel VideoUNet (``parallel/frames.py``): the CFG-doubled
frames of a sample, and a training batch's frames, split over "data" of a
mesh of CPU ranks spawned over gloo (tests/torch_dist_helpers.py), in
float32 with the tiny engine, against the JAX package's single-device
sample and against one process of the port.

- 4 ranks at t = 4 (each video split over 2 ranks) and 3 ranks at t = 3
  (rank 1's block straddles the uncond / cond videos): the sample equals
  the JAX package's ``sample_latents`` on the same weights (the port's,
  carried over with the JAX converter's key map) and noise at
  test_torch_slice.py's TOL; one frame-parallel UNet forward equals one
  process's within 1e-5 of its largest value; the sample equals one
  process's within 1e-4 of its largest value: the sampler (sigma 700 at
  the start, CFG 3.5) magnifies the forward's rounding ~40x, and one
  process's own sample moves 2.4e-5 of its largest value when its UNet
  batch is merely cut in two; every rank holds the same sample.
- One frame-split fine-tune step (activation checkpointing on, so each
  layer's collectives run again in the backward) against one process's
  step on the same batch and draws: loss and gradient norm rel 1e-6,
  every gradient within 1e-4 of its tensor's largest value plus 1e-6 of
  the largest of all (tensors whose gradient is rounding noise).  The
  4-rank step against the JAX trainer is in test_torch_dp_train.py, whose
  JAX step it shares.
- The exchanges round-trip exactly in both modes (all_gather + slice, the
  gloo rule, and all_to_all_single, which gloo also takes on CPU tensors)
  with strips of unequal width, and pass gradcheck in float64 on 2 ranks;
  the split-statistics GroupNorm on a video's strips equals the whole
  video's GroupNorm (float64 F.group_norm) in value and gradient.
- Routed as on the card, a rank's forward and step launch what
  chip_smoke.py counts for its share (``unet_sites`` with ``ranks``).
- A row count the ranks do not divide raises; no rank loads jax; every
  rank count that divides 36 frames gives each rank a strip at every level
  that K2's and K3's plans cover.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dist_helpers import frames_run, start_ranks
from torch_port_helpers import MAP_UNET, numpy_init_, to_flax
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
from v3d_tpu_torch.engines.wrappers import make_unet_network_fn
from v3d_tpu_torch.ops.temporal_attention import temporal_block_plan, temporal_core_plan
from v3d_tpu_torch.parallel.mesh import pixel_strips

TOL = dict(rtol=1e-3, atol=1e-3)      # test_torch_slice.py's
FORWARD_REL = 1e-5
SAMPLE_REL = 1e-4


def _cond(rs, rows, uncond=False):
    c = {"crossattn": rs.randn(rows, 1, 64), "concat": rs.randn(rows, 8, 8, 4),
         "vector": rs.randn(rows, 768)}
    c = {k: v.astype(np.float32) for k, v in c.items()}
    if uncond:    # V3D's uc: the image conds zeroed, the vector kept
        c = {k: (v if k == "vector" else np.zeros_like(v)) for k, v in c.items()}
    return c


def _tt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _start(world: int, t: int, tmp) -> dict:
    """The inputs of a ``world``-rank run at ``t`` frames, the ranks started."""
    engine = build_tiny_engine(num_frames=t, num_steps=2, device="cpu")
    numpy_init_(engine.unet, 31 + t)
    state = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    rs = np.random.RandomState(t)
    # a context that differs per frame: the temporal layers must gather
    # each video's first frame, not assume repeats
    c = _cond(rs, t)
    uc = {k: (v if k == "vector" else np.zeros_like(v)) for k, v in c.items()}
    noise = rs.randn(t, 8, 8, 4).astype(np.float32)
    forward = {"x": rs.randn(2 * t, 8, 8, 4).astype(np.float32),
               "c_noise": rs.uniform(0, 3, 2 * t).astype(np.float32),
               "cond": _cond(rs, 2 * t)}
    batch = {"latents": rs.randn(2 * t, 8, 8, 4).astype(np.float32),
             "cond": _cond(rs, 2 * t),
             "sigmas": np.exp(rs.randn(2 * t)).astype(np.float32),
             "noise": rs.randn(2 * t, 8, 8, 4).astype(np.float32)}
    inputs = {"c": c, "uc": uc, "noise": noise, "forward": forward, "batch": batch}
    wait = start_ranks(frames_run, world, tmp, t, state, inputs, world == 3)
    return dict(world=world, t=t, engine=engine, inputs=inputs, wait=wait)


def _finish(run: dict) -> dict:
    """The references of a started run (the JAX sample, one process of the
    port), then its ranks' results."""
    t, engine, inputs = run["t"], run.pop("engine"), run.pop("inputs")
    c, uc, noise = inputs["c"], inputs["uc"], inputs["noise"]
    forward, batch = inputs["forward"], inputs["batch"]
    jengine = jax_tiny_engine(num_frames=t, num_steps=2, resolution=64)
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    run["z_jax"] = np.asarray(jengine.sample_latents(
        {"unet": to_flax(engine.unet, MAP_UNET)}, jax.random.PRNGKey(0), j(c), j(uc),
        64, 64, noise=jnp.asarray(noise)))
    run["z_one"] = engine.sample_latents(_tt(c), _tt(uc), 64, 64,
                                         noise=torch.from_numpy(noise))
    with torch.no_grad():
        run["f_one"] = make_unet_network_fn(engine.unet, t)(
            torch.from_numpy(forward["x"]), torch.from_numpy(forward["c_noise"]),
            _tt(forward["cond"]), torch.zeros(2, t))
    single = DiffusionTrainer(engine, TrainConfig(), num_frames=t)
    run["stats"] = single.train_step(
        torch.from_numpy(batch["latents"]), _tt(batch["cond"]),
        sigmas=torch.from_numpy(batch["sigmas"]), noise=torch.from_numpy(batch["noise"]))
    run["grads"] = {k: p.grad.clone() for k, p in zip(single.names, single.params)
                    if p.grad is not None}
    run["ranks"] = run.pop("wait")()
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks at once, the references meanwhile."""
    started = [_start(4, 4, tmp_path_factory.mktemp("frames4")),
               _start(3, 3, tmp_path_factory.mktemp("frames3"))]
    return {run["world"]: _finish(run) for run in started}


@pytest.fixture(scope="module")
def four(runs):
    return runs[4]


@pytest.fixture(scope="module")
def three(runs):
    return runs[3]


@pytest.fixture(scope="module")
def checks(three):
    """``frames_checks`` of ranks 0 and 1 of the 3-rank run."""
    return [r["checks"] for r in three["ranks"][:2]]


CONFIGS = ("four", "three")


@pytest.mark.parametrize("config", CONFIGS)
def test_sharded_sample_matches_the_jax_single_device_sample(config, request):
    run = request.getfixturevalue(config)
    for r in run["ranks"]:
        assert r["sample"].shape == (run["t"], 8, 8, 4)
        np.testing.assert_allclose(r["sample"].numpy(), run["z_jax"], **TOL)


@pytest.mark.parametrize("config", CONFIGS)
def test_sharded_sample_and_forward_match_one_process(config, request):
    run = request.getfixturevalue(config)
    z, f = run["z_one"], run["f_one"]
    for r in run["ranks"]:
        assert torch.equal(r["sample"], run["ranks"][0]["sample"])
        assert float((r["sample"] - z).abs().max()) <= SAMPLE_REL * float(z.abs().max())
        assert float((r["forward"] - f).abs().max()) <= FORWARD_REL * float(f.abs().max())
        # an exchange a temporal sub-block in and out, 2 steps x 1 forward
        assert r["traffic"]["exchanges"] > 0 and r["traffic"]["bytes"] > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_frame_split_step_matches_one_process(config, request):
    run = request.getfixturevalue(config)
    want, grads = run["stats"], run["grads"]
    top = max(float(g.abs().max()) for g in grads.values())
    for r in run["ranks"]:
        assert r["step"]["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert r["step"]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-6)
        assert r["grads"].keys() == grads.keys()
        for name, g in grads.items():
            err = float((r["grads"][name] - g).abs().max())
            assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * top, (name, err)


@pytest.mark.parametrize("config", CONFIGS)
def test_launches_are_chip_smokes_counts_of_a_ranks_share(config, request):
    """Routed as on the card (each kernel wrapper counting and running its
    plain version), a rank's forward and step launch what chip_smoke.py
    counts for its share: the time stacks' GroupNorms as K6's split pair,
    the temporal attentions by their strip's width."""
    run = request.getfixturevalue(config)
    for r in run["ranks"]:
        for key in ("forward_launches", "step_launches"):
            got, want = r[key]
            assert got == want, (key, got, want)
        got = r["forward_launches"][0]
        assert got["group_norm_stats"] == got["group_norm_apply"] > 0


@pytest.mark.parametrize("ranks", [n for n in range(1, 37) if 36 % n == 0])
def test_every_rank_count_of_36_frames_gives_kernels_a_strip(ranks):
    """Each rank count that divides V3D's 36 CFG frames gives every rank a
    strip of pixels at every level (64^2 down to 8^2 latents), and K2's and
    K3's launch plans cover the strip's pixel rows."""
    for s in (4096, 1024, 256, 64):
        strips = pixel_strips(s, ranks)
        assert strips[0][0] == 0 and strips[-1][1] == s
        assert all(b > a for a, b in strips)
        for a, b in strips:
            block = temporal_block_plan(2, 18, b - a, 320, 5, 64)
            assert block["grid"] * block["pixels"] >= 2 * (b - a)
            assert temporal_core_plan(2, 18, b - a, 10, 64)["items"] == 2 * (b - a) * 10
    with pytest.raises(ValueError, match="do not give each"):
        pixel_strips(64, 65)


@pytest.mark.parametrize("config", CONFIGS)
def test_exchanges_round_trip_on_uneven_strips(config, request):
    run = request.getfixturevalue(config)
    world = run["world"]
    strips = pixel_strips(7, world)
    assert [b - a for a, b in strips] == [len(s) for s in torch.arange(7).tensor_split(world)]
    for rank, r in enumerate(run["ranks"]):
        rt = r["round_trip"]
        assert rt["mode"] == "all_gather"          # gloo's rule
        a, b = strips[rank]
        for mode in ("all_gather", "all_to_all"):
            px, back, x = rt[mode]
            assert torch.equal(px, rt["whole"][:, a:b]), mode
            assert torch.equal(back, x), mode


def test_exchanges_pass_gradcheck_on_two_ranks(checks):
    for r in checks:
        assert r["mode"] == "all_gather"
        assert all(all(ok) for ok in r["gradcheck"].values()), r["gradcheck"]


def test_split_group_norm_equals_the_whole_video(checks):
    for r in checks:
        g = r["gn"]
        for got, want in (("y", "y64"), ("dx", "dx64")):
            scale = float(g[want].abs().max())
            assert float((g[got].double() - g[want]).abs().max()) <= 1e-5 * scale, got
    # scale / bias: each rank's share of the gradient, summed over the ranks
    for got, want in (("dw", "dw64"), ("db", "db64")):
        total = sum(r["gn"][got].double() for r in checks)
        ref = checks[0]["gn"][want]
        assert float((total - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), got


@pytest.mark.parametrize("config", CONFIGS)
def test_indivisible_rows_raise_and_no_rank_loads_jax(config, request):
    run = request.getfixturevalue(config)
    for r in run["ranks"]:
        assert r["indivisible"] and "do not split over data" in r["indivisible"]
        assert r["foreign"] == []
