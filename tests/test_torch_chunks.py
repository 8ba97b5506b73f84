"""The trainers' step chunks and the fit paths' last pieces against the JAX
package, on the CPU: ``GSTrainer.train`` / ``train_chunk`` and
``NeusTrainer.train(chunk=...)`` / ``train_chunk`` (on the card a chunk
replays a CUDA graph of one step; here it runs its steps eagerly, which is
what the schedule, the draws and the arithmetic are held to), the trainers'
``save`` / ``load``, the numpy ``densify_and_prune_np``, ``save_packed_ply``,
``snapshot_run``, ``ExperimentLogger.log_images`` and ``full_asset``
fitting from the mp4 it writes (C7).

Tolerances:
- GS: the numpy generator's calls (camera indices, backgrounds, densify
  draws) and the events' iterations exact; each step's loss rel 1e-4 (as
  test_torch_gs_trainer.py's steps); alive masks equal; the alive slots'
  final parameters within 2 x steps x lr of the JAX ones: Adam moves an
  entry by about lr a step whatever its gradient's size, so an entry whose
  gradient is rounding noise (rotation at the isotropic init, the fresh
  moments of densify's children, as test_torch_recon_gs_iterative.py)
  can part by lr a step on each side, and a split child's offset is
  rotated by its source's rotation (seen: xyz 10 lr, rotation 8 lr at
  most, medians <= 0.9 lr, over 12 steps);
- NeuS: a chunk of 3 steps from one state on the JAX chunk's draws: the
  last step's loss terms rel 1e-4 (the chained losses of
  torch_neus_helpers.check_train_steps), Adam's step counts equal, the
  moments within 1e-3 of their largest entry and every parameter within
  2 x steps x its group's lr (C6: chained float32 states part by
  rounding, the gradients are held stepwise in test_torch_neus_train.py);
- the port's chunk against its own steps on the same draws, the save /
  load round trips, the numpy densify, the PLY, snapshot and PNG bytes:
  exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from v3d_tpu.data.cameras import orbit_cameras as jorbit
from v3d_tpu.gs.densify import DensifyState as JDensifyState
from v3d_tpu.gs.densify import densify_and_prune as jdensify_np
from v3d_tpu.gs.ply import save_packed_ply as jsave_packed_ply
from v3d_tpu.gs.trainer import GSTrainConfig as JConfig
from v3d_tpu.gs.trainer import GSTrainer as JTrainer
from v3d_tpu.utils.logging import ExperimentLogger as JLogger
from v3d_tpu.utils.snapshot import snapshot_run as jsnapshot_run
from v3d_tpu_torch.core.convert import trainer_state_from_jax
from v3d_tpu_torch.data.cameras import orbit_cameras
from v3d_tpu_torch.gs.densify import DensifyState, densify_and_prune_np
from v3d_tpu_torch.gs.ply import save_packed_ply
from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
from v3d_tpu_torch.utils.logging import ExperimentLogger
from v3d_tpu_torch.utils.snapshot import snapshot_run

from test_torch_gs_trainer import CFG, KEYS, _densify_case, _frames
from torch_neus_helpers import chunk_draws, pair

torch.set_num_threads(1)


class _Recorded:
    """A numpy RandomState that logs each call and its result."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def call(*a, **k):
            out = fn(*a, **k)
            self._log.append((name, a, sorted(k.items()), np.asarray(out).tolist()))
            return out

        return call


def _instrument(trainer, counter: str):
    """Log the trainer's generator calls, densify events (at its step count
    ``counter``), every step's loss and the calls of train_chunk /
    train_iter."""
    log = {"rng": [], "events": [], "alive_before": [], "losses": [], "calls": []}
    trainer.rng = _Recorded(trainer.rng, log["rng"])
    event = trainer._densify_event

    def densify():
        log["events"].append(getattr(trainer, counter))
        log["alive_before"].append(np.array(trainer.alive))
        return event()

    trainer._densify_event = densify
    for name in ("train_chunk", "train_iter"):
        fn = getattr(trainer, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            stats = _fn(*a, **k)
            losses = np.asarray(stats.get("losses", stats["loss"]), np.float64).reshape(-1)
            log["losses"].extend(losses.tolist())
            log["calls"].append((_name, len(losses)))
            return stats

        setattr(trainer, name, wrapped)
    return log


GS_CHUNK = dict(CFG, densify_from_iter=2, densification_interval=8, densify_until_iter=100,
                densify_grad_threshold=1e-6, chunk_size=4)
GS_ITERS = 12


@pytest.mark.parametrize("random_background,host_densify",
                         [(False, True), (True, True), (True, False)])
def test_gs_train_chunks_match_jax(random_background, host_densify):
    """``train(12)`` at chunk_size 4 across a densify event at 8: the
    segments 2 steps, a chunk of 4 and 2 steps to the event, a chunk of 4
    after it, on both sides.  With ``host_densify`` the split offsets are
    the same numpy draws, so the parameters are compared after the event;
    on the device path (the port's torch generator, JAX's key) only the
    schedule, the draws and the losses up to the event."""
    frames = _frames()
    kw = dict(GS_CHUNK, random_background=random_background, host_densify=host_densify)
    jt = JTrainer(jorbit(4, resolution=64, images=frames), JConfig(**kw), num_pts=200,
                  capacity=400, seed=0)
    pt = GSTrainer(orbit_cameras(4, resolution=64, images=frames), GSTrainConfig(**kw),
                   num_pts=200, capacity=400, seed=0, device="cpu")
    jlog, plog = _instrument(jt, "step_count"), _instrument(pt, "step_count")
    for n in (8, GS_ITERS - 8):     # the event is the last step of the first
        jt.train(n)
        pt.train(n)
        if n == 8 and host_densify:
            # the optimizer surgery: the moments of the slots the event
            # changed are zero on both sides
            changed = plog["alive_before"][0] != pt.alive.numpy()
            assert changed.sum() > 0
            np.testing.assert_array_equal(changed, jlog["alive_before"][0] != np.asarray(jt.alive))
            jadam = trainer_state_from_jax(jt.capture())["adam"]
            for k in KEYS:
                for m in ("exp_avg", "exp_avg_sq"):
                    assert not pt.opt.state[pt.params[k]][m].numpy()[changed].any(), (k, m)
                    assert not jadam[k][m][changed].any(), (k, m)
    assert pt.step_count == jt.step_count == GS_ITERS
    assert plog["calls"] == jlog["calls"] == [("train_iter", 1)] * 2 + [("train_chunk", 4)] + [
        ("train_iter", 1)] * 2 + [("train_chunk", 4)]
    assert plog["events"] == jlog["events"] == [8]
    assert plog["rng"] == jlog["rng"]
    assert sum(name == "rand" for name, *_ in plog["rng"]) == (6 if random_background else 0)
    n = GS_ITERS if host_densify else 8
    np.testing.assert_allclose(plog["losses"][:n], jlog["losses"][:n], rtol=1e-4)
    if not host_densify:
        return
    jg, pg = jt.gaussians_np(), pt.gaussians_np()
    np.testing.assert_array_equal(pg["alive"], jg["alive"])
    assert pg["alive"].sum() > 200
    cfg = pt.cfg
    lrs = {"xyz": cfg.position_lr_init * pt.extent, "f_dc": cfg.feature_lr,
           "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
           "rotation": cfg.rotation_lr}
    live = pg["alive"]
    for k, lr in lrs.items():
        err = np.abs(pg[k] - jg[k])[live].max()
        assert err <= 2 * GS_ITERS * lr, (k, err / lr)


def test_gs_chunk_equals_its_steps():
    """The port's train_chunk on given views is its train_iter steps on
    them, bit for bit, random backgrounds included (n draws of 3 are one
    draw of (n, 3)); the counterpart of the JAX package's
    test_gs_trainer.py test_train_chunk_matches_per_iter."""
    frames = _frames(n=4, res=32)
    cams = orbit_cameras(4, resolution=32, images=frames)
    cfg = GSTrainConfig(**dict(CFG, random_background=True, chunk_size=3))
    a = GSTrainer(cams, cfg, num_pts=64, capacity=96, device="cpu")
    b = GSTrainer(cams, cfg, num_pts=64, capacity=96, device="cpu")
    order = [0, 1, 2, 3, 1, 0]
    losses = [float(a.train_iter(i)["loss"]) for i in order]
    stats = b.train_chunk(len(order), cam_indices=np.asarray(order))
    assert stats["iter"] == b.step_count == len(order)
    assert stats["losses"].tolist() == losses
    for k in KEYS:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("kind", ["gs", "neus"])
def test_train_schedules_match_jax(kind):
    """Which steps ``train`` runs as chunks and which one by one, across
    event and log boundaries, against the JAX trainers' ``train`` (the
    steps stubbed on both sides: only the driver is compared)."""
    if kind == "gs":
        frames = _frames(n=2, res=32)
        kw = dict(CFG, densify_from_iter=30, densification_interval=40, densify_until_iter=150,
                  opacity_reset_interval=90, opacity_reset_mode="hard", chunk_size=8)
        trainers = (JTrainer(jorbit(2, resolution=32, images=frames), JConfig(**kw),
                             num_pts=20, capacity=40),
                    GSTrainer(orbit_cameras(2, resolution=32, images=frames),
                              GSTrainConfig(**kw), num_pts=20, capacity=40, device="cpu"))
        counter, runs = "step_count", [(37, 0), (170, 25), (3, 7)]
    else:
        trainers = pair("card", 1)
        for t in trainers:
            t.cfg = dataclasses.replace(t.cfg, dynamic_ray_sampling=False)
        counter, runs = "global_step", [(23, 0), (57, 10), (4, 3)]
    logs = []
    for t in trainers:
        calls, logged = [], []

        def chunk(n, _t=t, _calls=calls, **k):
            _calls.append(("chunk", getattr(_t, counter), n))
            setattr(_t, counter, getattr(_t, counter) + n)
            return {"loss": 0.0, "iter": getattr(_t, counter)}

        def step(*a, _t=t, _calls=calls, **k):
            _calls.append(("iter", getattr(_t, counter)))
            setattr(_t, counter, getattr(_t, counter) + 1)
            return {"loss": 0.0, "iter": getattr(_t, counter)}

        t.train_chunk, t.train_iter = chunk, step
        for n, every in runs:
            if kind == "gs":
                t.train(n, log_every=every, log_fn=lambda s, _l=logged, _t=t: _l.append(
                    getattr(_t, counter)))
            else:
                t.train(n, chunk=6, log_every=every,
                        log_fn=lambda s, _l=logged, _t=t: _l.append(getattr(_t, counter)))
        logs.append((calls, logged))
    (jcalls, jlogged), (pcalls, plogged) = logs
    assert pcalls == jcalls and plogged == jlogged
    assert any(c[0] == "chunk" for c in pcalls) and any(c[0] == "iter" for c in pcalls)


def test_neus_train_chunk_matches_jax():
    """Three steps as one chunk of both trainers from one state on the
    frequency / exact-gradient recipe (its frequency mask, cos anneal and
    learning rate change every step), the port on the draws of the JAX
    chunk's split keys; then the port's chunk against its own train_iter
    steps on the same draws, bit for bit."""
    jt, pt, ps = pair("card", 2)
    for t in (jt, pt, ps):
        t.cfg = dataclasses.replace(t.cfg, dynamic_ray_sampling=False)
    n, num_rays = 3, jt._quantized_rays()
    draws = chunk_draws(jt, n, num_rays)
    jstats = jt.train_chunk(n)
    pstats = pt.train_chunk(n, draws=draws)
    for d in draws:
        ps.train_iter(draws=d)
    assert set(pstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]), rtol=1e-4, atol=1e-8,
                                   err_msg=k)
    assert pt.global_step == jt.global_step == ps.global_step == n
    after, pstate = trainer_state_from_jax(jt.capture()), pt.capture()
    for group, params in after["params"].items():
        named = dict(pt.modules[group].named_parameters())
        lr = pt.base_lr[group]
        for name, want in params.items():
            ja, pa = after["adam"][group][name], pstate["adam"][group][name]
            assert pa["step"] == ja["step"] == n
            for m in ("exp_avg", "exp_avg_sq"):
                scale = np.abs(ja[m]).max()
                assert np.abs(pa[m].numpy() - ja[m]).max() <= 1e-3 * scale + 1e-12, (
                    group, name, m)
            err = np.abs(named[name].detach().numpy() - want).max()
            assert err <= 2 * n * lr + 1e-6, (group, name, err)
    for group, mod in pt.modules.items():
        for k, v in mod.state_dict().items():
            assert torch.equal(v, ps.modules[group].state_dict()[k]), (group, k)


def test_neus_train_chunk_needs_static_rays():
    jt, pt = pair("card", 1)
    with pytest.raises(AssertionError, match="static ray count"):
        pt.train_chunk(2)


def test_neus_step_inputs_reload_every_tensor():
    """A chunk's static inputs take each step's draws, schedule row and
    occupancy mask, the mask also when the grid changed it in place."""
    from v3d_tpu_torch.nerf.system import _StepInputs

    _, pt = pair("card", 1)
    inp = None
    for step in range(2):
        draws = pt.make_draws(pt._quantized_rays())
        row = pt._schedule_table([step])[0]
        inp = inp or _StepInputs(draws, row.shape[0], pt.occ.binary)
        inp.load(draws, row, pt.occ.binary)
        assert torch.equal(inp.sched, row) and torch.equal(inp.binary, pt.occ.binary)
        for got, want in zip(inp.draws, draws):
            assert (got is None and want is None) or torch.equal(got, want)
        pt.occ.binary.logical_not_()


def test_gs_save_load_round_trip(tmp_path):
    """save, load into a fresh trainer (another seed), and the next step is
    the original's bit for bit; f_rest at sh_degree 0 keeps its (cap, 0, 3)."""
    frames = _frames(n=2, res=32)
    cams = orbit_cameras(2, resolution=32, images=frames)
    cfg = GSTrainConfig(**CFG)
    a = GSTrainer(cams, cfg, num_pts=50, capacity=64, device="cpu")
    a.train_iter(0)
    a.train_iter(1)
    path = str(tmp_path / "gs_state.npz")
    a.save(path)
    b = GSTrainer(cams, cfg, num_pts=50, capacity=64, seed=5, device="cpu")
    b.load(path)
    assert b.params["f_rest"].shape == (64, 0, 3) and b.step_count == 2
    la, lb = a.train_iter(1)["loss"], b.train_iter(1)["loss"]
    assert float(la) == float(lb)
    for k in KEYS:
        assert torch.equal(a.params[k], b.params[k]), k
    for k in a.stats:
        assert torch.equal(a.stats[k], b.stats[k]), k


def test_neus_save_load_round_trip(tmp_path):
    """The same for the NeuS trainer: the generator is part of its state,
    so the next step draws the same rays."""
    _, a = pair("reference", 1)
    a.train_iter()
    path = str(tmp_path / "neus_state.npz")
    a.save(path)
    _, b = pair("reference", 1)
    b.gen.manual_seed(123)
    b.load(path)
    sa, sb = a.train_iter(), b.train_iter()
    assert set(sa) == set(sb)
    for k in sa:
        assert float(sa[k]) == float(sb[k]), k
    for group, mod in a.modules.items():
        for k, v in mod.state_dict().items():
            assert torch.equal(v, b.modules[group].state_dict()[k]), (group, k)
    assert torch.equal(a.occ.binary, b.occ.binary)


@pytest.mark.parametrize("name", ["clone", "split", "saturated", "screen"])
def test_host_densify_matches_jax(name):
    g, alive, grad_accum, denom, max_radii, max_screen = _densify_case(name)
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=2.0, max_screen_size=max_screen,
              percent_dense=0.01)
    outs = []
    for fn, state in ((jdensify_np, JDensifyState), (densify_and_prune_np, DensifyState)):
        g_np = {k: v.copy() for k, v in g.items()}
        g_np["alive"] = alive.copy()
        outs.append(fn(g_np, state(grad_accum.copy(), denom.copy(), max_radii.copy()),
                       np.random.RandomState(7), **kw))
    (jg, jstate, jstats), (pg, pstate, pstats) = outs
    assert pstats == jstats
    for k in list(KEYS) + ["alive"]:
        assert pg[k].dtype == jg[k].dtype
        np.testing.assert_array_equal(pg[k], jg[k], err_msg=k)
    np.testing.assert_array_equal(pstate.denom, jstate.denom)


def test_packed_ply_snapshot_and_log_images_bytes_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    g = {"xyz": rs.randn(10, 3), "f_dc": rs.randn(10, 1, 3), "f_rest": np.zeros((10, 0, 3)),
         "scaling": rs.randn(10, 3), "rotation": rs.randn(10, 4), "opacity": rs.randn(10, 1)}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    g["alive"] = np.arange(10) != 3
    jsave_packed_ply(str(tmp_path / "jax.ply"), g)
    save_packed_ply(str(tmp_path / "port.ply"), g)
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()

    for cfg_j, cfg_p in ((JConfig(iterations=7), GSTrainConfig(iterations=7)),
                         ({"lr": 1e-4, "data": "synthetic"}, {"lr": 1e-4, "data": "synthetic"})):
        jsnapshot_run(str(tmp_path / "j"), config=cfg_j)
        snapshot_run(str(tmp_path / "p"), config=cfg_p)
        for f in ("config.json", "git.txt"):
            assert ((tmp_path / "j" / "snapshot" / f).read_bytes()
                    == (tmp_path / "p" / "snapshot" / f).read_bytes()), f
    assert json.loads((tmp_path / "p" / "snapshot" / "config.json").read_text())["lr"] == 1e-4

    frames = (rs.rand(3, 8, 10, 3) * 255).astype(np.uint8)
    JLogger(str(tmp_path / "jl"), use_tensorboard=False).log_images("recon", frames, 12)
    ExperimentLogger(str(tmp_path / "pl")).log_images("recon", frames, 12)
    name = "recon_00000012.png"
    assert (tmp_path / "jl" / name).read_bytes() == (tmp_path / "pl" / name).read_bytes()


def test_full_asset_fits_from_its_mp4(tmp_path, monkeypatch):
    """C7: ``full_asset`` writes each generation as ``000000.mp4`` and both
    fits receive ``read_video`` of it (the tiny engine, cv2)."""
    pytest.importorskip("cv2")
    import chip_smoke
    from v3d_tpu_torch.apps import full_asset, recon_gs
    from v3d_tpu_torch.data.video_io import read_video
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    seen = {}
    fit = recon_gs.train_from_frames

    def gs_fit(frames, output, *a, **k):
        seen["gs"] = np.asarray(frames).copy()
        return fit(frames, output, *a, **k)

    def neus_fit(frames, output, **k):
        seen["neus"] = np.asarray(frames).copy()
        from v3d_tpu_torch.meshops.mesh import Mesh

        return None, Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)), {}

    monkeypatch.setattr(recon_gs, "train_from_frames", gs_fit)
    monkeypatch.setattr(full_asset, "reconstruct", neus_fit)
    out = tmp_path / "asset"
    full_asset.run(chip_smoke.synthetic_image(96), str(out), gs_iters=2, mesh=True,
                   num_steps=1, device="cpu", resolution=64,
                   engine=build_tiny_engine(num_frames=4, num_steps=1, device="cpu"),
                   gs_kwargs=dict(num_pts=30, capacity=48, test_every=2))
    video = read_video(str(out / "000000.mp4"))
    assert video.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(seen["gs"], video)
    np.testing.assert_array_equal(seen["neus"], video)
    assert not (out / "frames.npy").exists()
    assert sorted(os.listdir(out / "gs")) == ["orbit.npy", "point_cloud.ply", "snapshot",
                                             "spiral.mp4"]
    assert json.loads((out / "gs" / "snapshot" / "config.json").read_text())["iterations"] == 2


@pytest.mark.parametrize("zeros", [0, 1, 3])
def test_capture_safe_cumprod_gradient(zeros):
    """The renderer's cumprod (its backward reads nothing back to the host,
    so that a NeuS step can be captured) against torch.cumprod's autograd:
    values bit for bit, gradients bit for bit without zeros and within
    float64 rounding with rows holding ``zeros`` zeros."""
    from v3d_tpu_torch.nerf.renderer import _Cumprod

    gen = torch.Generator().manual_seed(zeros)
    x = torch.rand(6, 11, dtype=torch.float64, generator=gen) + 0.05
    for r in range(6):
        x[r, torch.randperm(11, generator=gen)[:zeros]] = 0.0
    x.requires_grad_(True)
    g = torch.randn(6, 11, dtype=torch.float64, generator=gen)
    want, = torch.autograd.grad((torch.cumprod(x, 1) * g).sum(), x)
    got, = torch.autograd.grad((_Cumprod.apply(x) * g).sum(), x)
    assert torch.equal(_Cumprod.apply(x), torch.cumprod(x, 1))
    if zeros:
        assert (got - want).abs().max() <= 1e-15
    else:
        assert torch.equal(got, want)


def test_step_graph_counts_each_step_once(monkeypatch):
    """``StepGraph`` with stand-ins for the CUDA stream and graph API: the
    warm-up steps run eagerly, the capture's own launches are taken back,
    each replay adds the captured step's; a failed capture raises (no
    eager fallback)."""
    import contextlib

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.ops.step_graph import StepGraph

    events = []

    class Graph:
        def replay(self):
            events.append("replay")

    @contextlib.contextmanager
    def capture(graph):
        events.append("capture")
        yield

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    out = torch.zeros(())

    def step():
        LAUNCHES["gs_composite_fwd"] += 1
        LAUNCHES["gs_composite_bwd"] += 2
        events.append("step")
        return out

    reset_launch_counts()
    try:
        graph = StepGraph("cuda", warmup=3)
        assert all(graph(step) is out for _ in range(7))
        # the capture records the step (here: runs it in Python) once
        assert events == ["step"] * 3 + ["capture", "step"] + ["replay"] * 4
        assert LAUNCHES["gs_composite_fwd"] == 7 and LAUNCHES["gs_composite_bwd"] == 14

        @contextlib.contextmanager
        def failing(graph):
            yield
            raise RuntimeError("operation not permitted when stream is capturing")

        monkeypatch.setattr(torch.cuda, "graph", failing)
        graph = StepGraph("cuda", warmup=0)
        with pytest.raises(RuntimeError, match="capturing"):
            graph(step)
        assert graph.graph is None
    finally:
        reset_launch_counts()
