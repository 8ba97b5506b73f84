"""The fine-tune CLI's data path against the JAX package's, on the CPU:

- ``_decode_orbit`` on RGB and RGBA PNGs that the test writes: equal to the
  JAX package's arrays (the alpha dropped, not composited);
- the PNG items of ``OrbitRenderDataset`` (equal, draws included, and the
  fall-back to item 0 for an unreadable object) and ``video_collate`` of
  nested ``pixelnerf_input`` fields;
- ``PrefetchIterator`` (order, the producer's exception at the failing item,
  ``close``) and ``device_prefetch`` on the CPU;
- the ``ExperimentLogger`` CSV, byte for byte;
- the encode on the way in: one PNG-orbit batch through ``prepare_batch`` on
  the tiny engine against the JAX CLI's arithmetic (train_diffusion.py:75-93)
  through the JAX engine's methods with the same key, whose two draws the
  test hands to the port (atol 5e-5 as the cond test of
  test_torch_train_engine.py: the sinusoids of the motion bucket; latents
  and CLIP rel 1e-5);
- ``train`` on PNG orbits with the prefetch at two depths and without it:
  the same steps (the encode noise is drawn on the consumer's thread in
  batch order), the ``metrics.csv`` rows; ``DiffusionTrainer.fit`` on host
  batches with and without its ``prefetch``: the same steps;
- C13 (reference-side): the training cond latent is scaled by scale_factor,
  inference's is not.
"""

import csv
import functools
import itertools
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from torch_port_helpers import MAP_CLIP, MAP_ENCODER, numpy_init_, to_flax
from v3d_tpu.data import objaverse as jdata
from v3d_tpu.engines.builder import build_tiny_engine as jax_tiny_engine
from v3d_tpu.models.clip_vit import clip_preprocess as jclip_preprocess
from v3d_tpu.utils.logging import ExperimentLogger as JLogger
from v3d_tpu_torch.apps import train_diffusion as app
from v3d_tpu_torch.data import objaverse as pdata
from v3d_tpu_torch.data import prefetch
from v3d_tpu_torch.data.prefetch import PrefetchIterator, device_prefetch
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
from v3d_tpu_torch.utils.logging import ExperimentLogger

T = 4


def _write_orbits(root, n_obj=2, hw=64, channels=(4, 3), seed=0):
    """Objects of T noise frames; object o's frames have channels[o % 2]."""
    rs = np.random.RandomState(seed)
    for o in range(n_obj):
        d = root / f"obj{o}"
        d.mkdir()
        for i in range(T):
            arr = rs.randint(0, 256, (hw, hw, channels[o % len(channels)]), np.uint8)
            Image.fromarray(arr).save(d / f"{i:03d}.png")
    return root


def test_decode_orbit_equals_jax(tmp_path):
    _write_orbits(tmp_path)
    for obj in ("obj0", "obj1"):
        pngs = sorted(str(p) for p in (tmp_path / obj).glob("*.png"))
        got = pdata._decode_orbit(pngs)
        ref = jdata._decode_orbit(pngs)
        assert got.dtype == np.float32 and got.shape == (T, 64, 64, 3)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[0], np.asarray(Image.open(pngs[0]))[..., :3])


def test_png_items_and_fallback_equal_jax(tmp_path):
    """PNG items (pixels in [-1, 1], the noised front view, a clip_emb.npy
    where there is one) equal the JAX dataset's, draws included; an object
    with a truncated PNG falls back to item 0 on both sides; shuffled
    batches of them equal too."""
    _write_orbits(tmp_path, n_obj=3)
    (tmp_path / "obj2" / "001.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    emb = tmp_path / "obj1" / "clip_emb.npy"
    np.save(emb, np.ones((1, 8), np.float32))

    def datasets():
        return (jdata.OrbitRenderDataset(str(tmp_path), jdata.OrbitItemConfig(num_frames=T),
                                         seed=4),
                pdata.OrbitRenderDataset(str(tmp_path), pdata.OrbitItemConfig(num_frames=T),
                                         seed=4))

    jds, pds = datasets()
    for i in (0, 1, 2, 1):
        ji, pi = jds[i], pds[i]
        assert ji.keys() == pi.keys()
        for k in ji:
            np.testing.assert_array_equal(np.asarray(pi[k]), np.asarray(ji[k]), err_msg=k)
    assert pds[1]["cond_frames_without_noise"].shape == (1, 8)
    np.testing.assert_array_equal(pds[2]["frames"], pds[0]["frames"])
    emb.unlink()
    jds, pds = datasets()
    jit, pit = jds.iter_batches(2), pds.iter_batches(2)
    for _ in range(3):
        jb, pb = next(jit), next(pit)
        assert jb.keys() == pb.keys()
        for k in jb:
            np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(jb[k]), err_msg=k)
    assert pb["frames"].min() >= -1 and pb["frames"].max() <= 1


def test_video_collate_pixelnerf_input_equals_jax():
    rs = np.random.RandomState(1)
    items = [{"latents": rs.randn(T, 2, 2, 4), "num_video_frames": T,
              "pixelnerf_input": {"rgb": rs.randn(T, 8, 8, 3), "frames": rs.randn(1, 4),
                                  "cameras": {"K": rs.randn(3, 3)}, "id": f"o{i}"}}
             for i in range(2)]
    got, ref = pdata.video_collate(items), jdata.video_collate(items)
    assert got["pixelnerf_input"]["rgb"].shape == (2 * T, 8, 8, 3)
    assert got["pixelnerf_input"]["id"] == ref["pixelnerf_input"]["id"] == ["o0", "o1"]
    for k in ("rgb", "frames"):
        np.testing.assert_array_equal(got["pixelnerf_input"][k], ref["pixelnerf_input"][k])
    np.testing.assert_array_equal(got["pixelnerf_input"]["cameras"]["K"],
                                  ref["pixelnerf_input"]["cameras"]["K"])


def test_prefetch_iterator_order_error_and_close():
    assert list(PrefetchIterator(iter(range(10)), depth=2)) == list(range(10))

    def failing():
        yield from range(3)
        raise ValueError("item 3")

    it = PrefetchIterator(failing(), depth=1)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="item 3"):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    for depth in (1, 2):   # at depth 1 the producer's last put finds a full queue
        it = PrefetchIterator(endless(), depth=depth)
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        time.sleep(0.05)   # the producer fills the queue and blocks in put()
        it.close()
        it._thread.join(timeout=10)
        assert not it._thread.is_alive(), depth


def test_device_prefetch_on_cpu():
    """Nested batches come out in order as tensors on the device (ints and
    strings as they were), whatever the depth; a consumer that stops early
    stops the producer."""
    batches = [{"x": np.full((2, 3), i, np.float32), "n": i, "s": "a",
                "d": {"y": np.arange(i + 1)}} for i in range(5)]
    for depth in (1, 3):
        out = list(device_prefetch(iter(batches), depth=depth, device="cpu"))
        assert [b["n"] for b in out] == list(range(5))
        for b, ref in zip(out, batches):
            assert isinstance(b["x"], torch.Tensor) and b["s"] == "a"
            np.testing.assert_array_equal(b["x"].numpy(), ref["x"])
            np.testing.assert_array_equal(b["d"]["y"].numpy(), ref["d"]["y"])
    before = threading.active_count()
    gen = device_prefetch(iter(range(10 ** 9)), device="cpu")
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_experiment_logger_csv_equals_jax(tmp_path):
    rows = [({"loss": 0.5, "grad_norm": 1.25, "note": "x", "flag": True}, 1),
            ({"loss": np.float64(0.25), "extra": 3, "grad_norm": 2}, 2),
            ({"grad_norm": 0.125, "arr": np.float32(1.0)}, None)]
    for logger, d in ((JLogger(str(tmp_path / "jax"), use_tensorboard=False), "jax"),
                      (ExperimentLogger(str(tmp_path / "port")), "port")):
        for metrics, step in rows:
            logger.log(metrics, step if step is not None else 7)
    assert ((tmp_path / "port" / "metrics.csv").read_bytes()
            == (tmp_path / "jax" / "metrics.csv").read_bytes())


@pytest.fixture(scope="module")
def engines():
    """The tiny engine (encoder and CLIP filled by numpy_init_) and the JAX
    tiny engine with the same weights."""
    engine = build_tiny_engine(num_frames=T, device="cpu")
    numpy_init_(engine.vae_encoder, 21)
    numpy_init_(engine.clip, 22)
    params = {"encoder": to_flax(engine.vae_encoder, MAP_ENCODER),
              "clip": to_flax(engine.clip, MAP_CLIP)}
    return engine, jax_tiny_engine(num_frames=T, resolution=64), params


def test_png_batch_encoded_on_the_way_in_matches_jax_cli(engines, tmp_path, monkeypatch):
    engine, jengine, params = engines
    _write_orbits(tmp_path)
    jb = next(jdata.OrbitRenderDataset(str(tmp_path), jdata.OrbitItemConfig(
        num_frames=T)).iter_batches(1))
    pb = next(pdata.OrbitRenderDataset(str(tmp_path), pdata.OrbitItemConfig(
        num_frames=T)).iter_batches(1))
    # the JAX CLI's batches(): one key for both encodes, CLIP of the pixels
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    jb["latents"] = np.asarray(jengine.encode_first_stage(params, jnp.asarray(jb["frames"]), sub))
    jb["cond_frames"] = np.asarray(jengine.encode_first_stage(
        params, jnp.asarray(jb["cond_frames"]), sub))
    emb = jengine.clip.apply(params["clip"], jclip_preprocess(
        jnp.asarray(jb["cond_frames_without_noise"])))
    jb["cond_frames_without_noise"] = np.asarray(emb)[:, None]
    jcond = jengine.training_cond(jb, num_frames=T)
    draws = [torch.from_numpy(np.array(jax.random.normal(sub, shape)))
             for shape in ((T, 8, 8, 4), (1, 8, 8, 4))]
    encode = engine.encode_first_stage
    monkeypatch.setattr(engine, "encode_first_stage",
                        lambda frames, generator=None: encode(frames, noise=draws.pop(0)))
    got = app.prepare_batch(engine, pb, T, generator=torch.Generator().manual_seed(0))
    assert draws == []
    lat = got["latents"].numpy()
    np.testing.assert_allclose(lat, jb["latents"], rtol=0,
                               atol=1e-5 * np.abs(jb["latents"]).max())
    assert jcond.keys() == got["cond"].keys()
    for k in jcond:
        np.testing.assert_allclose(got["cond"][k].numpy(), np.asarray(jcond[k]),
                                   rtol=1e-5, atol=5e-5, err_msg=k)


def test_training_cond_latent_is_scaled_reference_side(engines):
    """C13: the JAX CLI's cond latent comes from ``encode_first_stage``,
    which multiplies by scale_factor (video_diffusion.py:195-201); inference
    takes ``encode_image``'s unscaled sample (:76-79).  Same image, same
    encoder draw, cond_aug 0: training = 0.18215 x inference, on both
    sides."""
    engine, jengine, params = engines
    img = np.random.RandomState(3).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    rng_enc, _ = jax.random.split(key)
    train_z = jengine.encode_first_stage(params, jnp.asarray(img), rng_enc)
    _, infer_z = jengine.encode_image(params, jnp.asarray(img), key, 0.0)
    np.testing.assert_allclose(np.asarray(train_z), 0.18215 * np.asarray(infer_z), rtol=1e-5,
                               atol=1e-6)
    noise = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(5))
    p_train = engine.encode_first_stage(torch.from_numpy(img), noise=noise)
    _, p_infer = engine.encode_image(torch.from_numpy(img), 0.0, enc_noise=noise,
                                     aug_noise=torch.zeros_like(noise))
    np.testing.assert_allclose(p_train.numpy(), engine.scale_factor * p_infer.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_train_on_png_orbits_prefetch_and_log_dir(tmp_path, monkeypatch):
    """``train`` on a directory of PNG orbits on the tiny engine: with the
    prefetch at depths 1 and 3 and without it the same losses (the draws do
    not depend on the prefetch), and ``<log_dir>/metrics.csv`` holds each
    logged step; no batch is encoded past the last step.  Then
    ``DiffusionTrainer.fit`` on those batches held on the host: with and
    without its ``prefetch`` the same losses."""
    (tmp_path / "orbits").mkdir()
    data = _write_orbits(tmp_path / "orbits")
    runs, prepared, prepare = {}, [], app.prepare_batch
    monkeypatch.setattr(app, "prepare_batch",
                        lambda *a, **k: prepared.append(1) or prepare(*a, **k))
    for name, put in (("depth1", functools.partial(device_prefetch, depth=1)),
                      ("depth3", functools.partial(device_prefetch, depth=3)),
                      ("off", lambda it, device: it)):
        monkeypatch.setattr(app, "device_prefetch", put)
        stats = []
        app.train(str(data), num_frames=T, max_steps=2, log_every=1,
                  engine=build_tiny_engine(num_frames=T, device="cpu"), log_fn=stats.append,
                  log_dir=str(tmp_path / f"logs_{name}"))
        runs[name] = [s["loss"] for s in stats]
    assert runs["depth1"] == runs["depth3"] == runs["off"] and len(runs["off"]) == 2
    assert len(prepared) == 3 * 2   # no batch encoded past the last step
    with open(tmp_path / "logs_depth1" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2]
    assert float(rows[0]["loss"]) == pytest.approx(runs["depth1"][0])

    engine = build_tiny_engine(num_frames=T, device="cpu")
    host = [prefetch._tree_map(lambda x: x.numpy(), b) for b in itertools.islice(
        app.batches(engine, pdata.OrbitRenderDataset(str(data), pdata.OrbitItemConfig(
            num_frames=T)), 1, T), 2)]
    fits = {}
    for on in (True, False):
        stats, trainer = [], DiffusionTrainer(build_tiny_engine(num_frames=T, device="cpu"),
                                              TrainConfig(log_every=1), num_frames=T)
        # off: the same batches as tensors (_tree_map takes arrays to tensors)
        batches = iter(host) if on else (prefetch._tree_map(lambda x: x, b) for b in host)
        trainer.fit(batches, max_steps=2, log_fn=stats.append, prefetch=on)
        fits[on] = [s["loss"] for s in stats]
    assert fits[True] == fits[False] and len(fits[True]) == 2
