"""The port's YAML configs, registry and ``engine_from_config``
(v3d_tpu_torch/core/{config,registry}.py, engines/from_config.py) against
the JAX package's: the same parsed configs and overrides, the same 39
registry names, a dotted ``v3d_tpu.`` target refused without importing
anything, and the V3D-512 engine of configs/v3d_512.yaml held to every
assertion of tests/test_from_config.py (full width, meta device), equal in
modules, parameter names and shapes to ``build_v3d_engine``'s; a
tiny-width override's UNet forward against the JAX engine's (f32, rel <=
1e-5)."""

import functools
import importlib
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import v3d_tpu.core.registry as jreg
import v3d_tpu.engines.from_config  # noqa: F401  (fills the JAX registry)
import v3d_tpu.models.regularizers  # noqa: F401
from test_torch_unet2d import plain_everywhere, randomize, rel
from torch_port_helpers import nchw, nhwc, rand, t
from v3d_tpu.core import config as jcfg
from v3d_tpu.engines.from_config import engine_from_config as jax_engine_from_config
from v3d_tpu_torch.core import config as pcfg
from v3d_tpu_torch.core import registry as preg
from v3d_tpu_torch.core.convert import state_dict_from_jax
from v3d_tpu_torch.engines.builder import build_v3d_engine, materialise
from v3d_tpu_torch.engines.from_config import engine_from_config
from v3d_tpu_torch.models.video_unet import VideoUNet

YAML = "configs/v3d_512.yaml"
OVERRIDES = [
    "model.sampler.params.num_steps=25", "model.num_frames=8", "training.base_learning_rate=3e-5",
    "a.new.branch=[1, 2]", "model.denoiser.params.scaling.target=v_scaling", "x=yes",
]


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
def test_load_config_matches_jax(overrides, tmp_path):
    """The same parsed tree (YAML-1.1 "3e-5" recovered as a float, new
    branches created), attribute access, and ``save_config`` round trips."""
    ours, ref = pcfg.load_config(YAML, overrides), jcfg.load_config(YAML, overrides)
    assert ours.to_dict() == ref.to_dict()
    if overrides:
        assert ours.training.base_learning_rate == 3e-5
        assert ours.a.new.branch == [1, 2] and ours.x is True
    pcfg.save_config(ours, tmp_path / "c.yaml")
    assert pcfg.load_config(tmp_path / "c.yaml").to_dict() == ours.to_dict()
    with pytest.raises(ValueError):
        pcfg.make_config({}, ["no_equals_sign"])
    with pytest.raises(AttributeError):
        ours.nope  # noqa: B018


def test_registry_names_match_jax():
    assert preg.names() == jreg.names()
    assert len(preg.names()) == 39
    assert preg.resolve("unet2d").__module__ == "v3d_tpu_torch.models.unet2d"
    assert preg.resolve("v3d_tpu_torch.models.unet2d.UNetModel") is preg.resolve("unet2d")
    with pytest.raises(KeyError):
        preg.resolve("no_such_component")


def test_registry_refuses_jax_package_targets(monkeypatch):
    """A dotted target outside v3d_tpu_torch raises before any import."""
    imported = []
    monkeypatch.setattr(importlib, "import_module", lambda name: imported.append(name))
    for target in ("v3d_tpu.models.unet2d.UNetModel", "jax.numpy.zeros", "os.system"):
        with pytest.raises(ValueError):
            preg.resolve(target)
        with pytest.raises(ValueError):
            preg.instantiate({"target": target})
    assert imported == []


def test_registry_instantiates_nested_configs():
    s = preg.instantiate({"target": "euler_edm_sampler", "params": {
        "num_steps": 4, "discretization": {"target": "edm_discretization",
                                           "params": {"sigma_max": 70.0}},
        "guider": {"target": "vanilla_cfg", "params": {"scale": 2.0}}}})
    assert s.num_steps == 4 and s.discretization.sigma_max == 70.0 and s.guider.scale == 2.0
    with pytest.raises(ValueError):
        preg.register("unet2d")(object)


def test_fixed_fields_refuse_other_values():
    """The JAX module fields the port builds at V3D's values only."""
    with torch.device("meta"):
        VideoUNet(video_kernel_size=[3, 1, 1], merge_strategy="learned_with_images")
        for bad in (dict(video_kernel_size=[5, 1, 1]), dict(extra_ff_mix_layer=False),
                    dict(merge_strategy="fixed")):
            with pytest.raises(ValueError):
                VideoUNet(**bad)
        with pytest.raises(TypeError):
            VideoUNet(not_a_field=1)
        with pytest.raises(ValueError):
            preg.instantiate({"target": "video_decoder",
                              "params": {"video_kernel_size": [1, 1, 1]}})


@pytest.fixture(scope="module")
def meta_engine():
    return engine_from_config(pcfg.load_config(YAML), device="meta")


def test_v3d_512_config_builds(meta_engine, monkeypatch):
    """Every assertion of tests/test_from_config.py::test_v3d_512_config_builds
    (the JAX ``vae_decoder_ctor(6).num_frames == 6``: the port's decoder
    takes the frame count per call, so 6 frames decode on the meta device)."""
    engine = meta_engine
    assert engine.num_frames == 18
    assert engine.scale_factor == 0.18215
    assert engine.sampler.num_steps == 30
    assert engine.sampler.discretization.sigma_max == 700.0
    assert engine.sampler.guider.max_scale == 3.5
    assert engine.unet.model_channels == 320
    assert engine.unet.use_checkpoint
    assert engine.loss_fn.sigma_sampler.p_mean == 1.5
    cond = engine.conditioner()
    keys = [s.input_key for s in cond.embedders]
    assert keys == ["cond_frames_without_noise", "fps_id",
                    "motion_bucket_id", "cond_frames", "cond_aug"]
    assert cond.embedders[0].ucg_rate == 0.2
    plain_everywhere(monkeypatch)
    z = torch.empty(6, 4, 8, 8, device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        assert engine.vae_decoder(z, 6).shape == (6, 3, 64, 64)


def test_config_engine_equals_builder(meta_engine):
    """Same modules, parameter names, shapes and dtypes as
    ``build_v3d_engine`` (the config's sampler has 30 steps, the builder's
    25; checkpoints load into either)."""
    ref = build_v3d_engine(device="meta", dtype=torch.bfloat16)
    for name in ("unet", "vae_encoder", "vae_decoder", "clip"):
        a, b = getattr(meta_engine, name).state_dict(), getattr(ref, name).state_dict()
        assert list(a) == list(b), name
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a), name
        assert type(getattr(meta_engine, name)) is type(getattr(ref, name))
    assert type(meta_engine.denoiser.scaling) is type(ref.denoiser.scaling)
    assert meta_engine.loss_fn == ref.loss_fn
    assert ref.sampler.num_steps == 25


def test_config_overrides_apply():
    cfg = pcfg.load_config(YAML, overrides=["model.sampler.params.num_steps=25",
                                            "model.num_frames=8"])
    engine = engine_from_config(cfg, device="meta")
    assert engine.sampler.num_steps == 25
    assert engine.num_frames == 8


TINY_OVERRIDES = [
    "model.network.params.model_channels=32", "model.network.params.num_res_blocks=1",
    "model.network.params.attention_resolutions=[1]",
    "model.network.params.channel_mult=[1]", "model.network.params.num_head_channels=16",
    "model.network.params.context_dim=64",
    "model.first_stage.encoder.params.ch=32", "model.first_stage.decoder.params.ch=32",
    "model.num_frames=4", "model.sampler.params.guider.params.num_frames=4",
]


def test_tiny_config_unet_matches_jax_engine():
    """A tiny-width override of the YAML through both packages'
    ``engine_from_config``; one UNet forward on the same weights (the JAX
    tree seeded, carried over by ``state_dict_from_jax``)."""
    cfg = pcfg.load_config(YAML, TINY_OVERRIDES)
    jeng = jax_engine_from_config(jcfg.load_config(YAML, TINY_OVERRIDES), dtype=jnp.float32)
    # built on the meta device (the config's CLIP is ViT-H/14); only the
    # UNet gets storage, then the JAX weights
    peng = engine_from_config(cfg, dtype=torch.float32, device="meta")
    peng.unet = materialise(peng.unet, "cpu", torch.float32, 0)
    T = 4
    x, ts = rand((T, 8, 8, 8), 0), np.linspace(0.1, 3.0, T).astype(np.float32)
    ctx, y = rand((T, 1, 64), 1), rand((T, 768), 2)
    ind = np.zeros((1, T), np.float32)
    params = randomize(jax.eval_shape(functools.partial(
        jeng.unet.init, num_video_frames=T, image_only_indicator=ind),
        jax.random.PRNGKey(0), x, ts, ctx, y), 3)
    peng.unet.load_state_dict(state_dict_from_jax(params, "unet", peng.unet))
    want = np.asarray(jax.jit(functools.partial(jeng.unet.apply, num_video_frames=T))(
        params, x, ts, ctx, y, image_only_indicator=ind))
    with torch.no_grad():
        got = nhwc(peng.unet(nchw(x), t(ts), t(ctx), t(y), T, t(ind)))
    assert rel(got, want) <= 1e-5
    assert peng.sampler.guider.num_frames == jeng.sampler.guider.num_frames == T


def test_from_config_imports_no_jax_package():
    """The port's config modules find no ``jax`` / ``v3d_tpu`` name in
    their source imports (the subprocess check is test_torch_imports.py)."""
    for name in ("v3d_tpu_torch.core.config", "v3d_tpu_torch.core.registry",
                 "v3d_tpu_torch.engines.from_config"):
        src = open(importlib.util.find_spec(name).origin).read()
        assert "import jax" not in src and "from v3d_tpu." not in src and \
            "import v3d_tpu\n" not in src, name
