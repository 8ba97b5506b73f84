"""Checkpoint loading (v3d_tpu_torch/core/checkpoint.py,
apps/validate_ckpt.py, the CLIs' ``--checkpoint``) against the JAX
package's ``load_v3d_params`` and ``check_conversion``, on the CPU.

A tiny engine's four modules (numpy-seeded weights) are written under the
sgm key prefixes as a Lightning-style ``.ckpt`` and as ``.safetensors``;
the JAX package and the port load the same file, and the UNet, the VAE
encoder and temporal decoder, and CLIP are run on the same inputs.

Tolerances: the loaded weights bit for bit (the JAX trees against the
port's modules through the JAX key maps); model outputs rtol 1e-5 with
atol 1e-5 of each output's largest magnitude (each framework sums its
convolutions and matmuls in its own order; a few float32 ulps of the
largest activation); the port's safetensors bytes equal to the package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    MAP_CLIP,
    MAP_ENCODER,
    MAP_UNET,
    MAP_VIDEO_DECODER,
    nchw,
    nhwc,
    numpy_init_,
    rand,
    t,
    to_flax,
)
from v3d_tpu.apps import validate_ckpt as jvalidate
from v3d_tpu.core import checkpoint as jckpt
from v3d_tpu.models import clip_vit as JC
from v3d_tpu.models import vae as JVAE
from v3d_tpu.models.video_unet import VideoUNet as JUNet
from v3d_tpu_torch.apps import validate_ckpt
from v3d_tpu_torch.core import checkpoint as ckpt
from v3d_tpu_torch.engines.builder import TINY_CLIP, TINY_UNET, build_tiny_engine

VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4)
MAPS = {"unet": MAP_UNET, "encoder": MAP_ENCODER, "decoder": MAP_VIDEO_DECODER,
        "clip": MAP_CLIP}


def _engine(seed):
    eng = build_tiny_engine(num_frames=4, device="cpu")
    for i, m in enumerate(ckpt.engine_modules(eng).values()):
        numpy_init_(m, seed + i)
    return eng


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    src = _engine(100)
    paths = {"ckpt": str(d / "tiny.ckpt"), "safetensors": str(d / "tiny.safetensors")}
    for p in paths.values():
        ckpt.save_v3d_checkpoint(src, p)
    return src, paths


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_file_loads_into_both_packages(files, fmt):
    src, paths = files
    jparams = jckpt.load_v3d_params(paths[fmt])
    port = _engine(7)                         # other weights, overwritten
    counts = ckpt.load_v3d_params(paths[fmt], port)
    mods = ckpt.engine_modules(port)
    for name, mod in mods.items():
        assert counts[name] == sum(p.numel() for p in mod.parameters())
        for key, val in mod.state_dict().items():     # bit for bit
            assert torch.equal(val, ckpt.engine_modules(src)[name].state_dict()[key])
        flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams[name])[0])
        flat_p = jax.tree_util.tree_flatten_with_path(to_flax(mod, MAPS[name]))[0]
        assert len(flat_j) == len(flat_p), name
        for path, leaf in flat_p:
            np.testing.assert_array_equal(np.asarray(flat_j[path]), leaf, err_msg=name)


def test_loaded_models_match_jax(files):
    """Both packages' models on the weights each loaded from the file."""
    _, paths = files
    jparams = jckpt.load_v3d_params(paths["safetensors"])
    port = _engine(7)
    ckpt.load_v3d_params(paths["safetensors"], port)
    tt, hw = 4, 8
    x, ts = rand((2 * tt, hw, hw, 8), 1), rand((2 * tt,), 2, 0.5)
    ctx, y = rand((2 * tt, 1, 64), 3), rand((2 * tt, 768), 4)
    ind = np.zeros((2, tt), np.float32)
    want = jax.jit(JUNet(model_channels=32, **TINY_UNET).apply,
                   static_argnames="num_video_frames")(
        jparams["unet"], jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        jnp.asarray(y), num_video_frames=tt, image_only_indicator=jnp.asarray(ind))
    with torch.no_grad():
        _close(nhwc(port.unet(nchw(x), t(ts), t(ctx), t(y), tt, t(ind))), want)
        img = rand((1, 64, 64, 3), 5)
        _close(nhwc(port.vae_encoder(nchw(img))),
               jax.jit(JVAE.Encoder(**VAE_KW).apply)(jparams["encoder"], jnp.asarray(img)))
        z = rand((tt, 4, 4, 4), 6)
        _close(nhwc(port.vae_decoder(nchw(z), tt)),
               jax.jit(JVAE.VideoDecoder(out_ch=3, num_frames=tt, **VAE_KW).apply)(
                   jparams["decoder"], jnp.asarray(z)))
        im = rand((1, 224, 224, 3), 7)
        _close(port.clip(nchw(im)).numpy(),
               jax.jit(JC.CLIPVisionTransformer(**TINY_CLIP).apply)(
                   jparams["clip"], jnp.asarray(im)))


def test_safetensors_bytes_match_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    rs = np.random.RandomState(0)
    tensors = {"b.w": torch.tensor(rs.randn(3, 5), dtype=torch.bfloat16),
               "a": torch.tensor(rs.randn(4, 2, 3), dtype=torch.float32),
               "c": torch.arange(7), "h": torch.tensor(rs.randn(6), dtype=torch.float16),
               "m": torch.tensor([True, False, True]), "e": torch.zeros(0, 3),
               "i": torch.arange(5, dtype=torch.int32), "d": torch.tensor(rs.randn(2),
                                                                          dtype=torch.float64)}
    for meta in (None, {"format": "pt"}):
        ckpt.write_safetensors(tensors, str(tmp_path / "port.safetensors"), meta)
        st.save_file(tensors, str(tmp_path / "pkg.safetensors"), metadata=meta)
        assert (tmp_path / "port.safetensors").read_bytes() == \
            (tmp_path / "pkg.safetensors").read_bytes()
        for reader in (ckpt.read_safetensors, st.load_file):
            back = reader(str(tmp_path / "port.safetensors"))
            assert set(back) == set(tensors)
            for k, v in tensors.items():
                assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_unknown_key_raises_and_both_clip_prefixes_load(files, tmp_path):
    src, paths = files
    sd = ckpt.load_torch_state_dict(paths["safetensors"])
    bad = dict(sd, **{"model.diffusion_model.not_a_layer.weight": torch.zeros(2)})
    torch.save({"state_dict": bad}, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError, match="not_a_layer"):
        ckpt.load_v3d_params(str(tmp_path / "bad.ckpt"), _engine(7))
    with pytest.raises(KeyError):                   # the JAX package agrees
        jckpt.load_v3d_params(str(tmp_path / "bad.ckpt"))
    old, new = "conditioner.embedders.0.open_clip.model.visual.", \
        "conditioner.embedders.0.model.visual."
    moved = {k.replace(old, new): v for k, v in sd.items()}
    moved["conditioner.embedders.0.model.transformer.ignored"] = torch.zeros(1)
    ckpt.write_safetensors(moved, str(tmp_path / "prefix.safetensors"))
    port = _engine(7)
    counts = ckpt.load_v3d_params(str(tmp_path / "prefix.safetensors"), port)
    assert "clip" in counts
    for k, v in port.clip.state_dict().items():
        assert torch.equal(v, src.clip.state_dict()[k]), k
    jclip = jckpt.load_v3d_params(str(tmp_path / "prefix.safetensors"))["clip"]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jclip)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(to_flax(port.clip, MAP_CLIP))[0]:
        np.testing.assert_array_equal(np.asarray(flat_j[path]), leaf)


def test_check_conversion_counts_match_jax(files):
    _, paths = files
    report = validate_ckpt.check_conversion(paths["ckpt"], engine=_engine(7))
    sd = jckpt.load_torch_state_dict(paths["ckpt"])
    parts = jckpt.split_svd_state_dict(sd)
    assert report["keys"] == len(sd)
    for name, sub in parts.items():
        assert report["parts"][name] == (
            len(sub), sum(int(np.prod(tuple(v.shape))) for v in sub.values())), name
    jparams = jvalidate.check_conversion(paths["ckpt"])
    assert set(report["loaded"]) == set(jparams)
    for name, tree in jparams.items():
        assert report["loaded"][name] == jvalidate._tree_count(tree), name


def test_cli_checkpoint_flags(files, tmp_path, monkeypatch):
    """``--checkpoint`` of generate (the tiny engine) loads the file: the
    frames equal those of the source engine's; train_diffusion's engine
    builder (here building the tiny topology) loads it too."""
    from PIL import Image

    from v3d_tpu_torch.apps import generate, train_diffusion

    src, paths = files
    rgba = np.zeros((48, 48, 4), np.uint8)
    rgba[8:40, 10:38] = (200, 120, 60, 255)
    Image.fromarray(rgba).save(tmp_path / "in.png")
    out = tmp_path / "gen"
    generate.main(["--input", str(tmp_path / "in.png"), "--checkpoint", paths["ckpt"],
                   "--tiny", "--num-frames", "4", "--num-steps", "3",
                   "--resolution", "64", "--decoding-t", "4", "--device", "cpu",
                   "--output-folder", str(out)])
    frames = np.stack([np.asarray(Image.open(p)) for p in sorted((out / "000000").iterdir())])
    want, _, _ = generate.sample_one(rgba, engine=src, resolution=64, decoding_t=4)
    np.testing.assert_array_equal(frames, want)
    monkeypatch.setattr(train_diffusion, "build_v3d_engine",
                        lambda num_frames, device, dtype, seed, unet_overrides:
                        build_tiny_engine(num_frames, device=device, dtype=dtype,
                                          unet_overrides=unet_overrides))
    eng = train_diffusion.build_train_engine(num_frames=4, device="cpu",
                                             checkpoint=paths["ckpt"])
    for k, v in eng.unet.state_dict().items():
        assert torch.equal(v, src.unet.state_dict()[k]), k
