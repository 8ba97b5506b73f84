"""The port's copy of the checkpoint key maps (v3d_tpu_torch/core/keymap.py)
against the JAX package's (v3d_tpu/core/convert.py): for every key of the
port's VideoUNet, VAE Encoder, VideoDecoder and CLIP vision tower (tiny
widths), both maps give the same Flax path and the same transformed array
(exactly: the same numpy transposes)."""

import numpy as np
import pytest

from v3d_tpu.core import convert as jc
from v3d_tpu_torch.core import keymap
from v3d_tpu_torch.engines.builder import build_tiny_engine

MAPS = {
    "unet": ("unet", keymap.convert_unet_key, jc._convert_unet_key),
    "vae_encoder": ("vae_encoder", lambda k: keymap.convert_vae_key(k, False),
                    lambda k: jc._convert_vae_key(k, False)),
    "vae_video_decoder": ("vae_decoder", lambda k: keymap.convert_vae_key(k, True),
                          lambda k: jc._convert_vae_key(k, True)),
    "clip": ("clip", keymap.convert_clip_key, jc._convert_clip_key),
}


@pytest.fixture(scope="module")
def engine():
    return build_tiny_engine(num_frames=4, num_steps=1, device="cpu")


@pytest.mark.parametrize("kind", sorted(MAPS))
def test_key_map_copy_matches_jax(engine, kind):
    attr, port_map, jax_map = MAPS[kind]
    state = getattr(engine, attr).state_dict()
    assert len(state) > 10
    for key, val in state.items():
        ours, ref = port_map(key), jax_map(key)
        assert ref is not None and ours is not None, key
        assert ours[0] == ref[0], key
        a, b = ours[1](val), ref[1](val)
        assert a.shape == b.shape and np.array_equal(a, b), key


def test_key_maps_refuse_unknown_keys():
    assert keymap.convert_unet_key("nonsense.weight") is None
    assert keymap.convert_vae_key("encoder.nope", False) is None
    assert keymap.convert_clip_key("transformer.resblocks.0.nope") is None
