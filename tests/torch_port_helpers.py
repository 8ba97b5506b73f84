"""Shared helpers for the v3d_tpu_torch parity tests (tests/test_torch_*.py).

Each parity test builds a port module, overwrites every parameter with
seeded numpy normals scaled by 1/sqrt(fan_in) (``numpy_init_``; the JAX init
zeroes the layers that carry the kernels' output, so parity at that init
would test nothing past them), converts the port's ``state_dict()`` to a Flax
tree with ``v3d_tpu.core.convert``'s key maps, and runs both packages on the
same numpy inputs in float32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from v3d_tpu.core import convert as jc
from v3d_tpu_torch.engines.builder import init_std

torch.set_num_threads(1)


@torch.no_grad()
def numpy_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter from one numpy RandomState, with the port's
    init_std rule (weights N(0, 1/fan_in), norm scales 1 + N(0, 0.01),
    other vectors N(0, 0.01))."""
    rng = np.random.RandomState(seed)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            mean, std = init_std(mod, name, p)
            p.copy_(torch.from_numpy(
                rng.normal(mean, std, tuple(p.shape)).astype(np.float32)))
    return module.eval()


def to_flax(module: torch.nn.Module, key_map) -> dict:
    """The module's state dict as a Flax variable dict, through the JAX
    package's own torch -> Flax key map (``key -> (path, transform)``)."""
    tree: dict = {}
    for key, val in module.state_dict().items():
        mapped = key_map(key)
        assert mapped is not None, f"no Flax path for {key}"
        path, fn = mapped
        jc._set(tree, path, fn(val))
    return {"params": tree}


def rand(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last torch (the port's feature layout)."""
    return t(x).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def video_nhwc(x: torch.Tensor) -> np.ndarray:
    """(b, c, t, h, w) -> (b, t, h, w, c) numpy."""
    return x.permute(0, 2, 3, 4, 1).detach().numpy()


# key maps for sub-modules, from the JAX package's converter pieces
MAP_CROSS_ATTN = lambda k: jc._map_cross_attention(k, ())  # noqa: E731
MAP_FF = lambda k: jc._map_feedforward(k, ())  # noqa: E731
MAP_BLOCK = lambda k: jc._map_transformer_block(k, ())  # noqa: E731
MAP_SVT = lambda k: jc._map_spatial_video_transformer(k, ())  # noqa: E731
MAP_VRES = lambda k: jc._map_video_resblock(k, ())  # noqa: E731
MAP_UNET = jc._convert_unet_key
MAP_ENCODER = lambda k: jc._convert_vae_key(k, False)  # noqa: E731
MAP_VIDEO_DECODER = lambda k: jc._convert_vae_key(k, True)  # noqa: E731
MAP_CLIP = jc._convert_clip_key


def map_resblock(dims: int):
    return lambda k: jc._map_plain_resblock(k, (), dims)
