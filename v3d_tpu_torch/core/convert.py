"""Weight bridge to the JAX package's Flax param trees.

``v3d_tpu.core.convert`` maps each checkpoint (torch) key to a Flax path and
a transform (convert.py: ``_convert_unet_key`` :216, ``_convert_vae_key``
:290, ``_convert_clip_key`` :374).  The port names its parameters exactly as
the checkpoint does, so that map applies to ``module.state_dict()`` as it is.
``state_dict_from_jax`` walks the port module's own keys, asks the map for
each key's Flax path and transform, and inverts the transform.

Only this function touches the JAX package, importing its numpy-only
converter lazily; nothing on the generation path calls it.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

KINDS = ("unet", "vae_encoder", "vae_video_decoder", "clip")


def _key_map(kind: str) -> Callable[[str], Tuple]:
    from v3d_tpu.core import convert as jc

    maps = {
        "unet": jc._convert_unet_key,
        "vae_encoder": lambda k: jc._convert_vae_key(k, False),
        "vae_video_decoder": lambda k: jc._convert_vae_key(k, True),
        "clip": jc._convert_clip_key,
    }
    if kind not in maps:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return maps[kind]


def _inverse(fn: Callable) -> Callable[[np.ndarray], np.ndarray]:
    from v3d_tpu.core import convert as jc

    inverses = {
        jc._linear_w: lambda a: a.T,
        jc._conv2_w: lambda a: a.transpose(3, 2, 0, 1),
        jc._conv3_w: lambda a: a.transpose(4, 3, 0, 1, 2),
        jc._conv1x1_to_dense: lambda a: a.T[:, :, None, None],
        jc.t2j: lambda a: a,
    }
    if fn not in inverses:
        raise KeyError(f"no inverse for transform {fn}")
    return inverses[fn]


def state_dict_from_jax(flax_params: Mapping, kind: str,
                        module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Flax params (numpy leaves, with or without the top "params" level) ->
    a state dict for ``module`` (one of VideoUNet, Encoder, VideoDecoder,
    CLIPVisionTransformer, as ``kind`` says), float32 on the CPU.  Raises
    on a key the map does not know, a missing leaf or a shape mismatch."""
    key_map = _key_map(kind)
    tree = flax_params.get("params", flax_params)
    out = {}
    for key, ref in module.state_dict().items():
        mapped = key_map(key)
        if mapped is None:
            raise KeyError(f"{kind}: no Flax path for {key!r}")
        path, fn = mapped
        leaf = tree
        for p in path:
            leaf = leaf[p]
        arr = _inverse(fn)(np.asarray(leaf, dtype=np.float32))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{kind}: {key} is {arr.shape} from Flax, "
                             f"{tuple(ref.shape)} in the port")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
