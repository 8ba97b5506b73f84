"""Weight bridges from the JAX package's trees to the port.

- ``state_dict_from_jax``: a Flax param tree -> the state dict of a port
  module.  The port names its parameters exactly as the checkpoint does, so
  the checkpoint key maps (``core/keymap.py``, a copy of the JAX package's)
  apply to ``module.state_dict()`` as it is: each key is mapped to its Flax
  path and transform, and the transform is inverted.
- ``gaussians_from_jax``: a ``GaussianParams`` (numpy or device arrays) ->
  the port's ``Gaussians``.
- ``trainer_state_from_jax``: ``GSTrainer.capture()`` of the JAX package ->
  the state that ``v3d_tpu_torch.gs.trainer.GSTrainer.restore`` takes.

Nothing here imports the JAX package: the trees arrive as objects whose
leaves ``np.asarray`` reads.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from v3d_tpu_torch.core import keymap

KINDS = ("unet", "vae_encoder", "vae_video_decoder", "clip")

KEY_MAPS = {
    "unet": keymap.convert_unet_key,
    "vae_encoder": lambda k: keymap.convert_vae_key(k, False),
    "vae_video_decoder": lambda k: keymap.convert_vae_key(k, True),
    "clip": keymap.convert_clip_key,
}

_INVERSES = {
    keymap.linear_w: lambda a: a.T,
    keymap.conv2_w: lambda a: a.transpose(3, 2, 0, 1),
    keymap.conv3_w: lambda a: a.transpose(4, 3, 0, 1, 2),
    keymap.conv1x1_to_dense: lambda a: a.T[:, :, None, None],
    keymap.t2j: lambda a: a,
}


def _key_map(kind: str) -> Callable[[str], Tuple]:
    if kind not in KEY_MAPS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return KEY_MAPS[kind]


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
        arr = _INVERSES[fn](np.asarray(leaf, dtype=np.float32))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{kind}: {key} is {arr.shape} from Flax, "
                             f"{tuple(ref.shape)} in the port")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def gaussians_from_jax(g, device="cpu"):
    """A JAX ``GaussianParams`` (any array leaves) -> the port's
    ``Gaussians`` on ``device``."""
    from v3d_tpu_torch.gs.gaussians import FLOAT_FIELDS, Gaussians

    dev = torch.device(device)
    fields = {k: torch.tensor(np.asarray(getattr(g, k), np.float32), device=dev)
              for k in FLOAT_FIELDS}
    return Gaussians(alive=torch.tensor(np.asarray(g.alive, bool), device=dev),
                     **fields)


def _adam_states(tree):
    """Every optax ``ScaleByAdamState`` (duck-typed: ``mu``, ``nu``,
    ``count``) inside an optax state tree of tuples, named tuples and dicts."""
    if hasattr(tree, "mu") and hasattr(tree, "nu") and hasattr(tree, "count"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _adam_states(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _adam_states(v)


def trainer_state_from_jax(capture: Mapping) -> Dict:
    """The JAX ``GSTrainer.capture()`` (params, the optax multi-transform
    state, stats, alive, step) -> the numpy state that the port's
    ``GSTrainer.restore`` takes: per field its param and Adam ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` (optax's mu / nu / count)."""
    params = {k: np.asarray(v, np.float32) for k, v in capture["params"].items()}
    adam = {}
    for state in _adam_states(capture["opt_state"]):
        for k, mu in state.mu.items():
            if hasattr(mu, "shape"):   # the other fields are optax MaskedNodes
                adam[k] = {"exp_avg": np.asarray(mu, np.float32),
                           "exp_avg_sq": np.asarray(state.nu[k], np.float32),
                           "step": int(np.asarray(state.count))}
    missing = set(params) - set(adam)
    if missing:
        raise KeyError(f"no Adam state for {sorted(missing)}")
    return {"params": params, "adam": adam,
            "stats": {k: np.asarray(v, np.float32)
                      for k, v in capture["stats"].items()},
            "alive": np.asarray(capture["alive"], bool),
            "step": int(capture["step"])}
