"""Weight bridges from the JAX package's trees to the port.

- ``state_dict_from_jax``: a Flax param tree -> the state dict of a port
  module (``ae_trainer_state_from_jax``: the three modules of an
  autoencoder trainer).  The port names its parameters exactly as the
  checkpoint does, so the checkpoint key maps (``core/keymap.py``, a copy
  of the JAX package's) apply to ``module.state_dict()`` as it is: each key
  is mapped to its Flax path and transform, and the transform is inverted.
- ``gaussians_from_jax``: a ``GaussianParams`` (numpy or device arrays) ->
  the port's ``Gaussians``.
- ``trainer_state_from_jax``: ``GSTrainer.capture()`` or
  ``NeusTrainer.capture()`` of the JAX package -> the state that the port's
  ``GSTrainer.restore`` / ``NeusTrainer.restore`` takes.
- ``neus_state_from_jax``: the JAX NeusTrainer's parameter tree -> one state
  dict per field of the port's NeusTrainer.

Nothing here imports the JAX package: the trees arrive as objects whose
leaves ``np.asarray`` reads.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from v3d_tpu_torch.core import keymap

KINDS = ("unet", "unet2d", "vae_encoder", "vae_decoder", "vae_video_decoder",
         "clip", "dpt", "resunet", "discriminator", "pixelnerf")

KEY_MAPS = {
    "unet": keymap.convert_unet_key,
    "unet2d": keymap.convert_unet2d_key,
    "vae_encoder": lambda k: keymap.convert_vae_key(k, False),
    "vae_decoder": lambda k: keymap.convert_vae_key(k, False),
    "vae_video_decoder": lambda k: keymap.convert_vae_key(k, True),
    "clip": keymap.convert_clip_key,
    "dpt": keymap.convert_dpt_key,
    "resunet": keymap.convert_resunet_key,
    "discriminator": keymap.convert_discriminator_key,
    "pixelnerf": keymap.convert_pixelnerf_key,
}
# keys a module holds (to load its checkpoint strictly) that its forward
# never reads: a Flax tree may lack them, and then they keep the module's
UNUSED = {"dpt": keymap.DPT_UNUSED}

_INVERSES = {
    keymap.linear_w: lambda a: a.T,
    keymap.conv2_w: lambda a: a.transpose(3, 2, 0, 1),
    keymap.conv3_w: lambda a: a.transpose(4, 3, 0, 1, 2),
    keymap.conv1x1_to_dense: lambda a: a.T[:, :, None, None],
    keymap.t2j: lambda a: a,
}


def _key_map(kind: str, module: torch.nn.Module) -> Callable[[str], Tuple]:
    if kind not in KEY_MAPS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "unet2d":
        return functools.partial(keymap.convert_unet2d_key,
                                 use_linear=module.use_linear_in_transformer)
    return KEY_MAPS[kind]


def state_dict_from_jax(flax_params: Mapping, kind: str,
                        module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Flax params (numpy leaves, with or without the top "params" level) ->
    a state dict for ``module`` (one of VideoUNet, UNetModel, Encoder, Decoder,
    VideoDecoder, CLIPVisionTransformer, DPT, ResUNet, NLayerDiscriminator,
    PixelNeRF, as ``kind`` says), float32 on the CPU.
    Raises on a key the map does not know, a missing leaf or a shape
    mismatch; a key of ``UNUSED[kind]`` without a leaf keeps the module's
    value."""
    key_map = _key_map(kind, module)
    unused = UNUSED.get(kind)
    tree = flax_params.get("params", flax_params)
    out = {}
    for key, ref in module.state_dict().items():
        mapped = key_map(key)
        leaf = tree
        for p in mapped[0] if mapped is not None else ():
            leaf = leaf.get(p) if isinstance(leaf, Mapping) else None
        if (mapped is None or leaf is None) and unused is not None and unused.match(key):
            out[key] = ref.detach().float().cpu().clone()
            continue
        if mapped is None:
            raise KeyError(f"{kind}: no Flax path for {key!r}")
        path, fn = mapped
        if leaf is None:
            raise KeyError(f"{kind}: no Flax leaf {'/'.join(path)} for {key!r}")
        arr = _INVERSES[fn](np.asarray(leaf, dtype=np.float32))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{kind}: {key} is {arr.shape} from Flax, "
                             f"{tuple(ref.shape)} in the port")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def expand_unet_input_channels(state: Mapping[str, torch.Tensor], new_in: int
                               ) -> Dict[str, torch.Tensor]:
    """Zero-pad the UNet's first conv to ``new_in`` input channels
    (counterpart of v3d_tpu/core/convert.py:410-428): an image UNet takes
    extra concat-conditioning channels and starts out ignoring them.  A
    torch state dict in, a new one out; refuses to shrink."""
    key = "input_blocks.0.0.weight"
    w = state[key]
    cur = w.shape[1]
    if new_in < cur:
        raise ValueError(f"cannot shrink input channels {cur} -> {new_in}")
    out = dict(state)
    out[key] = torch.cat([w, w.new_zeros((w.shape[0], new_in - cur) + tuple(w.shape[2:]))],
                         dim=1)
    return out


def ae_trainer_state_from_jax(params: Mapping, disc_params: Mapping,
                              trainer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``AutoencoderTrainer``'s ``params`` ({"encoder", "decoder"})
    and ``disc_params`` -> a state dict for each module of the port's
    ``AutoencoderTrainer`` ({"encoder", "decoder", "disc"}; each loads with
    ``getattr(trainer, name).load_state_dict``)."""
    return {"encoder": state_dict_from_jax(params["encoder"], "vae_encoder",
                                           trainer.encoder),
            "decoder": state_dict_from_jax(params["decoder"], "vae_decoder",
                                           trainer.decoder),
            "disc": state_dict_from_jax(disc_params, "discriminator", trainer.disc)}


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


def _flat(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _neus_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """A Flax path inside one NeuS field -> (the port's parameter name,
    whether the leaf is a Flax (in, out) kernel that torch stores
    transposed)."""
    names = list(path)
    leaf = names[-1]
    parts = []
    for n in names[:-1]:
        if n.startswith("layers_"):
            parts += ["layers", n[len("layers_"):]]
        else:
            parts.append(n)
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    return ".".join(parts + [leaf]), leaf == "v"


def neus_group_state(tree: Mapping) -> Dict[str, np.ndarray]:
    """One JAX NeuS field's tree (with or without the top "params" level;
    parameters or Adam moments of that shape) -> {port name: float32 numpy}.
    Dense kernels and WNDense ``v`` are transposed to torch's (out, in)."""
    tree = tree.get("params", tree)
    out = {}
    for path, leaf in _flat(tree):
        name, transpose = _neus_key(path)
        arr = np.asarray(leaf, np.float32)
        out[name] = np.ascontiguousarray(arr.T if transpose else arr)
    return out


def neus_state_from_jax(params: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX ``NeusTrainer.params`` ({"geometry", "texture", "variance"[,
    "geometry_bg", "texture_bg"]}, any array leaves) -> one state dict per
    field of the port's NeusTrainer (``modules[name].load_state_dict``)."""
    return {name: neus_group_state(tree) for name, tree in params.items()}


def _neus_trainer_state(capture: Mapping) -> Dict:
    params = neus_state_from_jax(capture["params"])
    adam: Dict = {name: {} for name in params}
    for state in _adam_states(capture["opt_state"]):
        for name, mu in state.mu.items():
            if isinstance(mu, Mapping):   # the other groups are MaskedNodes
                step = int(np.asarray(state.count))
                nu = neus_group_state(state.nu[name])
                for k, m in neus_group_state(mu).items():
                    adam[name][k] = {"exp_avg": m, "exp_avg_sq": nu[k], "step": step}
    for name in params:
        if set(adam[name]) != set(params[name]):
            raise KeyError(f"no Adam state for {name}")
    return {"params": params, "adam": adam, "step": int(capture["step"]),
            "occs": np.asarray(capture["occs"], np.float32),
            "binary": np.asarray(capture["binary"], bool),
            "train_num_rays": int(capture["train_num_rays"])}


def trainer_state_from_jax(capture: Mapping) -> Dict:
    """The JAX ``GSTrainer.capture()`` (params, the optax multi-transform
    state, stats, alive, step) -> the numpy state that the port's
    ``GSTrainer.restore`` takes: per field its param and Adam ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` (optax's mu / nu / count).  A NeuS capture
    (it has "occs") -> the state of ``NeusTrainer.restore``: per field its
    state dict and Adam moments, the occupancy grid, the step and the ray
    count (the JAX key does not carry over)."""
    if "occs" in capture:
        return _neus_trainer_state(capture)
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
