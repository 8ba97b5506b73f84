"""Checkpoint loading (counterpart of v3d_tpu/core/checkpoint.py:106-172).

- ``load_torch_state_dict``: a ``.ckpt`` / ``.pt`` (Lightning pickles more
  than tensors, so ``torch.load(weights_only=False)``; ``{"state_dict": ...}``
  is unwrapped) or a ``.safetensors`` file, flat.
- ``read_safetensors`` / ``write_safetensors``: the safetensors format with
  torch alone (an 8-byte little-endian header length, a JSON header of
  dtype / shape / data offsets padded with spaces to 8 bytes, then the raw
  bytes).  The writer lays the file out as the ``safetensors`` package does
  (tensors by dtype, widest first, then by name), byte for byte.
- ``split_svd_state_dict``: the key-prefix split of one svd_xt / V3D file
  (scripts/pub/V3D_512.py:145-162) into clip / ae / unet / other.
- ``load_v3d_params``: the split, then a strict ``load_state_dict`` of each
  part into the engine's VideoUNet, VAE encoder, temporal VAE decoder and
  CLIP tower.  The port's modules carry the checkpoint's own parameter
  names, so nothing is renamed; a key a module does not know raises.  Keys
  under "other" (denoiser buffers, the other embedders) are not loaded, as
  in the JAX package.
- ``save_trainer_state`` / ``load_trainer_state``: a trainer's
  ``capture()`` tree (``GSTrainer``, ``NeusTrainer``) as one ``.npz``, its
  nested keys joined by "/".  The JAX package stores it with orbax, a JAX
  library, so the file format is the port's own; zero-size arrays (f_rest at
  sh_degree 0) are kept as they are.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype names, in the order the format sorts them (widest first)
_ST_DTYPES = {
    "U64": torch.uint64, "I64": torch.int64, "F64": torch.float64,
    "U32": torch.uint32, "F32": torch.float32, "I32": torch.int32,
    "BF16": torch.bfloat16, "F16": torch.float16, "U16": torch.uint16,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
# rank of each dtype in the format's enum (the writer sorts by it, descending)
_ST_RANK = {"BOOL": 0, "U8": 1, "I8": 2, "I16": 3, "U16": 4, "F16": 5,
            "BF16": 6, "I32": 7, "U32": 8, "F32": 9, "F64": 10, "I64": 11,
            "U64": 12}

CLIP_PREFIXES = ("open_clip.model.visual.", "model.visual.")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor}.  The file is mapped
    copy-on-write, so the tensors are views of the mapping and nothing is
    read until a tensor is used."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", mm[:8])
    header = json.loads(mm[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        if count:
            flat = torch.frombuffer(mm, dtype=dtype, count=count,
                                    offset=base + start)
        else:
            flat = torch.empty(0, dtype=dtype)
        out[name] = flat.view(info["shape"])
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the CPU one at a time) as a
    .safetensors file, laid out as the ``safetensors`` package lays it out."""
    names = sorted(tensors, key=lambda k: (-_ST_RANK[_ST_NAMES[tensors[k].dtype]], k))
    header: Dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.view(-1).view(torch.uint8).numpy().tobytes())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """video_diffusion.py:128-133: a .ckpt holds {'state_dict': ...}; a
    .safetensors file is flat."""
    if path.endswith("ckpt") or path.endswith(".pt"):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        return obj.get("state_dict", obj)
    if path.endswith("safetensors"):
        return read_safetensors(path)
    raise NotImplementedError(path)


def split_svd_state_dict(sd: Mapping) -> Dict[str, Dict]:
    """V3D_512.py:145-162: clip ('conditioner.embedders.0.'), ae
    ('first_stage_model.'), unet ('model.diffusion_model.'), other."""
    out = {"clip": {}, "ae": {}, "unet": {}, "other": {}}
    for k, v in sd.items():
        if "conditioner.embedders.0." in k:
            out["clip"][k.split("conditioner.embedders.0.", 1)[1]] = v
        elif "first_stage_model." in k:
            out["ae"][k.split("first_stage_model.", 1)[1]] = v
        elif "model.diffusion_model." in k:
            out["unet"][k.split("model.diffusion_model.", 1)[1]] = v
        else:
            out["other"][k] = v
    return out


def engine_modules(engine) -> Dict[str, torch.nn.Module]:
    return {"unet": engine.unet, "encoder": engine.vae_encoder,
            "decoder": engine.vae_decoder, "clip": engine.clip}


def load_v3d_params(path: str, engine) -> Dict[str, int]:
    """Load a V3D / SVD checkpoint into ``engine`` (strict per module, cast
    to each module's dtype and device): the UNet, the VAE encoder and
    decoder and, where the file has the tower under either prefix, CLIP.
    Returns the parameters loaded per module."""
    parts = split_svd_state_dict(load_torch_state_dict(path))
    sds = {"unet": parts["unet"],
           "encoder": {k[len("encoder."):]: v for k, v in parts["ae"].items()
                       if k.startswith("encoder.")},
           "decoder": {k[len("decoder."):]: v for k, v in parts["ae"].items()
                       if k.startswith("decoder.")}}
    for prefix in CLIP_PREFIXES:
        if any(k.startswith(prefix) for k in parts["clip"]):
            sds["clip"] = {k[len(prefix):]: v for k, v in parts["clip"].items()
                           if k.startswith(prefix)}
            break
    mods = engine_modules(engine)
    counts = {}
    for name, sd in sds.items():
        mods[name].load_state_dict(sd, strict=True)
        counts[name] = sum(int(v.numel()) for v in sd.values())
    return counts


def save_v3d_checkpoint(engine, path: str) -> None:
    """The engine's four modules under the sgm prefixes, as a .safetensors
    file (by extension) or a ``{"state_dict": ...}`` .ckpt."""
    prefixes = {"unet": "model.diffusion_model.",
                "encoder": "first_stage_model.encoder.",
                "decoder": "first_stage_model.decoder.",
                "clip": "conditioner.embedders.0." + CLIP_PREFIXES[0]}
    sd = {}
    for name, mod in engine_modules(engine).items():
        for k, v in mod.state_dict().items():
            sd[prefixes[name] + k] = v
    if path.endswith("safetensors"):
        write_safetensors(sd, path)
    else:
        torch.save({"state_dict": {k: v.cpu() for k, v in sd.items()}}, path)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"trainer state key {k!r} holds '/'")
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        elif torch.is_tensor(v):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def save_trainer_state(path: str, tree: Mapping) -> None:
    """A nested dict of arrays, tensors and scalars -> one .npz at ``path``
    (written as given: numpy appends no suffix to an open file)."""
    with open(path, "wb") as f:
        np.savez(f, **_flatten(tree))


def load_trainer_state(path: str) -> Dict:
    """The nested dict of numpy arrays that ``save_trainer_state`` wrote
    (scalars come back as 0-d arrays)."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out
