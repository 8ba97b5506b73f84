"""GeneralConditioner and embedders (counterpart of
v3d_tpu/models/conditioner.py; sgm encoders/modules.py:86-228, 937-1073).

Each embedder output is routed by rank into {vector, crossattn, concat} and
concatenated on the feature (last) axis; image-like cond stays channels-last,
as in the JAX package.  UCG dropout belongs to training and is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from v3d_tpu_torch.models.layers import timestep_embedding

# output rank -> conditioning key
OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}


@dataclasses.dataclass(frozen=True)
class IdentityEncoder:
    def __call__(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class ConcatTimestepEmbedderND:
    """modules.py:937-953: sinusoidal embedding of each scalar column,
    concatenated -> (b, dims * outdim)."""

    outdim: int = 256

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            x = x[:, None]
        b, dims = x.shape
        return timestep_embedding(x.reshape(-1), self.outdim).reshape(
            b, dims * self.outdim)


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    embed: Callable
    input_key: str
    ucg_rate: float = 0.0  # training-time dropout rate (not applied here)


@dataclasses.dataclass(frozen=True)
class GeneralConditioner:
    embedders: Sequence[EmbedderSpec] = ()

    def __call__(self, batch: Dict, force_zero_embeddings: Sequence[str] = ()
                 ) -> Dict[str, torch.Tensor]:
        output: Dict[str, torch.Tensor] = {}
        for spec in self.embedders:
            if spec.input_key not in batch:
                raise KeyError(f"conditioner input {spec.input_key!r} missing")
            emb = spec.embed(batch[spec.input_key])
            key = OUTPUT_DIM2KEYS[emb.dim()]
            if spec.input_key in force_zero_embeddings:
                emb = torch.zeros_like(emb)
            output[key] = (torch.cat([output[key], emb], dim=-1)
                           if key in output else emb)
        return output

    def get_unconditional_conditioning(
            self, batch_c: Dict, batch_uc: Dict = None,
            force_uc_zero_embeddings: Sequence[str] = (),
            force_cond_zero_embeddings: Sequence[str] = ()):
        """modules.py:186-204: (c, uc)."""
        c = self(batch_c, force_cond_zero_embeddings)
        uc = self(batch_c if batch_uc is None else batch_uc,
                  force_uc_zero_embeddings)
        return c, uc


def repeat_cond_per_frame(c: Dict, num_frames: int,
                          keys: Sequence[str] = ("crossattn", "concat")) -> Dict:
    """V3D_512.py:263-267: repeat entries per frame, (b, ...) -> ((b t), ...)."""
    out = dict(c)
    for k in keys:
        if k in out:
            v = out[k]
            out[k] = v.repeat_interleave(num_frames, dim=0)
    return out
