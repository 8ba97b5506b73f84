"""GeneralConditioner and embedders (counterpart of
v3d_tpu/models/conditioner.py; sgm encoders/modules.py:86-228, 937-1073).

Each embedder output is routed by rank into {vector, crossattn, concat} and
concatenated on the feature (last) axis; image-like cond stays channels-last,
as in the JAX package.  With ``apply_ucg`` an embedder with a ``ucg_rate``
keeps each batch row's embedding with probability ``1 - ucg_rate`` (the
unconditional-guidance dropout of training); the keep masks are explicit or
drawn from a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.diffusion.denoise import append_dims
from v3d_tpu_torch.models.layers import timestep_embedding

# output rank -> conditioning key
OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}


@register("identity_encoder")
@dataclasses.dataclass(frozen=True)
class IdentityEncoder:
    def __call__(self, x):
        return x


@register("concat_timestep_embedder_nd")
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
    """One entry of the conditioner: ``embed`` maps batch[input_key] (and,
    when ``needs_rng``, the generator) to an embedding."""

    embed: Callable
    input_key: str
    ucg_rate: float = 0.0  # unconditional-guidance dropout rate (apply_ucg)
    is_trainable: bool = False
    needs_rng: bool = False


@register("general_conditioner")
@dataclasses.dataclass(frozen=True)
class GeneralConditioner:
    embedders: Sequence[EmbedderSpec] = ()

    def __call__(self, batch: Dict, force_zero_embeddings: Sequence[str] = (),
                 apply_ucg: bool = False,
                 keep: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        """``keep[input_key]``: the (b,) keep mask of that embedder's UCG
        dropout; embedders without one draw it from ``generator``."""
        output: Dict[str, torch.Tensor] = {}
        for spec in self.embedders:
            if spec.input_key not in batch:
                raise KeyError(f"conditioner input {spec.input_key!r} missing")
            args = [batch[spec.input_key]]
            if spec.needs_rng:
                args.append(generator)
            emb = spec.embed(*args)
            key = OUTPUT_DIM2KEYS[emb.dim()]
            if apply_ucg and spec.ucg_rate > 0.0:
                mask = (keep or {}).get(spec.input_key)
                if mask is None:
                    mask = torch.rand((emb.shape[0],), device=emb.device,
                                      generator=generator) < 1.0 - spec.ucg_rate
                emb = append_dims(mask.to(emb.device, emb.dtype), emb.dim()) * emb
            if spec.input_key in force_zero_embeddings:
                emb = torch.zeros_like(emb)
            output[key] = (torch.cat([output[key], emb], dim=-1)
                           if key in output else emb)
        return output

    def get_unconditional_conditioning(
            self, batch_c: Dict, batch_uc: Dict = None,
            force_uc_zero_embeddings: Sequence[str] = (),
            force_cond_zero_embeddings: Sequence[str] = (),
            generator: Optional[torch.Generator] = None):
        """modules.py:186-204: (c, uc), UCG dropout off."""
        c = self(batch_c, force_cond_zero_embeddings, generator=generator)
        uc = self(batch_c if batch_uc is None else batch_uc,
                  force_uc_zero_embeddings, generator=generator)
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
