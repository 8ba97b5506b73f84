"""Classifier-free guidance (counterpart of v3d_tpu/diffusion/guidance.py).

A CFG guider doubles the batch as [uncond, cond] (guidance.py:32-42) and
recombines the two denoised halves: ``VanillaCFG`` with one scale, the
frame guiders with a per-frame scale over the ``num_frames`` orbit views of
the ``(b*t, ...)`` frame-major batch.  ``IdentityGuider`` (the samplers'
default) passes the batch through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.diffusion.denoise import append_dims

Cond = Dict[str, torch.Tensor]

# entries doubled for CFG; anything else is shared between cond and uncond
BATCHED_COND_KEYS = ("vector", "crossattn", "concat")


def _prepare_cfg_inputs(x, s, c: Cond, uc: Cond, extra_keys=()) -> Tuple:
    batched = set(BATCHED_COND_KEYS) | set(extra_keys)
    c_out = {}
    for k in c:
        if k in batched:
            c_out[k] = torch.cat([uc[k], c[k]], dim=0)
        elif k != "rgb":  # pixelnerf rgb target: cond-only (guiders.py:97)
            c_out[k] = c[k]
    return torch.cat([x, x], dim=0), torch.cat([s, s], dim=0), c_out


@register("identity_guider")
@dataclasses.dataclass(frozen=True)
class IdentityGuider:
    def prepare_inputs(self, x, s, c: Cond, uc: Cond):
        return x, s, dict(c)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        return x


@register("vanilla_cfg")
@dataclasses.dataclass(frozen=True)
class VanillaCFG:
    scale: float = 1.0

    def prepare_inputs(self, x, s, c: Cond, uc: Cond):
        return _prepare_cfg_inputs(x, s, c, uc)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)


@dataclasses.dataclass(frozen=True)
class _FrameScaleGuider:
    max_scale: float
    num_frames: int
    min_scale: float = 1.0
    additional_cond_keys: tuple = ()

    def frame_scales(self) -> np.ndarray:
        raise NotImplementedError

    def prepare_inputs(self, x, s, c: Cond, uc: Cond):
        return _prepare_cfg_inputs(x, s, c, uc, self.additional_cond_keys)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        t = self.num_frames
        b = x_u.shape[0] // t
        x_u = x_u.reshape((b, t) + x_u.shape[1:])
        x_c = x_c.reshape((b, t) + x_c.shape[1:])
        scale = torch.as_tensor(self.frame_scales(), dtype=x_u.dtype,
                                device=x_u.device)[None, :]
        out = x_u + append_dims(scale, x_u.dim()) * (x_c - x_u)
        return out.reshape((b * t,) + out.shape[2:])


@register("linear_prediction_guider")
@dataclasses.dataclass(frozen=True)
class LinearPredictionGuider(_FrameScaleGuider):
    """guiders.py:60-103: scale ramps linspace(min, max) over the frames."""

    def frame_scales(self) -> np.ndarray:
        return np.linspace(self.min_scale, self.max_scale, self.num_frames,
                           dtype=np.float32)


@register("triangle_prediction_guider")
@dataclasses.dataclass(frozen=True)
class TrianglePredictionGuider(_FrameScaleGuider):
    """guiders.py:104-146: up to 2*max_scale mid-orbit, mirrored back down."""

    def frame_scales(self) -> np.ndarray:
        t = self.num_frames
        scale = np.linspace(self.min_scale, 2 * self.max_scale, t,
                            dtype=np.float32)
        scale[t // 2:] = 2 * self.max_scale - scale[t // 2:]
        return scale
