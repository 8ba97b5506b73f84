"""Diffusion training loss (counterpart of v3d_tpu/diffusion/loss.py
StandardDiffusionLoss; sgm diffusionmodules/loss.py:13-118).

Samples sigma, noises the latents, runs the preconditioned denoiser and
returns the weighted per-sample loss.  The draws (sigmas, then the noise,
then the offset noise) come from the ``generator`` passed in, or are given
explicitly, so that a test can feed both packages the same numbers.  Under
``block`` a data-parallel rank makes each draw at the global batch's shape
and keeps its rows (``global_rows``), so N ranks draw what one process draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.diffusion.denoise import append_dims


def global_rows(n: int, block: Optional[Tuple[int, int]] = None
                ) -> Tuple[int, slice]:
    """``n`` rows that are block ``index`` of ``count`` (``block``, a
    data-parallel rank's slice; None is the whole batch) -> (the global
    batch's rows, which a draw is made at; the slice of them that is this
    block's)."""
    index, count = block or (0, 1)
    return n * count, slice(index * n, (index + 1) * n)


@register("standard_diffusion_loss")
@dataclasses.dataclass(frozen=True)
class StandardDiffusionLoss:
    sigma_sampler: Callable = None
    loss_weighting: Callable = None
    loss_type: str = "l2"
    offset_noise_level: float = 0.0

    def __call__(self, network: Callable, denoiser: Callable, cond: Dict,
                 inputs: torch.Tensor, sigmas: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 extra_model_inputs: Optional[Dict] = None,
                 block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Per-sample loss of ``inputs``.  Under ``block`` the inputs are a
        rank's rows of the global batch (``global_rows``): the draws, and
        ``sigmas`` / ``noise`` where given, are the global batch's, and
        this block's rows of them are used."""
        extra_model_inputs = extra_model_inputs or {}
        n, dev = inputs.shape[0], inputs.device
        total, mine = global_rows(n, block)
        if sigmas is None:
            sigmas = self.sigma_sampler(total, device=dev, generator=generator)
        sigmas = sigmas[mine].to(dev, inputs.dtype)
        if noise is None:
            noise = torch.randn((total,) + tuple(inputs.shape[1:]), device=dev,
                                generator=generator, dtype=inputs.dtype)
        noise = noise[mine]
        if self.offset_noise_level > 0.0:
            offset = torch.randn((total,), device=dev, generator=generator,
                                 dtype=inputs.dtype)[mine]
            noise = noise + self.offset_noise_level * append_dims(offset, inputs.dim())
        noised = inputs + noise.to(dev, inputs.dtype) * append_dims(sigmas, inputs.dim())
        model_output = denoiser(network, noised, sigmas, cond, **extra_model_inputs)
        w = append_dims(self.loss_weighting(sigmas), inputs.dim())
        if self.loss_type == "l2":
            per = w * (model_output - inputs) ** 2
        elif self.loss_type == "l1":
            per = w * (model_output - inputs).abs()
        else:
            raise NotImplementedError(self.loss_type)
        return per.reshape(n, -1).mean(dim=1)


@register("diffusion_loss_with_pixelnerf")
@dataclasses.dataclass(frozen=True)
class StandardDiffusionLossWithPixelNeRFLoss(StandardDiffusionLoss):
    """loss.py:51-71 (sgm loss.py:120-186): the base loss without
    ``cond["rgb"]``, plus ``pixelnerf_loss_weight`` times the per-sample mean
    squared error of the PixelNeRF-rendered ``cond["rgb"]`` against
    ``rgb_target`` where both are given."""

    pixelnerf_loss_weight: float = 1.0

    def __call__(self, network: Callable, denoiser: Callable, cond: Dict,
                 inputs: torch.Tensor, sigmas: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 extra_model_inputs: Optional[Dict] = None,
                 rgb_target: Optional[torch.Tensor] = None,
                 block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        base = super().__call__(network, denoiser,
                                {k: v for k, v in cond.items() if k != "rgb"},
                                inputs, sigmas=sigmas, noise=noise,
                                generator=generator,
                                extra_model_inputs=extra_model_inputs,
                                block=block)
        if "rgb" in cond and rgb_target is not None:
            err = (cond["rgb"] - rgb_target) ** 2.0
            base = base + self.pixelnerf_loss_weight * err.mean(
                dim=tuple(range(1, rgb_target.dim())))
        return base
