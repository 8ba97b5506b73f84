"""The image diffusion engine (counterpart of
v3d_tpu/engines/image_diffusion.py; sgm models/diffusion.py DiffusionEngine
and inference/helpers.py do_sample / do_img2img for the image pipelines
shipped beside V3D).

The same diffusion stack as the video engine, driving the 2-D UNet
(``models/unet2d.py``).  The conditioner is the caller's: the text towers
are out of scope, as in the JAX package, so ``c`` / ``uc`` carry
``crossattn`` (n, s, d), ``vector`` and ``concat`` tensors directly.
Layouts follow the JAX package: latents (n, h, w, c), images (n, H, W, 3) in
[-1, 1] in and [0, 1] out.  Every draw is an explicit tensor argument or
comes from the ``torch.Generator`` passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from v3d_tpu_torch.diffusion.denoise import Denoiser
from v3d_tpu_torch.diffusion.discretize import SlicedDiscretization
from v3d_tpu_torch.engines.video_diffusion import _draw
from v3d_tpu_torch.models.vae import gaussian_sample


@dataclasses.dataclass
class ImageDiffusionEngine:
    unet: Any
    denoiser: Denoiser
    sampler: Any
    vae_encoder: Any = None
    vae_decoder: Any = None
    scale_factor: float = 0.18215
    latent_channels: int = 4
    downscale: int = 8

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def _denoiser_fn(self):
        def network(x, c_noise, cond):
            if "concat" in cond:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            out = self.unet(x.permute(0, 3, 1, 2), c_noise,
                            context=cond.get("crossattn"), y=cond.get("vector"))
            return out.permute(0, 2, 3, 1)

        def denoiser_fn(x, sigma, cond):
            return self.denoiser(network, x, sigma, cond)

        return denoiser_fn

    @torch.no_grad()
    def sample(self, c: Dict, uc: Dict, batch: int = 1, height: int = 512,
               width: int = 512, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """helpers.py do_sample: standard-normal ``noise`` (n, h, w, c),
        from ``generator`` when not given -> the sampler -> latents."""
        shape = (batch, height // self.downscale, width // self.downscale,
                 self.latent_channels)
        noise = _draw(noise, shape, self.device, generator)
        return self.sampler(self._denoiser_fn(), noise, c, uc, generator=generator)

    @torch.no_grad()
    def img2img(self, init_latents: torch.Tensor, c: Dict, uc: Dict,
                strength: float = 0.6, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """helpers.py do_img2img: the last ``round(n * strength)`` steps of
        the schedule (Python's round) from the init latents noised to where
        they begin, ``(z + sigma0 * eps) / sqrt(1 + sigma0^2)`` (the sampler
        scales by sqrt(1 + sigma0^2) again)."""
        n = self.sampler.num_steps
        run = max(1, int(round(n * strength)))
        sampler = dataclasses.replace(
            self.sampler, num_steps=run,
            discretization=SlicedDiscretization(base=self.sampler.discretization,
                                                skip=n - run))
        sigma0 = float(sampler.schedule()[0])
        init_latents = init_latents.to(self.device, torch.float32)
        eps = _draw(noise, init_latents.shape, self.device, generator)
        x = (init_latents + sigma0 * eps) / torch.sqrt(
            torch.tensor(1.0 + sigma0**2, device=self.device))
        return sampler(self._denoiser_fn(), x, c, uc, generator=generator)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents (n, h, w, c) -> images (n, H, W, 3) in [0, 1], float32."""
        z = z.to(self.device) / self.scale_factor
        x = self.vae_decoder(z.permute(0, 3, 1, 2)).float()
        return ((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def encode(self, images: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (n, H, W, 3) in [-1, 1] -> scaled latents (n, h, w, c), a
        sample of the encoder's moments with standard-normal ``noise``."""
        moments = self.vae_encoder(images.to(self.device).permute(0, 3, 1, 2))
        moments = moments.permute(0, 2, 3, 1).float()
        shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        return self.scale_factor * gaussian_sample(
            moments, _draw(noise, shape, self.device, generator))
