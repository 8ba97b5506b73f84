"""Engine construction (counterpart of v3d_tpu/engines/builder.py): the
V3D_512.yaml recipe, a scaled-down variant of the same topology, and a
seeded random initialisation.

The real weights (V3D_512.ckpt / svd_xt.safetensors) are not in this
repository; parameter names follow them, so once they are, loading is a
strict ``load_state_dict`` per module.  Until then the modules are built on
the meta device, materialised on the target device and filled by
``seeded_init_``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from v3d_tpu_torch.diffusion import (
    Denoiser,
    EDMDiscretization,
    EulerEDMSampler,
    LinearPredictionGuider,
    TrianglePredictionGuider,
    VScalingWithEDMcNoise,
)
from v3d_tpu_torch.diffusion.loss import StandardDiffusionLoss
from v3d_tpu_torch.diffusion.sigma_sampling import EDMSampling
from v3d_tpu_torch.diffusion.weighting import EDMWeighting
from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine
from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer
from v3d_tpu_torch.models.vae import Encoder, VideoDecoder
from v3d_tpu_torch.models.video_unet import VideoUNet

TINY_UNET = dict(num_res_blocks=1, attention_resolutions=(2, 1),
                 channel_mult=(1, 2), num_head_channels=16, context_dim=64,
                 adm_in_channels=768)
TINY_CLIP = dict(width=64, layers=2, heads=4, patch_size=16, image_size=224,
                 output_dim=64)


def init_std(module: nn.Module, name: str, param: torch.Tensor):
    """(mean, std) of the seeded random init: weights ~ N(0, 1/fan_in),
    fan_in = prod(shape[1:]); norm scales ~ 1 + N(0, 0.01); every other
    vector (biases, mix factors, the class token) ~ N(0, 0.01).  Nothing is
    zero, so a parity test exercises every layer."""
    if param.dim() >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(param.shape[1:]))
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)) and name == "weight":
        return 1.0, 0.1
    return 0.0, 0.1


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter in place from one generator on its device."""
    gen = None
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            mean, std = init_std(mod, name, p)
            p.normal_(mean, std, generator=gen)
    return module


def materialise(module: nn.Module, device, dtype, seed: int) -> nn.Module:
    """A module built on the meta device -> on ``device``, filled by
    ``seeded_init_``, in ``dtype``, frozen for inference.  On "meta" it
    stays without storage (shapes only)."""
    if torch.device(device).type != "meta":
        module = module.to_empty(device=device)
        seeded_init_(module, seed)
    return module.to(dtype).eval().requires_grad_(False)


def build_v3d_engine(num_frames: int = 18, num_steps: int = 25,
                     min_scale: float = 3.5, max_scale: float = 3.5,
                     sigma_max: float = 700.0, guider: str = "linear",
                     model_channels: int = 320, vae_ch: int = 128,
                     device="cuda", dtype: torch.dtype = torch.float32,
                     seed: int = 0, clip_cfg: Optional[Dict] = None,
                     unet_overrides: Optional[Dict] = None
                     ) -> VideoDiffusionEngine:
    """The V3D_512.yaml recipe with seeded random weights on ``device`` (the
    card unless the caller passes ``device="cpu"``), all in ``dtype``.
    ``unet_overrides`` may set the UNet's ``compute_dtype`` and
    ``use_checkpoint`` for training."""
    guider_cls = {"linear": LinearPredictionGuider,
                  "triangle": TrianglePredictionGuider}[guider]
    sampler = EulerEDMSampler(
        discretization=EDMDiscretization(sigma_max=sigma_max),
        num_steps=num_steps,
        guider=guider_cls(max_scale=max_scale, min_scale=min_scale,
                          num_frames=num_frames))
    unet_kw = dict(in_channels=8, model_channels=model_channels,
                   out_channels=4, num_res_blocks=2,
                   attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                   num_head_channels=64, context_dim=1024, adm_in_channels=768)
    unet_kw.update(unet_overrides or {})
    vae_kw = dict(ch=vae_ch, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                  z_channels=4)
    with torch.device("meta"):
        unet = VideoUNet(**unet_kw)
        encoder = Encoder(double_z=True, **vae_kw)
        decoder = VideoDecoder(out_ch=3, **vae_kw)
        clip = CLIPVisionTransformer(**(clip_cfg or {}))
    mods = [materialise(m, device, dtype, seed + i)
            for i, m in enumerate((unet, encoder, decoder, clip))]
    return VideoDiffusionEngine(
        unet=mods[0], denoiser=Denoiser(scaling=VScalingWithEDMcNoise()),
        sampler=sampler, vae_encoder=mods[1], vae_decoder=mods[2],
        clip=mods[3], scale_factor=0.18215, num_frames=num_frames,
        loss_fn=StandardDiffusionLoss(
            sigma_sampler=EDMSampling(p_mean=1.5, p_std=2.0),
            loss_weighting=EDMWeighting(sigma_data=1.0)))


def build_tiny_engine(num_frames: int = 4, num_steps: int = 3, device="cuda",
                      dtype: torch.dtype = torch.float32, seed: int = 0,
                      unet_overrides: Optional[Dict] = None
                      ) -> VideoDiffusionEngine:
    """Scaled-down engine of the same topology, for tests and dry runs."""
    return build_v3d_engine(num_frames=num_frames, num_steps=num_steps,
                            model_channels=32, vae_ch=32, device=device,
                            dtype=dtype, seed=seed, clip_cfg=TINY_CLIP,
                            unet_overrides={**TINY_UNET, **(unet_overrides or {})})
