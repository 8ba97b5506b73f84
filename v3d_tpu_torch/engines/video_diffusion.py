"""The generation engine (counterpart of v3d_tpu/engines/video_diffusion.py;
sgm video_diffusion.py DiffusionEngine + scripts/pub/V3D_512.py:115-317).

Public layouts follow the JAX package: image (1, H, W, 3) in [-1, 1],
latents (t, h, w, 4), frames (t, H, W, 3) in [0, 1], cond dict keys
crossattn / concat / vector.  Every noise draw is either an explicit tensor
argument or comes from the ``torch.Generator`` passed in.  Training
(``training_cond``, ``training_loss``; sgm DiffusionEngine.training_step)
runs the EDM loss on pre-encoded latents; ``img2img_latents`` is the
SDEdit-style partial denoising of given latents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from v3d_tpu_torch.diffusion.denoise import Denoiser
from v3d_tpu_torch.diffusion.discretize import SlicedDiscretization
from v3d_tpu_torch.diffusion.loss import StandardDiffusionLoss, global_rows
from v3d_tpu_torch.engines.wrappers import make_unet_network_fn
from v3d_tpu_torch.models.clip_vit import clip_preprocess
from v3d_tpu_torch.models.conditioner import (
    ConcatTimestepEmbedderND,
    EmbedderSpec,
    GeneralConditioner,
    IdentityEncoder,
    repeat_cond_per_frame,
)
from v3d_tpu_torch.models.vae import gaussian_sample
from v3d_tpu_torch.parallel.mesh import replicate
from v3d_tpu_torch.utils.trace import span


def _draw(noise: Optional[torch.Tensor], shape, device,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return torch.randn(shape, device=device, generator=generator)


@dataclasses.dataclass
class VideoDiffusionEngine:
    """The modules (with their weights) plus the sampling configuration."""

    unet: Any
    denoiser: Denoiser
    sampler: Any
    vae_encoder: Any
    vae_decoder: Any
    clip: Any
    scale_factor: float = 0.18215
    num_frames: int = 18
    latent_channels: int = 4
    downscale: int = 8
    loss_fn: Optional[StandardDiffusionLoss] = None

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def conditioner(self) -> GeneralConditioner:
        """V3D_512.yaml: identity CLIP / VAE cond + three scalar sinusoidal
        embedders (fps, motion bucket, cond aug) -> 768-d vector."""
        return GeneralConditioner(embedders=(
            EmbedderSpec(IdentityEncoder(), "cond_frames_without_noise",
                         ucg_rate=0.2),
            EmbedderSpec(ConcatTimestepEmbedderND(256), "fps_id",
                         is_trainable=True),
            EmbedderSpec(ConcatTimestepEmbedderND(256), "motion_bucket_id",
                         is_trainable=True),
            EmbedderSpec(IdentityEncoder(), "cond_frames", ucg_rate=0.2),
            EmbedderSpec(ConcatTimestepEmbedderND(256), "cond_aug",
                         is_trainable=True),
        ))

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor, cond_aug: float,
                     enc_noise: Optional[torch.Tensor] = None,
                     aug_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (1, H, W, 3) in [-1, 1] -> (CLIP embedding (1, 1, d), the
        moments-sampled cond latent + cond_aug noise (1, h, w, 4))
        (V3D_512.py:234-243).  The latent sample draws ``enc_noise``, then
        the cond-aug noise ``aug_noise``."""
        dev = self.device
        image = image.to(dev, torch.float32)
        with span("clip.forward"):
            clip_emb = self.clip(clip_preprocess(image).permute(0, 3, 1, 2)).float()
        if clip_emb.dim() == 2:
            clip_emb = clip_emb[:, None, :]
        with span("vae.encode", frames=image.shape[0]):
            moments = self.vae_encoder(image.permute(0, 3, 1, 2))
        moments = moments.permute(0, 2, 3, 1).float()
        shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        z = gaussian_sample(moments, _draw(enc_noise, shape, dev, generator))
        z = z + cond_aug * _draw(aug_noise, shape, dev, generator)
        return clip_emb, z

    def build_cond(self, clip_emb, cond_frames, fps_id, motion_bucket_id,
                   cond_aug) -> Tuple[Dict, Dict]:
        """get_batch + get_unconditional_conditioning + per-frame repeat
        (V3D_512.py:31-69, 247-267); uc zeroes the image conds."""
        b = clip_emb.shape[0]
        ones = torch.ones((b * self.num_frames,), device=clip_emb.device)
        batch = {
            "cond_frames_without_noise": clip_emb,
            "cond_frames": cond_frames,
            "fps_id": ones * fps_id,
            "motion_bucket_id": ones * motion_bucket_id,
            "cond_aug": ones * cond_aug,
        }
        c, uc = self.conditioner().get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=["cond_frames",
                                             "cond_frames_without_noise"])
        return (repeat_cond_per_frame(c, self.num_frames),
                repeat_cond_per_frame(uc, self.num_frames))

    def latent_shape(self, height: int, width: int) -> Tuple[int, ...]:
        return (self.num_frames, height // self.downscale,
                width // self.downscale, self.latent_channels)

    @torch.no_grad()
    def sample_latents(self, c: Dict, uc: Dict, height: int = 512,
                       width: int = 512, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       mesh=None) -> torch.Tensor:
        """EDM sampling of the VideoUNet: the hot loop.  ``noise`` is the
        initial standard-normal latent (t, h, w, 4).

        ``mesh``: every rank of its "data" axis calls this with the same c /
        uc; the sampler's state stays replicated (the noise is the first
        rank's: one broadcast) and each UNet forward is frame-parallel, the
        ranks taking the CFG-doubled 2t frames in blocks (the ranks must
        divide 2t; ``make_unet_network_fn``).  A UNet cut over "model"
        (``parallel.tensor.tp_shard_``) runs tensor-parallel inside each
        forward.  A sampler that draws needs the same ``generator`` state on
        every rank.  The latents returned are the same on every rank of the
        mesh (v3d_tpu/engines/video_diffusion.py:110-126 jitted on
        frame-sharded inputs and TP-placed parameters)."""
        dev = self.device
        noise = _draw(noise, self.latent_shape(height, width), dev, generator)
        if mesh is not None:
            noise = replicate(noise, mesh)
        # CFG doubles the video batch -> indicator (2, t) (V3D_512.py:273-275)
        indicator = torch.zeros((2, self.num_frames), device=dev)
        network = make_unet_network_fn(self.unet, self.num_frames, mesh=mesh)

        def denoiser_fn(x, sigma, cond):
            return self.denoiser(network, x, sigma, cond,
                                 image_only_indicator=indicator)

        return self.sampler(denoiser_fn, noise, c, uc, generator=generator)

    @torch.no_grad()
    def decode_latents(self, z: torch.Tensor,
                       decoding_t: Optional[int] = None) -> torch.Tensor:
        """Chunked temporal VAE decode (video_diffusion.py:183-211):
        (t, h, w, 4) -> frames (t, H, W, 3) in [0, 1], float32; a
        ``vae.decode`` span a chunk."""
        t = z.shape[0]
        decoding_t = min(decoding_t or t, t)
        outs = []
        for i in range(0, t, decoding_t):
            chunk = z[i:i + decoding_t]
            with span("vae.decode", frames=chunk.shape[0]):
                chunk = chunk.to(self.device) / self.scale_factor
                x = self.vae_decoder(chunk.permute(0, 3, 1, 2), chunk.shape[0])
                outs.append(((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)
                            .permute(0, 2, 3, 1))
        return torch.cat(outs, dim=0)

    @torch.no_grad()
    def encode_first_stage(self, frames: torch.Tensor,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           block: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
        """frames (n, H, W, 3) in [-1, 1] -> scaled latents (n, h, w, 4), a
        sample of the encoder's moments (video_diffusion.py:195-201).
        Under ``block`` (index, count) the frames are a data-parallel
        rank's rows of the global batch, and the noise drawn is their rows
        of the draw at the global batch's shape (``global_rows``)."""
        with span("vae.encode", frames=frames.shape[0]):
            moments = self.vae_encoder(frames.to(self.device).permute(0, 3, 1, 2))
        moments = moments.permute(0, 2, 3, 1).float()
        shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        if noise is None:
            total, mine = global_rows(shape[0], block)
            noise = torch.randn((total,) + tuple(shape[1:]), device=self.device,
                                generator=generator)[mine]
        return self.scale_factor * gaussian_sample(
            moments, _draw(noise, shape, self.device, generator))

    def training_cond(self, batch: Dict, num_frames: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """The frame-flattened cond dict of a ``video_collate`` batch
        (video_diffusion.py:214-231): per-video CLIP embedding and cond
        frame repeated per frame, the three scalar embeddings per frame."""
        t = num_frames or self.num_frames

        def dev(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        clip_emb = dev(batch["cond_frames_without_noise"])
        if clip_emb.dim() == 2:
            clip_emb = clip_emb[:, None, :]
        emb = ConcatTimestepEmbedderND(256)
        vector = torch.cat([emb(dev(batch[k])) for k in
                            ("fps_id", "motion_bucket_id", "cond_aug")], dim=-1)
        cond = {"crossattn": clip_emb, "concat": dev(batch["cond_frames"]),
                "vector": vector}
        return repeat_cond_per_frame(cond, t)

    def training_loss(self, latents: torch.Tensor, cond: Dict,
                      num_frames: Optional[int] = None,
                      sigma_per_video: bool = False,
                      sigmas: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      block: Optional[Tuple[int, int]] = None,
                      mesh=None) -> torch.Tensor:
        """Mean EDM loss on pre-encoded latents ((b t), h, w, 4), already
        scaled (video_diffusion.py:233-258).  Sigmas are drawn per flattened
        frame, as the reference does, or with ``sigma_per_video`` one per
        video shared by its frames; ``sigmas`` / ``noise`` may be given.
        ``block``: the latents are a data-parallel rank's rows, drawn for as
        the loss's ``block`` says.  ``mesh``: the rank's rows are its block
        of the batch along "data" (``block``); where they are not whole
        videos, the UNet forward is frame-parallel (``make_unet_network_fn``
        with ``rows_local``), else each rank's videos run alone.  A UNet cut
        over "model" runs tensor-parallel; the ranks of a model row then
        return the same loss."""
        t = num_frames or self.num_frames
        n = latents.shape[0]
        videos = global_rows(n, block)[0] // t
        split = mesh is not None and n % t != 0
        network = make_unet_network_fn(self.unet, t, mesh=mesh if split else None,
                                       rows_local=True)
        indicator = torch.zeros((videos if split else n // t, t), device=latents.device)
        if sigma_per_video and sigmas is None:
            sigmas = self.loss_fn.sigma_sampler(
                videos, device=latents.device, generator=generator).repeat_interleave(t)
        per_sample = self.loss_fn(
            network, self.denoiser, cond, latents, sigmas=sigmas, noise=noise,
            generator=generator,
            extra_model_inputs={"image_only_indicator": indicator}, block=block)
        return per_sample.mean()


@torch.no_grad()
def img2img_latents(engine: VideoDiffusionEngine, init_latents: torch.Tensor,
                    c: Dict, uc: Dict, strength: float = 0.6,
                    num_steps: Optional[int] = None,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SDEdit-style partial denoising (video_diffusion.py:261-297; sgm
    inference/helpers.py:243 do_img2img): noise the init latents to the
    level where the last ``round(n * strength)`` steps of the schedule
    begin (Python's round, half to even: 25 x 0.5 runs 12) and run those
    steps.  ``noise`` is the standard-normal draw (from ``generator``
    when not given)."""
    n = num_steps or engine.sampler.num_steps
    run_steps = max(1, int(round(n * strength)))
    sampler = dataclasses.replace(
        engine.sampler,
        discretization=SlicedDiscretization(
            base=engine.sampler.discretization, skip=n - run_steps),
        num_steps=run_steps)
    sigma0 = float(sampler.schedule()[0])
    dev = engine.device
    init_latents = init_latents.to(dev)
    eps = _draw(noise, init_latents.shape, dev, generator)
    # the sampler's prepare() multiplies by sqrt(1 + sigma0^2) again, so
    # it starts from x0 + sigma0 * eps, the do_img2img noising
    scale = 1.0 / torch.sqrt(torch.tensor(1.0 + sigma0**2, device=dev))
    x = (init_latents + sigma0 * eps) * scale
    indicator = torch.zeros((2, engine.num_frames), device=dev)
    network = make_unet_network_fn(engine.unet, engine.num_frames)

    def denoiser_fn(xx, sigma, cond):
        return engine.denoiser(network, xx, sigma, cond,
                               image_only_indicator=indicator)

    return sampler(denoiser_fn, x, c, uc, generator=generator)
