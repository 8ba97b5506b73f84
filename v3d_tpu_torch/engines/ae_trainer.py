"""Autoencoder training (counterpart of v3d_tpu/engines/ae_trainer.py; sgm
models/autoencoder.py AutoencodingEngine with GeneralLPIPSWithDiscriminator,
the manual two-optimizer loop).

Generator step: L1 (or L2) reconstruction (+ ``lpips_fn`` where one is
given) + KL + the adversarial term once ``step >= disc_start``.  The
discriminator runs in every generator step (its term weighted by 0 before
``disc_start``, as the JAX step does), and its parameters collect no
gradient there.  Discriminator step (from ``disc_start`` on): hinge loss on
the real images and a second reconstruction by the updated autoencoder.
Both optimizers are Adam(lr, betas (0.5, 0.9), eps 1e-8), optax.adam's math.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from v3d_tpu_torch.engines.builder import seeded_init_
from v3d_tpu_torch.models.discriminator import (
    NLayerDiscriminator,
    generator_loss,
    hinge_d_loss,
)
from v3d_tpu_torch.models.vae import Decoder, Encoder, gaussian_kl, gaussian_sample


@dataclasses.dataclass
class AETrainConfig:
    lr: float = 4.5e-6
    disc_lr: float = 4.5e-6
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    disc_start: int = 50_000
    recon_loss: str = "l1"


class AutoencoderTrainer:
    """Trains ``encoder`` and ``decoder`` (moved to ``device``) against a
    PatchGAN ``NLayerDiscriminator()`` seeded from ``seed``.  Images are
    (b, H, W, 3) in [-1, 1]; each reconstruction samples the encoder's
    moments with standard-normal noise that ``train_step`` takes explicitly
    or draws from the trainer's generator (seeded from ``seed``)."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 config: AETrainConfig = AETrainConfig(),
                 lpips_fn: Optional[Callable] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = config
        dev = torch.device(device)
        self.encoder = encoder.to(dev).train().requires_grad_(True)
        self.decoder = decoder.to(dev).train().requires_grad_(True)
        self.disc = seeded_init_(NLayerDiscriminator().to(dev), seed)
        self.lpips_fn = lpips_fn
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.ae_params = list(self.encoder.parameters()) + list(self.decoder.parameters())
        self.opt = torch.optim.Adam(self.ae_params, lr=config.lr, betas=(0.5, 0.9),
                                    eps=1e-8)
        self.d_opt = torch.optim.Adam(self.disc.parameters(), lr=config.disc_lr,
                                      betas=(0.5, 0.9), eps=1e-8)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.ae_params[0].device

    def images(self, x) -> torch.Tensor:
        """(b, H, W, 3) images (numpy or tensor) -> NCHW channels-last float32
        on the trainer's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def reconstruct(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """(reconstruction NCHW, moments channels-last) of NCHW ``x``; the
        sample's noise is ``noise`` or drawn from the trainer's generator."""
        moments = self.encoder(x).permute(0, 2, 3, 1)
        if noise is None:
            noise = torch.randn(moments.shape[:-1] + (moments.shape[-1] // 2,),
                                device=x.device, generator=self.generator)
        z = gaussian_sample(moments, noise.to(x.device))
        return self.decoder(z.permute(0, 3, 1, 2)), moments

    def generator_loss(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                       use_disc: float = 1.0):
        """The generator step's objective on NCHW ``x`` (ae_trainer.py:68-80):
        (total, {"rec", "kl", "g"}), the adversarial term weighted by
        ``use_disc`` (0 or 1)."""
        recon, moments = self.reconstruct(x, noise)
        if self.cfg.recon_loss == "l1":
            rec = (recon - x).abs().mean()
        else:
            rec = ((recon - x) ** 2).mean()
        if self.lpips_fn is not None:
            rec = rec + self.lpips_fn(((recon + 1) / 2).permute(0, 2, 3, 1),
                                      ((x + 1) / 2).permute(0, 2, 3, 1))
        kl = gaussian_kl(moments).mean()
        g = generator_loss(self.disc(recon))
        total = rec + self.cfg.kl_weight * kl + use_disc * self.cfg.disc_weight * g
        return total, {"rec": rec, "kl": kl, "g": g}

    def train_step(self, x, noise: Optional[torch.Tensor] = None,
                   disc_noise: Optional[torch.Tensor] = None) -> Dict:
        """One generator step on (b, H, W, 3) images in [-1, 1] and, from
        ``disc_start`` on, one discriminator step; ``noise`` / ``disc_noise``
        are their reconstructions' draws, each the shape of the latent (b,
        h, w, z_channels)."""
        x = self.images(x)
        use_disc = 1.0 if self.step >= self.cfg.disc_start else 0.0
        total, logs = self.generator_loss(x, noise, use_disc)
        for p, grad in zip(self.ae_params, torch.autograd.grad(total, self.ae_params)):
            p.grad = grad
        self.opt.step()
        out = {"loss": float(total.detach()),
               **{k: float(v.detach()) for k, v in logs.items()}}
        if use_disc:
            with torch.no_grad():
                recon, _ = self.reconstruct(x, disc_noise)
            self.d_opt.zero_grad(set_to_none=True)
            d_loss = hinge_d_loss(self.disc(x), self.disc(recon))
            d_loss.backward()
            self.d_opt.step()
            out["d_loss"] = float(d_loss.detach())
        self.step += 1
        return out
