"""Latent regularizers (counterpart of v3d_tpu/models/regularizers.py; sgm
autoencoding/regularizers: DiagonalGaussianRegularizer :13 and the
quantize.py VQ family :64-487).

Each maps channels-last encoder output to (z, log dict).  The VQ uses the
straight-through estimator with codebook + commitment losses.  (The JAX
package registers them by name; the port's registry comes with the config
system, ROADMAP Queue A item 6.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.models.vae import gaussian_kl, gaussian_mode, gaussian_sample


@register("diagonal_gaussian_regularizer")
@dataclasses.dataclass(frozen=True)
class DiagonalGaussianRegularizer:
    """regularizers.py:20-34: a sample of the moments (or their mean), and
    the batch mean of the KL to N(0, 1)."""

    sample: bool = True

    def __call__(self, moments: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """``noise``: the standard normal of the sample, explicit or drawn
        from ``generator``."""
        if self.sample:
            if noise is None:
                shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
                noise = torch.randn(shape, device=moments.device,
                                    generator=generator)
            z = gaussian_sample(moments, noise)
        else:
            z = gaussian_mode(moments)
        return z, {"kl_loss": gaussian_kl(moments).mean()}


class VectorQuantizer:
    """quantize.py:64-200 core (regularizers.py:36-69): nearest-codebook
    lookup with straight-through gradients.  The codebook is an explicit
    (n_e, e_dim) tensor that the caller holds."""

    def __init__(self, n_e: int = 8192, e_dim: int = 4, beta: float = 0.25):
        self.n_e = n_e
        self.e_dim = e_dim
        self.beta = beta

    def init_codebook(self, generator: Optional[torch.Generator] = None,
                      device="cpu") -> torch.Tensor:
        """Uniform(-1/n_e, 1/n_e) entries."""
        u = torch.rand((self.n_e, self.e_dim), generator=generator, device=device)
        return (2.0 * u - 1.0) / self.n_e

    def __call__(self, codebook: torch.Tensor, z: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict]:
        """z (..., e_dim) -> quantized z of the same shape, and the logs
        (``vq_loss``, ``perplexity``, ``indices``)."""
        flat = z.reshape(-1, self.e_dim)
        # |z|^2 - 2 z.c + |c|^2, in the JAX order; argmin takes the first of ties
        d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ codebook.T
             + (codebook ** 2).sum(1)[None, :])
        idx = torch.argmin(d, dim=1)
        z_q = codebook[idx].reshape(z.shape)
        commit = ((z_q.detach() - z) ** 2).mean()
        codebook_loss = ((z_q - z.detach()) ** 2).mean()
        loss = codebook_loss + self.beta * commit
        z_q = z + (z_q - z).detach()
        probs = F.one_hot(idx, self.n_e).to(z.dtype).mean(0)
        perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
        return z_q, {"vq_loss": loss, "perplexity": perplexity, "indices": idx}
