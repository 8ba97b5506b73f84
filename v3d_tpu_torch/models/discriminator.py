"""PatchGAN discriminator and the adversarial losses of autoencoder
training (counterpart of v3d_tpu/models/discriminator.py; sgm
autoencoding/losses/discriminator_loss.py GeneralLPIPSWithDiscriminator).

Parameter names follow the JAX tree (``conv_in``, ``conv_{i}``,
``GroupNorm_{i-1}``, ``conv_out``): no published checkpoint has this form,
since the JAX package's discriminator normalises with GroupNorm where
taming's uses BatchNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class NLayerDiscriminator(nn.Module):
    """discriminator.py:16-40: 4x4 convs with padding 1, stride 2 but for the
    last two, each but the first followed by GroupNorm (min(32, channels)
    groups, eps 1e-6: flax's default) and a leaky ReLU of slope 0.2.  NCHW
    images -> (n, 1, h', w') logits; a 256^2 image gives a 30x30 map."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        c = ndf
        for i in range(1, n_layers + 1):
            out = ndf * min(2 ** i, 8)
            setattr(self, f"conv_{i}", nn.Conv2d(c, out, 4, stride=2 if i < n_layers else 1,
                                                 padding=1))
            setattr(self, f"GroupNorm_{i - 1}", nn.GroupNorm(min(32, out), out, eps=1e-6))
            c = out
        self.conv_out = nn.Conv2d(c, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_in(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"GroupNorm_{i - 1}")(getattr(self, f"conv_{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def generator_loss(logits_fake):
    return -logits_fake.mean()


def adaptive_weight(nll_grad_norm, g_grad_norm, max_w: float = 1e4):
    """||grad nll|| / ||grad g||, clipped to [0, max_w]
    (discriminator_loss.py's adaptive adversarial weight)."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0, max_w)
