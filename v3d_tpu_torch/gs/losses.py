"""3DGS training losses (counterpart of v3d_tpu/gs/losses.py, itself of
recon/utils/loss_utils.py): L1, SSIM (11x11 gaussian window, sigma 1.5,
C1=0.01^2, C2=0.03^2) and PSNR.

SSIM is the reference's depthwise convolution with the 11x11 window,
zero-padded SAME (the JAX package's banded matmuls are a TPU recast of the
same filter).  Its variance terms are cancellations (m11 - mu1^2 is ~1e-4 in
flat regions), so the convolution runs in full float32: TF32 (cuDNN's default
for float32 convolutions) leaves the SSIM map as noise and the loss can go
negative.  ``ssim`` turns TF32 off for its convolution and its gradient
whatever the global flags say (``utils.precision.conv2d_f32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from v3d_tpu_torch.utils.precision import conv2d_f32


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The window on ``device``, made once: a step captured in a CUDA graph
    reads it and may not copy it from the host."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32)).to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of (H, W, C) or (N, H, W, C) images in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    n, h, w, c = img1.shape
    # the five filtered maps as 5*C channels of one depthwise convolution
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                      dim=-1).permute(0, 3, 1, 2)
    win = _gaussian_window(size, sigma, stack.device)
    weight = win.expand(5 * c, 1, size, size)
    f = conv2d_f32(stack, weight, padding=size // 2, groups=5 * c)
    mu1, mu2, m11, m22, m12 = f.split(c, dim=1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = m11 - mu1_sq
    s2 = m22 - mu2_sq
    s12 = m12 - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return ssim_map.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """recon/utils/image_utils.py psnr (per-image MSE over flattened)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
