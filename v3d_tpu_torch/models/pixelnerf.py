"""PixelNeRF conditioner (counterpart of v3d_tpu/models/pixelnerf.py; sgm
modules/encoders/pixelnerf.py RayGenerator :62, RaySampler :161, PixelNeRF
:296, and the small UNet of encoders/image_encoder_v2.py).

The camera-conditioned V3D variant feeds each target view a PixelNeRF
rendering (rgb + features) as extra UNet concat channels;
``diffusion.loss.StandardDiffusionLossWithPixelNeRFLoss`` trains the rgb
head.  All views at once: rays for every target view, stratified samples,
features gathered bilinearly from the source image's feature map.  Names
follow the JAX tree (``encoder``, ``mlp1``, ``mlp2``, ``density_head``,
``rgb_head``); the ResUNet encoder keeps its checkpoint's names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.pixelnerf_encoder import ResUNet


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SmallUNetEncoder(nn.Module):
    """image_encoder_v2.py:11: a compact UNet, (n, 3, H, W) -> (n, features,
    H, W) (H, W multiples of 4)."""

    def __init__(self, features: int = 64, in_channels: int = 3):
        super().__init__()
        f = features
        self.enc1 = nn.Conv2d(in_channels, f, 3, padding=1)
        self.enc2 = nn.Conv2d(f, 2 * f, 3, stride=2, padding=1)
        self.enc3 = nn.Conv2d(2 * f, 4 * f, 3, stride=2, padding=1)
        self.dec2 = nn.Conv2d(4 * f + 2 * f, 2 * f, 3, padding=1)
        self.dec1 = nn.Conv2d(2 * f + f, f, 3, padding=1)

    def forward(self, x):
        e1 = F.silu(self.enc1(x))
        e2 = F.silu(self.enc2(e1))
        e3 = F.silu(self.enc3(e2))
        d2 = F.silu(self.dec2(torch.cat([_up2(e3), e2], dim=1)))
        return F.silu(self.dec1(torch.cat([_up2(d2), e1], dim=1)))


def generate_rays(c2w: torch.Tensor, K: torch.Tensor, h: int, w: int):
    """RayGenerator (pixelnerf.py:62) for a batch of cameras, OpenCV
    convention (+z forward): c2w (V, 4, 4), K (V, 3, 3) -> rays_o, rays_d
    (V, h, w, 3), directions of unit length."""
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=c2w.device),
                          torch.arange(w, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    k = K[:, None, None]
    dirs = torch.stack([(i + 0.5 - k[..., 0, 2]) / k[..., 0, 0],
                        (j + 0.5 - k[..., 1, 2]) / k[..., 1, 1],
                        torch.ones_like(i).expand(len(K), h, w)], -1)
    rays_d = torch.einsum("vhwj,vij->vhwi", dirs, c2w[:, :3, :3])
    rays_d = rays_d / (rays_d.norm(dim=-1, keepdim=True) + 1e-12)
    return c2w[:, None, None, :3, 3].expand_as(rays_d), rays_d


def project_to_source(pts: torch.Tensor, src_w2c: torch.Tensor,
                      src_K: torch.Tensor, h: int, w: int):
    """World points (..., 3) -> source-view pixel coordinates uv in [0, 1]
    (u divided by ``w``, v by ``h``) and their validity (in front of the
    camera, inside the image)."""
    p = pts @ src_w2c[:3, :3].T + src_w2c[:3, 3]
    z = p[..., 2]
    zc = z.clamp_min(1e-6)
    u = (p[..., 0] / zc * src_K[0, 0] + src_K[0, 2]) / w
    v = (p[..., 1] / zc * src_K[1, 1] + src_K[1, 2]) / h
    valid = (z > 1e-4) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return torch.stack([u, v], -1), valid


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C), uv (..., 2) in [0, 1] -> (..., C).  The corner index
    is clamped to W - 2 / H - 2, so u = 1 reads the last column with weight
    fx = 1 (pixelnerf.py:74-90)."""
    h, w, _ = feat.shape
    x = uv[..., 0] * (w - 1)
    y = uv[..., 1] * (h - 1)
    x0 = x.floor().long().clamp(0, w - 2)
    y0 = y.floor().long().clamp(0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return ((1 - fy) * ((1 - fx) * feat[y0, x0] + fx * feat[y0, x0 + 1])
            + fy * ((1 - fx) * feat[y0 + 1, x0] + fx * feat[y0 + 1, x0 + 1]))


class PixelNeRF(nn.Module):
    """pixelnerf.py:296: render (rgb, features) for target views conditioned
    on one source view."""

    def __init__(self, num_samples: int = 32, near: float = 0.5, far: float = 3.5,
                 feat_dim: int = 64, out_feature_dim: int = 4,
                 encoder_type: str = "small_unet"):
        super().__init__()
        self.num_samples, self.near, self.far = num_samples, near, far
        if encoder_type == "resunet":
            half = feat_dim // 2
            self.encoder = ResUNet(coarse_out_ch=half, fine_out_ch=feat_dim - half)
        elif encoder_type == "small_unet":
            self.encoder = SmallUNetEncoder(feat_dim)
        else:
            raise ValueError(f"encoder_type must be 'small_unet' or 'resunet', "
                             f"got {encoder_type!r}")
        self.mlp1 = nn.Linear(feat_dim, 128)
        self.mlp2 = nn.Linear(128, 128)
        self.density_head = nn.Linear(128, 1)
        self.rgb_head = nn.Linear(128, 3 + out_feature_dim)

    def forward(self, src_image: torch.Tensor, src_w2c: torch.Tensor,
                src_K: torch.Tensor, tgt_c2ws: torch.Tensor, tgt_Ks: torch.Tensor,
                out_hw: Tuple[int, int], jitter: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """src_image (H, W, 3) in [-1, 1]; tgt_c2ws (V, 4, 4) OpenCV,
        tgt_Ks (V, 3, 3) at the source's resolution -> (rgb (V, h, w, 3),
        feats (V, h, w, out_feature_dim)).  The stratified jitter is one
        uniform (num_samples,) vector shared by every ray: ``jitter``, or
        drawn from ``generator``; with neither, no jitter (the JAX call
        without an rng)."""
        H, W = src_image.shape[:2]
        dev = src_image.device
        feat_map = self.encoder(src_image.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        h, w = out_hw
        s = torch.linspace(0.0, 1.0, self.num_samples, device=dev)
        if jitter is None and generator is not None:
            jitter = torch.rand(self.num_samples, device=dev, generator=generator)
        if jitter is not None:
            s = s + jitter.to(dev) / self.num_samples
        t_vals = self.near + (self.far - self.near) * s
        scale = torch.tensor([[w / W, 0, 0], [0, h / H, 0], [0, 0, 1.0]], device=dev)
        rays_o, rays_d = generate_rays(tgt_c2ws, scale @ tgt_Ks, h, w)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * t_vals[:, None]
        # the JAX call passes (W, H) into (h, w) (pixelnerf.py:135): matched
        uv, valid = project_to_source(pts, src_w2c, src_K, W, H)
        f = torch.where(valid[..., None], bilinear_sample(feat_map, uv), 0.0)
        x = F.silu(self.mlp2(F.silu(self.mlp1(f))))
        sigma = torch.where(valid, F.softplus(self.density_head(x)[..., 0]), 0.0)
        rgbf = self.rgb_head(x)
        alpha = 1 - torch.exp(-sigma * (self.far - self.near) / self.num_samples)
        trans = torch.cumprod(1 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
        out = ((alpha * trans)[..., None] * rgbf).sum(dim=-2)
        return out[..., :3], out[..., 3:]
