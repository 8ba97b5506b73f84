"""U2Net salient-object segmentation, the rembg background-removal model
(counterpart of v3d_tpu/models/u2net.py; xuebinqin/U-2-Net, run by the
reference through rembg at scripts/pub/V3D_512.py:17,210).

Parameters are named as U-2-Net's ``u2net.pth`` / ``u2netp.pth`` name them
(``stageN[d].rebnconvM[d].conv_s1.*``, ``bn_s1.*`` with running statistics,
``sideN.*``, ``outconv.*``), so those files load strictly with no
converter.  BatchNorm runs in eval mode only: ``(x - mean) * rsqrt(var +
1e-5) * scale + bias``.  Resizes are the JAX package's bilinear matrices
(``models.dpt.resize``), not ``F.interpolate``.

``u2net_matte`` is rembg's protocol: scale by the image max, ImageNet
mean / std, resize to 320^2, forward, fused output d0, min-max normalise,
resize back, alpha as uint8.  ``load_u2net`` finds the weights or returns
None.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.dpt import resize


def _maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, stride=2, ceil_mode=True): an odd edge's last window
    holds one row / column (the JAX package pads it with -inf)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return resize(src, tuple(tar.shape[2:]), "bilinear")


class REBNCONV(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        bn = self.bn_s1
        x = self.conv_s1(x)
        scale = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
        x = (x - bn.running_mean[:, None, None]) * scale[:, None, None] \
            + bn.bias[:, None, None]
        return F.relu(x)


class RSU(nn.Module):
    """RSU-L (L = height): a small UNet returning hx1d + hxin."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = []
        hx = hxin
        for i in range(1, self.height):
            hx = getattr(self, f"rebnconv{i}")(hx)
            enc.append(hx)
            if i < self.height - 1:
                hx = _maxpool_ceil(hx)
        hx = getattr(self, f"rebnconv{self.height}")(enc[-1])
        for i in range(self.height - 1, 0, -1):
            hx = getattr(self, f"rebnconv{i}d")(torch.cat([hx, enc[i - 1]], 1))
            if i > 1:
                hx = _upsample_like(hx, enc[i - 2])
        return hx + hxin


class RSU4F(nn.Module):
    """Dilated (pool-free) RSU."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], 1))
        return hx1d + hxin


class U2Net(nn.Module):
    """Full U2Net (``small=False``, 44.0M parameters) or u2netp
    (``small=True``), out_ch 1.  (n, 3, H, W) -> the sigmoid maps (d0, d1,
    ..., d6) at input resolution; d0, the fused side output, is the mask."""

    def __init__(self, out_ch: int = 1, small: bool = False):
        super().__init__()
        if small:
            enc = [(7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64), (4, 64, 16, 64),
                   (64, 16, 64), (64, 16, 64)]
            dec = [(128, 16, 64), (4, 128, 16, 64), (5, 128, 16, 64),
                   (6, 128, 16, 64), (7, 128, 16, 64)]
            side = (64, 64, 64, 64, 64, 64)
        else:
            enc = [(7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256),
                   (4, 256, 128, 512), (512, 256, 512), (512, 256, 512)]
            dec = [(1024, 256, 512), (4, 1024, 128, 256), (5, 512, 64, 128),
                   (6, 256, 32, 64), (7, 128, 16, 64)]
            side = (64, 64, 128, 256, 512, 512)

        def block(args):
            return RSU(*args) if len(args) == 4 else RSU4F(*args)

        for i, args in enumerate(enc, 1):
            setattr(self, f"stage{i}", block(args))
        for i, args in zip((5, 4, 3, 2, 1), dec):
            setattr(self, f"stage{i}d", block(args))
        for i, ch in enumerate(side, 1):
            setattr(self, f"side{i}", nn.Conv2d(ch, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        hx1 = self.stage1(x)
        hx2 = self.stage2(_maxpool_ceil(hx1))
        hx3 = self.stage3(_maxpool_ceil(hx2))
        hx4 = self.stage4(_maxpool_ceil(hx3))
        hx5 = self.stage5(_maxpool_ceil(hx4))
        hx6 = self.stage6(_maxpool_ceil(hx5))
        hx5d = self.stage5d(torch.cat([_upsample_like(hx6, hx5), hx5], 1))
        hx4d = self.stage4d(torch.cat([_upsample_like(hx5d, hx4), hx4], 1))
        hx3d = self.stage3d(torch.cat([_upsample_like(hx4d, hx3), hx3], 1))
        hx2d = self.stage2d(torch.cat([_upsample_like(hx3d, hx2), hx2], 1))
        hx1d = self.stage1d(torch.cat([_upsample_like(hx2d, hx1), hx1], 1))
        d1 = self.side1(hx1d)
        sides = [d1] + [_upsample_like(getattr(self, f"side{i}")(h), d1)
                        for i, h in zip(range(2, 7), (hx2d, hx3d, hx4d, hx5d, hx6))]
        d0 = self.outconv(torch.cat(sides, 1))
        return tuple(torch.sigmoid(d) for d in [d0] + sides)


# ImageNet statistics of rembg's normalisation
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@torch.no_grad()
def u2net_matte(model: U2Net, image: np.ndarray, infer_size: int = 320) -> np.ndarray:
    """rembg's mask protocol on the model's device: (H, W, 3) uint8 ->
    RGBA uint8 with the min-max normalised d0 of a 320^2 inference as
    alpha."""
    dev = next(model.parameters()).device
    img = np.asarray(image)[..., :3]
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    x = x / max(float(x.max()), 1e-6)
    x = (x - _MEAN) / _STD
    xr = resize(torch.from_numpy(x).to(dev).permute(2, 0, 1)[None],
                (infer_size, infer_size), "bilinear")
    pred = model(xr)[0][0, 0]
    mn, mx = float(pred.min()), float(pred.max())
    pred = (pred - mn) / max(mx - mn, 1e-8)
    mask = resize(pred[None, None], (h, w), "bilinear")[0, 0].cpu().numpy()
    alpha = np.clip(mask * 255.0, 0, 255).astype(np.uint8)
    return np.concatenate([img.astype(np.uint8), alpha[..., None]], axis=-1)


def load_u2net(path: Optional[str] = None, small: Optional[bool] = None,
               device="cuda") -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """A rembg-signature callable ``image -> RGBA`` running U2Net on
    ``device`` (the card unless the caller asks for the CPU), or None when
    no weights are found.  Search order: ``path``, $V3D_U2NET_CKPT, then
    ``ckpts/u2net{,p}{.orbax,.pth}``.  A ``u2net.pth`` / ``u2netp.pth``
    state dict loads strictly; an orbax tree (the JAX package's converted
    format) is refused.  ``small`` (u2netp) is read from
    ``stage2.rebnconvin``'s output channels (64, against 128) unless
    given."""
    candidates = [path, os.environ.get("V3D_U2NET_CKPT")]
    for stem in ("u2net", "u2netp"):
        for ext in (".orbax", ".pth"):
            candidates.append(os.path.join("ckpts", stem + ext))
    found = next((c for c in candidates if c and os.path.exists(c)), None)
    if found is None:
        return None
    if os.path.isdir(found):
        raise ValueError(
            f"{found} is an orbax tree of the JAX package's converted U2Net; "
            "this package reads the U-2-Net state dict (u2net.pth / u2netp.pth)")
    sd = torch.load(found, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if small is None:
        small = int(sd["stage2.rebnconvin.conv_s1.weight"].shape[0]) == 64
    model = U2Net(small=small)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval().requires_grad_(False)

    def remove_bg(image: np.ndarray) -> np.ndarray:
        return u2net_matte(model, image)

    remove_bg.kind = "u2net"  # type: ignore[attr-defined]
    return remove_bg
