"""ResUNet image encoder of the PixelNeRF conditioner (counterpart of
v3d_tpu/models/pixelnerf_encoder.py; sgm/modules/encoders/image_encoder.py
:200-349, whose state-dict names it takes).

- Every conv pads by reflection (image_encoder.py:38, :50, :175).
- BatchNorm without running statistics: the batch's own biased statistics,
  eps 1e-5, at training and at inference alike.
- The encoder is resnet34's stem and layers 1-3 (BasicBlocks [3, 4, 6]) with
  no max-pool after the stem and stride 2 in every layer's first block, so
  the output is H/4; ReLU there, ELU in the decoder (image_encoder.py:165-184).
- 2x bilinear upsampling with align_corners=True (upconv :187-197), by the
  resize matrices of ``models/dpt.py``.
- A skip pads the *encoder* feature to the upsampled one's size by
  (d // 2, d - d // 2) and concatenates [upsampled, encoder] (:313-343).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.dpt import resize


class ReflectConv(nn.Conv2d):
    """A square conv with (k - 1) // 2 reflection padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=(kernel - 1) // 2, padding_mode="reflect", bias=bias)


class BatchStatNorm(nn.BatchNorm2d):
    """torch BatchNorm2d(track_running_stats=False): normalise by the
    current batch's (N, H, W) statistics, affine."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, track_running_stats=False)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = ReflectConv(inplanes, planes, 3, stride, bias=False)
        self.bn1 = BatchStatNorm(planes)
        self.conv2 = ReflectConv(planes, planes, 3, bias=False)
        self.bn2 = BatchStatNorm(planes)
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                ReflectConv(inplanes, planes, 1, stride, bias=False),
                BatchStatNorm(planes))

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(y + identity)


class ConvBnElu(nn.Module):
    """image_encoder.py's ``conv``: conv, BatchNorm, ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = ReflectConv(in_channels, out_channels, kernel, stride)
        self.bn = BatchStatNorm(out_channels)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class _UpConv(nn.Module):
    """image_encoder.py's ``upconv``: a 2x align-corners bilinear upsample,
    then its ``conv``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvBnElu(in_channels, out_channels, 3)

    def forward(self, x):
        h, w = x.shape[2:]
        return self.conv(resize(x, (2 * h, 2 * w), "bilinear_ac"))


def _skip(z, s):
    dy, dx = z.shape[2] - s.shape[2], z.shape[3] - s.shape[3]
    s = F.pad(s, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([z, s], dim=1)


class ResUNet(nn.Module):
    """(N, 3, H, W) -> (N, coarse_out_ch + fine_out_ch, H/4, W/4)."""

    def __init__(self, coarse_out_ch: int = 32, fine_out_ch: int = 32,
                 layers: Sequence[int] = (3, 4, 6)):
        super().__init__()
        out_ch = coarse_out_ch + fine_out_ch
        self.conv1 = ReflectConv(3, 64, 7, 2, bias=False)
        self.bn1 = BatchStatNorm(64)
        inplanes = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256), layers)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(BasicBlock(inplanes, planes, 2 if bi == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.upconv3 = _UpConv(256, 128)
        self.iconv3 = ConvBnElu(128 + 128, 128, 3)
        self.upconv2 = _UpConv(128, 64)
        self.iconv2 = ConvBnElu(64 + 64, out_ch, 3)
        self.out_conv = ReflectConv(out_ch, out_ch, 1)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(y)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        y = self.iconv3(_skip(self.upconv3(x3), x2))
        y = self.iconv2(_skip(self.upconv2(y), x1))
        return self.out_conv(y)
