"""The reference first stage: a frozen copy of ``v3d_tpu_torch/models/vae.py``
(encoder, image decoder, temporal video decoder) in plain float32 PyTorch,
with the port's parameter names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    Conv2d,
    Conv3d,
    GroupNorm32,
    ResBlock,
    from_tokens,
    from_video,
    softmax_attention,
    to_tokens,
    to_video,
)
from portbench.reference.numerics import F32


def vae_norm(channels: int, act=None) -> GroupNorm32:
    return GroupNorm32(channels, eps=1e-6, act=act)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = vae_norm(in_channels, "silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = vae_norm(out_channels, "silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h*w tokens, d = channels; the
    1x1 convolutions applied as matrices on the tokens."""

    num = F32

    def __init__(self, channels: int):
        super().__init__()
        self.norm = vae_norm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def _dense(self, conv, x):
        return F.linear(self.num.q(x), self.num.q(conv.weight[:, :, 0, 0]), conv.bias.float())

    def forward(self, x):
        _, _, h, w = x.shape
        tok = to_tokens(self.norm(x))
        out = softmax_attention(*(self._dense(m, tok) for m in (self.q, self.k, self.v)),
                                self.num)
        return x + from_tokens(self._dense(self.proj_out, out), h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    def __init__(self, blocks, resample_name: Optional[str], resample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList()
        if resample_name:
            setattr(self, resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, block_1, attn_1, block_2):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = block_1, attn_1, block_2


class Encoder(nn.Module):
    """(n, 3, H, W) in [-1, 1] -> (n, 2 z, H/8, W/8) moments; attention in
    the middle only (V3D's and SD's first stage)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        block_in = ch
        for i, mult in enumerate(ch_mult):
            block_in, block_out = ch * in_mult[i], ch * mult
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else "downsample",
                                    None if last else Downsample(block_in)))
        self.mid = _Mid(ResnetBlock(block_in), AttnBlock(block_in), ResnetBlock(block_in))
        self.norm_out = vae_norm(block_in, "silu")
        self.conv_out = Conv2d(block_in, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.float())
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h))


class VideoResBlockAE(ResnetBlock):
    """A ResnetBlock, then a temporal (3, 1, 1) ResBlock without embedding,
    mixed as sigmoid(mix) * temporal + (1 - sigmoid(mix)) * spatial."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels)
        self.time_stack = ResBlock(out_channels, 0, out_channels, dims=3,
                                   kernel_size=(3, 1, 1), skip_t_emb=True)
        self.mix_factor = nn.Parameter(torch.tensor([0.0]))

    def forward(self, x, num_frames: int):
        x5 = to_video(super().forward(x), num_frames)
        a = torch.sigmoid(self.mix_factor[0].float())
        return from_video(a * self.time_stack(x5, None) + (1.0 - a) * x5)


class AE3DConv(Conv2d):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.time_mix_conv = Conv3d(out_channels, out_channels, (3, 1, 1),
                                    padding=(1, 0, 0))

    def forward(self, x, num_frames: int):
        return from_video(self.time_mix_conv(to_video(super().forward(x), num_frames)))


class Decoder(nn.Module):
    """(n, z, h, w) -> (n, out_ch, 8 h, 8 w); attention in the middle only."""

    resblock = ResnetBlock

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(self.resblock(block_in, block_in), AttnBlock(block_in),
                        self.resblock(block_in, block_in))
        levels = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(self.resblock(block_in, block_out))
                block_in = block_out
            levels[i] = _Level(blocks, "upsample" if i else None,
                               Upsample(block_in) if i else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = vae_norm(block_in, "silu")
        self.conv_out = self.make_conv_out(block_in, out_ch)

    @staticmethod
    def make_conv_out(block_in: int, out_ch: int) -> nn.Module:
        return Conv2d(block_in, out_ch, 3, padding=1)

    def decode(self, z, *extra):
        h = self.conv_in(z.float())
        h = self.mid.block_1(h, *extra)
        h = self.mid.block_2(self.mid.attn_1(h), *extra)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, *extra)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h), *extra)

    def forward(self, z):
        return self.decode(z)


class VideoDecoder(Decoder):
    """The temporal decoder ("conv-only" time mode): every ResnetBlock has a
    temporal stack and conv_out is an AE3DConv; ``num_frames`` frames a
    video."""

    resblock = VideoResBlockAE
    make_conv_out = AE3DConv

    def forward(self, z, num_frames: int):
        return self.decode(z, num_frames)


def gaussian_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Channels-last moments -> mean + exp(logvar / 2) noise, logvar
    clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
