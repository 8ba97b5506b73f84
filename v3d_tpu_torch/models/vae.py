"""VAE encoder and temporal video decoder (counterpart of v3d_tpu/models/vae.py;
sgm diffusionmodules/model.py and autoencoding/temporal_ae.py).

NCHW in channels_last memory.  V3D's first stage: ch 128, ch_mult (1,2,4,4),
2 res blocks, mid attention only, z_channels 4 (double_z), decoder in
"conv-only" time mode with (3,1,1) temporal kernels.  Parameter names follow
the checkpoint (``down.{i}.block.{j}``, ``mid.attn_1.q``, ``up.{i}.upsample``,
``conv_out.time_mix_conv``, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.attention_blocks import from_tokens, to_tokens
from v3d_tpu_torch.models.layers import (
    GroupNorm32,
    ResBlock,
    from_video,
    to_video,
)
from v3d_tpu_torch.ops.attention import attention_plain


def vae_norm(channels: int) -> GroupNorm32:
    return GroupNorm32(channels, eps=1e-6)


class ResnetBlock(nn.Module):
    """model.py:144-186: GN-SiLU-conv twice with a 1x1 nin_shortcut."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = vae_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = vae_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """model.py:161-203: single-head self-attention over the h*w tokens with
    d = channels; q/k/v/proj_out are 1x1 convs in the checkpoint, applied as
    matmuls on the tokens.  The plain formula, as in the JAX package (its
    flash pick needs d = 64)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = vae_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    @staticmethod
    def _dense(conv: nn.Conv2d, x):
        return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)

    def forward(self, x):
        n, c, h, w = x.shape
        tok = to_tokens(self.norm(x))
        q, k, v = (self._dense(m, tok).view(n, h * w, 1, c)
                   for m in (self.q, self.k, self.v))
        out = attention_plain(q, k, v).reshape(n, h * w, c)
        return x + from_tokens(self._dense(self.proj_out, out), h, w)


class Downsample(nn.Module):
    """model.py:73-90: stride-2 3x3 conv with a (0, 1) right/bottom pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` and an optional resampler."""

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
    """model.py:487-604.  (n, 3, H, W) in [-1, 1] -> (n, 2*z, H/8, W/8)
    moments (double_z)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4, double_z: bool = True):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
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
        self.mid = _Mid(ResnetBlock(block_in), AttnBlock(block_in),
                        ResnetBlock(block_in))
        self.norm_out = vae_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels if double_z
                                  else z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype)
                         .contiguous(memory_format=torch.channels_last))
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class VideoResBlockAE(ResnetBlock):
    """temporal_ae.py:18-84: a ResnetBlock, then a temporal (3,1,1) ResBlock
    without time embedding, merged as sigmoid(mix_factor) * temporal +
    (1 - sigmoid(mix_factor)) * spatial."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels)
        self.time_stack = ResBlock(out_channels, 0, out_channels, dims=3,
                                   kernel_size=(3, 1, 1), skip_t_emb=True)
        self.mix_factor = nn.Parameter(torch.tensor([0.0]))

    def forward(self, x, num_frames: int):
        x5 = to_video(super().forward(x), num_frames)
        a = torch.sigmoid(self.mix_factor[0].float()).to(x5.dtype)
        return from_video(a * self.time_stack(x5, None) + (1.0 - a) * x5)


class AE3DConv(nn.Conv2d):
    """temporal_ae.py:86-108: a 3x3 conv, then a temporal 3-D conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.time_mix_conv = nn.Conv3d(out_channels, out_channels, (3, 1, 1),
                                       padding=(1, 0, 0))

    def forward(self, x, num_frames: int):
        x5 = to_video(super().forward(x), num_frames)
        return from_video(self.time_mix_conv(x5))


class VideoDecoder(nn.Module):
    """temporal_ae.py:293-349 (time_mode "conv-only"): every ResnetBlock has a
    temporal stack and conv_out is an AE3DConv; attention stays spatial.
    (n, z, h, w) -> (n, 3, 8h, 8w), n = a whole number of videos of
    ``num_frames`` frames."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(VideoResBlockAE(block_in, block_in), AttnBlock(block_in),
                        VideoResBlockAE(block_in, block_in))
        levels = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(VideoResBlockAE(block_in, block_out))
                block_in = block_out
            levels[i] = _Level(blocks, "upsample" if i else None,
                               Upsample(block_in) if i else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = vae_norm(block_in)
        self.conv_out = AE3DConv(block_in, out_ch)

    def forward(self, z, num_frames: int):
        h = self.conv_in(z.to(self.conv_in.weight.dtype)
                         .contiguous(memory_format=torch.channels_last))
        h = self.mid.block_1(h, num_frames)
        h = self.mid.block_2(self.mid.attn_1(h), num_frames)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, num_frames)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)), num_frames)


def gaussian_moments_split(moments: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channels-last moments -> (mean, logvar clamped to [-30, 20])
    (distributions.py:31-34)."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def gaussian_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """mean + std * noise, with the standard-normal ``noise`` explicit."""
    mean, logvar = gaussian_moments_split(moments)
    return mean + torch.exp(0.5 * logvar) * noise


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    return gaussian_moments_split(moments)[0]
