"""VideoUNet, the V3D generator (counterpart of v3d_tpu/models/video_unet.py;
sgm diffusionmodules/video_model.py).

NCHW feature maps in channels_last memory; the batch is ``(b*t)`` with
frames fastest.  Parameter names are the checkpoint's: ``time_embed.{0,2}``,
``label_emb.0.{0,2}``, ``input_blocks.{i}.{j}``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``out.{0,2}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from v3d_tpu_torch.models.layers import (
    AlphaBlender,
    Downsample,
    GroupNorm32,
    ResBlock,
    Upsample,
    from_video,
    timestep_embedding,
    to_video,
)
from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer


class VideoResBlock(ResBlock):
    """A 2-D ResBlock, then a temporal (3,1,1)-conv ResBlock on the video
    view, merged by a learned AlphaBlender (video_model.py:12-81)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__(channels, emb_channels, out_channels, dims=2)
        self.time_stack = ResBlock(out_channels, emb_channels, out_channels,
                                   dims=3, kernel_size=(3, 1, 1),
                                   exchange_temb_dims=True)
        self.time_mixer = AlphaBlender(0.5, "bcthw")

    def forward(self, x, emb, num_frames: int, image_only_indicator):
        x = super().forward(x, emb)
        x5 = to_video(x, num_frames)
        emb5 = emb.reshape(-1, num_frames, emb.shape[-1])
        x_temporal = self.time_stack(x5, emb5)
        return from_video(self.time_mixer(x5, x_temporal, image_only_indicator))


def unet_layer_specs(model_channels: int, channel_mult: Sequence[int],
                     num_res_blocks: int, attention_resolutions: Sequence[int],
                     num_head_channels: int):
    """The UNet skeleton (video_unet.py:70-105): (input_specs, middle_spec,
    output_specs), each block a list of layer descriptors."""
    input_specs = [[("conv_in", model_channels)]]
    input_chans = [model_channels]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [("res", mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_resolutions:
                layers.append(("attn", ch, ch // num_head_channels))
            input_specs.append(layers)
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            ds *= 2
            input_specs.append([("down", ch)])
            input_chans.append(ch)
    middle_spec = [("res", ch), ("attn", ch, ch // num_head_channels), ("res", ch)]
    output_specs = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [("res", model_channels * mult, ich)]
            ch = model_channels * mult
            if ds in attention_resolutions:
                layers.append(("attn", ch, ch // num_head_channels))
            if level and i == num_res_blocks:
                ds //= 2
                layers.append(("up", ch))
            output_specs.append(layers)
    return input_specs, middle_spec, output_specs


class VideoUNet(nn.Module):
    """video_model.py:84-493 with V3D_512.yaml defaults.

    forward(x, timesteps, context, y, num_video_frames, image_only_indicator)
      x          ((b t), in_channels, h, w)   latent + concat-cond channels
      timesteps  ((b t),)                     c_noise
      context    ((b t), s_ctx, context_dim)  CLIP crossattn tokens
      y          ((b t), adm_in_channels)     fps / motion / cond-aug vector
    returns ((b t), out_channels, h, w) in float32.
    """

    def __init__(self, in_channels: int = 8, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, context_dim: int = 1024,
                 adm_in_channels: Optional[int] = 768):
        super().__init__()
        mc = model_channels
        emb_ch = 4 * mc
        self.model_channels = mc
        self.context_dim = context_dim
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        self.adm_in_channels = adm_in_channels
        if adm_in_channels is not None:
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, emb_ch), nn.SiLU(),
                nn.Linear(emb_ch, emb_ch)))


        def build(layers, ch):
            mods = []
            for spec in layers:
                kind = spec[0]
                if kind == "conv_in":
                    mods.append(nn.Conv2d(in_channels, spec[1], 3, padding=1))
                    ch = spec[1]
                elif kind == "res":
                    cin = ch + (spec[2] if len(spec) > 2 else 0)
                    mods.append(VideoResBlock(cin, emb_ch, spec[1]))
                    ch = spec[1]
                elif kind == "attn":
                    mods.append(SpatialVideoTransformer(
                        spec[1], spec[2], num_head_channels, context_dim))
                elif kind == "down":
                    mods.append(Downsample(ch, spec[1]))
                elif kind == "up":
                    mods.append(Upsample(ch, spec[1]))
                else:
                    raise ValueError(kind)
            return nn.ModuleList(mods), ch

        specs_in, spec_mid, specs_out = unet_layer_specs(
            mc, channel_mult, num_res_blocks, attention_resolutions,
            num_head_channels)
        ch = in_channels
        self.input_blocks = nn.ModuleList()
        for layers in specs_in:
            block, ch = build(layers, ch)
            self.input_blocks.append(block)
        self.middle_block, ch = build(spec_mid, ch)
        self.output_blocks = nn.ModuleList()
        for layers in specs_out:
            block, ch = build(layers, ch)
            self.output_blocks.append(block)
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, num_video_frames: int = 1,
                image_only_indicator: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        t = num_video_frames
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dt))
        if self.adm_in_channels is not None:
            if y is None or y.shape[0] != x.shape[0]:
                raise ValueError("vector conditioning y must match the batch")
            emb = emb + self.label_emb(y.to(dt))
        if context is not None:
            context = context.to(dt)

        def run(block, h):
            for layer in block:
                if isinstance(layer, VideoResBlock):
                    h = layer(h, emb, t, image_only_indicator)
                elif isinstance(layer, SpatialVideoTransformer):
                    h = layer(h, context, t, image_only_indicator)
                else:
                    h = layer(h)
            return h

        h = x.to(dt).contiguous(memory_format=torch.channels_last)
        hs = []
        for block in self.input_blocks:
            h = run(block, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for block in self.output_blocks:
            h = run(block, torch.cat([h, hs.pop()], dim=1))
        return self.out(h).float()
