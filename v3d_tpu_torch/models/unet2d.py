"""The image (2-D) UNet, the SD / SDXL generator family (counterpart of
v3d_tpu/models/unet2d.py; sgm diffusionmodules/openaimodel.py:482-863
``UNetModel``), driven by ``engines/image_diffusion.py``.

The spatial-only sibling of the VideoUNet: the same skeleton
(``unet_layer_specs``) of plain ResBlocks and SpatialTransformers, no
temporal stacks.  NCHW feature maps in channels_last memory; parameter names
are sgm's checkpoint's: ``time_embed.{0,2}``, ``label_emb.0.{0,2}``,
``input_blocks.N.M.*``, ``middle_block.N.*``, ``output_blocks.N.M.*``,
``out.{0,2}``.  Self-attention over >= 1024 tokens at d = 64 reaches K1 on
the card through the dispatcher; cross-attention takes the plain route.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.models.attention_blocks import SpatialTransformer
from v3d_tpu_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm32,
    Linear,
    ResBlock,
    Upsample,
    timestep_embedding,
)
from v3d_tpu_torch.models.video_unet import unet_layer_specs


@register("unet2d")
class UNetModel(nn.Module):
    """openaimodel.py:482-863 with the JAX package's defaults (SD 2.1's
    network: 320 channels, mult (1, 2, 4, 4), attention at ds 1 / 2 / 4,
    64-wide heads, context 1024, linear projections).

    forward(x, timesteps, context, y)
      x          (n, in_channels, h, w)
      timesteps  (n,)
      context    (n, s_ctx, context_dim) cross-attention tokens
      y          (n, adm_in_channels) class / vector conditioning
    returns (n, out_channels, h, w) in float32.  The JAX module's
    ``use_checkpoint`` (rematerialisation for training) is not taken: the
    port runs this UNet for inference only."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: Optional[int] = 1024,
                 adm_in_channels: Optional[int] = None,
                 use_scale_shift_norm: bool = False,
                 use_linear_in_transformer: bool = True):
        super().__init__()
        mc = model_channels
        emb_ch = 4 * mc
        self.model_channels = mc
        self.context_dim = context_dim
        self.adm_in_channels = adm_in_channels
        self.use_linear_in_transformer = use_linear_in_transformer
        self.time_embed = nn.Sequential(Linear(mc, emb_ch), nn.SiLU(),
                                        Linear(emb_ch, emb_ch))
        if adm_in_channels is not None:
            self.label_emb = nn.Sequential(nn.Sequential(
                Linear(adm_in_channels, emb_ch), nn.SiLU(),
                Linear(emb_ch, emb_ch)))

        def build(layers, ch):
            mods = []
            for spec in layers:
                kind = spec[0]
                if kind == "conv_in":
                    mods.append(Conv2d(in_channels, spec[1], 3, padding=1))
                    ch = spec[1]
                elif kind == "res":
                    cin = ch + (spec[2] if len(spec) > 2 else 0)
                    mods.append(ResBlock(cin, emb_ch, spec[1],
                                         use_scale_shift_norm=use_scale_shift_norm))
                    ch = spec[1]
                elif kind == "attn":
                    mods.append(SpatialTransformer(
                        spec[1], spec[2], num_head_channels, transformer_depth,
                        context_dim, use_linear=use_linear_in_transformer))
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
        self.out = nn.Sequential(GroupNorm32(ch, act="silu"), nn.Identity(),
                                 Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dt))
        if self.adm_in_channels is not None:
            if y is None or y.shape[0] != x.shape[0]:
                raise ValueError("vector conditioning y must match the batch")
            emb = emb + self.label_emb(y.to(dt))
        if context is not None:
            context = context.to(dt)

        def run(block, h):
            for layer in block:
                if isinstance(layer, ResBlock):
                    h = layer(h, emb)
                elif isinstance(layer, SpatialTransformer):
                    h = layer(h, context)
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
