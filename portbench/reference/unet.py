"""The reference UNets: a frozen copy of ``v3d_tpu_torch/models/video_unet.py``,
``video_attention.py`` and ``unet2d.py`` in plain float32 PyTorch (the
temporal attentions as their softmax formulas, no kernel), with the port's
parameter names.  ``VideoUNet(use_checkpoint=True)`` recomputes each block in
its backward, as the port does, so that a full-width training step fits; the
arithmetic is the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.layers import (
    AlphaBlender,
    BasicTransformerBlock,
    Conv2d,
    Downsample,
    FeedForward,
    GroupNorm32,
    LayerNormF32,
    Linear,
    ResBlock,
    SpatialTransformer,
    Upsample,
    from_tokens,
    from_video,
    heads_attention,
    softmax_attention,
    timestep_embedding,
    to_tokens,
    to_video,
)
from portbench.reference.numerics import F32


class VideoResBlock(ResBlock):
    """A 2-D ResBlock, then a (3, 1, 1) temporal ResBlock, blended."""

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
        return from_video(self.time_mixer(x5, self.time_stack(x5, emb5),
                                          image_only_indicator))


class _QKVOut(nn.Module):
    num = F32

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))


class TemporalSelfAttention(_QKVOut):
    """Each pixel of (b, t, s, c) tokens attends over the t frames."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__(dim, dim, heads, dim_head)

    def forward(self, x):
        b, t, s, c = x.shape
        h, d = self.heads, self.dim_head

        def split(y):   # (b, t, s, h d) -> (b s h, t, d)
            return y.reshape(b, t, s, h, d).permute(0, 2, 3, 1, 4).reshape(b * s * h, t, d)

        o = softmax_attention(split(self.to_q(x)), split(self.to_k(x)),
                              split(self.to_v(x)), self.num)
        o = o.reshape(b, s, h, t, d).permute(0, 3, 1, 2, 4).reshape(b, t, s, c)
        return self.to_out(o)


class TemporalCrossAttention(_QKVOut):
    """(b, t, s, c) tokens attend to a per-video context (b, s_ctx, c')."""

    def forward(self, x, context):
        b, t, s, c = x.shape
        q = self.to_q(x).reshape(b, t * s, c)
        o = heads_attention(q, self.to_k(context), self.to_v(context),
                            self.heads, self.num)
        return self.to_out(o.reshape(b, t, s, c))


class VideoTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int):
        super().__init__()
        inner = n_heads * d_head
        self.is_res = inner == dim
        self.norm_in = LayerNormF32(dim)
        self.ff_in = FeedForward(dim, dim_out=inner)
        self.norm1 = LayerNormF32(inner)
        self.attn1 = TemporalSelfAttention(inner, n_heads, d_head)
        self.norm2 = LayerNormF32(inner)
        self.attn2 = TemporalCrossAttention(inner, context_dim, n_heads, d_head)
        self.norm3 = LayerNormF32(inner)
        self.ff = FeedForward(inner, dim_out=dim)

    def forward(self, x, num_frames: int, context):
        bt, s, c = x.shape
        x = x.reshape(bt // num_frames, num_frames, s, c)
        x_skip = x
        x = self.ff_in(self.norm_in(x))
        if self.is_res:
            x = x + x_skip
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        x_skip = x
        x = self.ff(self.norm3(x))
        if self.is_res:
            x = x + x_skip
        return x.reshape(bt, s, c)


class SpatialVideoTransformer(nn.Module):
    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(
            Linear(in_channels, 4 * in_channels), nn.SiLU(),
            Linear(4 * in_channels, in_channels))
        self.time_mixer = AlphaBlender(0.5, "btc")
        self.proj_out = Linear(inner, in_channels)

    def forward(self, x, context, num_frames: int, image_only_indicator):
        bt, c, h, w = x.shape
        t = num_frames
        x_in = x
        time_context = context[::t]
        index = torch.arange(t, dtype=torch.float32, device=x.device).repeat(bt // t)
        x = self.proj_in(to_tokens(self.norm(x)))
        emb = self.time_pos_embed(timestep_embedding(index, c))[:, None, :]
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            x = block(x, context)
            x = self.time_mixer(x, time_block(x + emb, t, time_context),
                                image_only_indicator)
        return from_tokens(self.proj_out(x), h, w) + x_in


def unet_layer_specs(model_channels: int, channel_mult: Sequence[int],
                     num_res_blocks: int, attention_resolutions: Sequence[int],
                     num_head_channels: int):
    """The UNet skeleton: (input_specs, middle_spec, output_specs)."""
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


class _UNetBase(nn.Module):
    """The shared skeleton: embeddings, input / middle / output blocks."""

    res_cls = ResBlock
    attn_cls = SpatialTransformer

    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 attention_resolutions, channel_mult, num_head_channels,
                 context_dim, adm_in_channels):
        super().__init__()
        mc = model_channels
        emb_ch = 4 * mc
        self.model_channels = mc
        self.adm_in_channels = adm_in_channels
        self.time_embed = nn.Sequential(Linear(mc, emb_ch), nn.SiLU(),
                                        Linear(emb_ch, emb_ch))
        if adm_in_channels is not None:
            self.label_emb = nn.Sequential(nn.Sequential(
                Linear(adm_in_channels, emb_ch), nn.SiLU(), Linear(emb_ch, emb_ch)))

        def build(layers, ch):
            mods = []
            for spec in layers:
                kind = spec[0]
                if kind == "conv_in":
                    mods.append(Conv2d(in_channels, spec[1], 3, padding=1))
                    ch = spec[1]
                elif kind == "res":
                    cin = ch + (spec[2] if len(spec) > 2 else 0)
                    mods.append(self.res_cls(cin, emb_ch, spec[1]))
                    ch = spec[1]
                elif kind == "attn":
                    mods.append(self.attn_cls(spec[1], spec[2], num_head_channels,
                                              context_dim=context_dim))
                elif kind == "down":
                    mods.append(Downsample(ch, spec[1]))
                else:
                    mods.append(Upsample(ch, spec[1]))
            return nn.ModuleList(mods), ch

        specs_in, spec_mid, specs_out = unet_layer_specs(
            mc, channel_mult, num_res_blocks, attention_resolutions, num_head_channels)
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

    def embed(self, timesteps, y):
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.adm_in_channels is not None:
            emb = emb + self.label_emb(y.float())
        return emb

    def run_blocks(self, x, layer_fn):
        h = x.float()
        hs = []
        for block in self.input_blocks:
            h = layer_fn(block, h)
            hs.append(h)
        h = layer_fn(self.middle_block, h)
        for block in self.output_blocks:
            h = layer_fn(block, torch.cat([h, hs.pop()], dim=1))
        return self.out(h)


class VideoUNet(_UNetBase):
    """V3D's VideoUNet: forward(x ((b t), c, h, w), timesteps, context, y,
    num_video_frames, image_only_indicator) -> ((b t), out, h, w)."""

    res_cls = VideoResBlock
    attn_cls = SpatialVideoTransformer

    def __init__(self, in_channels: int = 8, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, context_dim: int = 1024,
                 adm_in_channels: Optional[int] = 768, use_checkpoint: bool = False):
        super().__init__(in_channels, model_channels, out_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_head_channels,
                         context_dim, adm_in_channels)
        self.use_checkpoint = use_checkpoint

    def forward(self, x, timesteps, context=None, y=None, num_video_frames: int = 1,
                image_only_indicator=None):
        t = num_video_frames
        emb = self.embed(timesteps, y)
        context = context.float()
        remat = self.use_checkpoint and torch.is_grad_enabled()

        def call(layer, *args):
            return checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)

        def run(block, h):
            for layer in block:
                if isinstance(layer, VideoResBlock):
                    h = call(layer, h, emb, t, image_only_indicator)
                elif isinstance(layer, SpatialVideoTransformer):
                    h = call(layer, h, context, t, image_only_indicator)
                else:
                    h = layer(h)
            return h

        return self.run_blocks(x, run)


class UNetModel(_UNetBase):
    """The image UNet (SD 2.x): forward(x (n, c, h, w), timesteps, context,
    y) -> (n, out, h, w)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, context_dim: int = 1024,
                 adm_in_channels: Optional[int] = None):
        super().__init__(in_channels, model_channels, out_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_head_channels,
                         context_dim, adm_in_channels)

    def forward(self, x, timesteps, context=None, y=None):
        emb = self.embed(timesteps, y)
        context = None if context is None else context.float()

        def run(block, h):
            for layer in block:
                if isinstance(layer, ResBlock):
                    h = layer(h, emb)
                elif isinstance(layer, SpatialTransformer):
                    h = layer(h, context)
                else:
                    h = layer(h)
            return h

        return self.run_blocks(x, run)
