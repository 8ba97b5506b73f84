"""VideoUNet, the V3D generator (counterpart of v3d_tpu/models/video_unet.py;
sgm diffusionmodules/video_model.py).

NCHW feature maps in channels_last memory; the batch is ``(b*t)`` with
frames fastest.  Parameter names are the checkpoint's: ``time_embed.{0,2}``,
``label_emb.0.{0,2}``, ``input_blocks.{i}.{j}``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``out.{0,2}``.

For training, ``compute_dtype`` separates the activations' dtype from the
parameters' (f32 master weights under bf16 compute, flax's ``dtype`` with
``param_dtype=float32``), and ``use_checkpoint`` recomputes each
VideoResBlock and SpatialVideoTransformer in the backward, the counterpart
of ``nn.remat`` (v3d_tpu/models/video_unet.py:141-165).

Under ``frames`` (a ``parallel.frames.FrameShard``) the forward is one
rank's share of a frame-parallel forward: its inputs are this rank's block
of the batch's rows, spatial layers run on them alone, and each temporal
sub-block runs on this rank's strip of pixels of every frame
(``parallel/frames.py``).

``parallel.tensor.tp_shard_`` binds a model row (``tp``) to the UNet and
cuts its attention and MLP layers' parameters: the forward is then one
rank's share of a tensor-parallel forward over "model" (each layer on this
rank's heads and columns, its outputs all-reduced), with or without
``frames`` (over "data").
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from v3d_tpu_torch.core.registry import check_fixed, register
from v3d_tpu_torch.models.layers import (
    AlphaBlender,
    Conv2d,
    Downsample,
    GroupNorm32,
    Linear,
    ResBlock,
    Upsample,
    from_video,
    timestep_embedding,
    to_video,
)
from v3d_tpu_torch.models.attention_blocks import from_tokens, to_tokens
from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
from v3d_tpu_torch.parallel.frames import frames_to_pixels, pixels_to_frames


class VideoResBlock(ResBlock):
    """A 2-D ResBlock, then a temporal (3,1,1)-conv ResBlock on the video
    view, merged by a learned AlphaBlender (video_model.py:12-81)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__(channels, emb_channels, out_channels, dims=2)
        self.time_stack = ResBlock(out_channels, emb_channels, out_channels,
                                   dims=3, kernel_size=(3, 1, 1),
                                   exchange_temb_dims=True)
        self.time_mixer = AlphaBlender(0.5, "bcthw")

    def forward(self, x, emb, num_frames: int, image_only_indicator, frames=None):
        x = super().forward(x, emb)
        if frames is None:
            x5 = to_video(x, num_frames)
            emb5 = emb.reshape(-1, num_frames, emb.shape[-1])
            x_temporal = self.time_stack(x5, emb5)
            return from_video(self.time_mixer(x5, x_temporal, image_only_indicator))
        # this rank's rows -> every frame of its pixel strip, (b, c, t, s_r, 1)
        # in channels_last_3d; the time stack's GroupNorms span the strips
        _, c, h, w = x.shape
        xp = frames_to_pixels(to_tokens(x), frames)
        s_r = xp.shape[1]
        x5 = xp.reshape(frames.videos, num_frames, s_r, 1, c).permute(0, 4, 1, 2, 3)
        emb5 = frames.emb.reshape(frames.videos, num_frames, -1)
        xt = self.time_stack(x5, emb5, frames.split_norm(h * w))
        xt = xt.permute(0, 2, 3, 4, 1).reshape(frames.rows, s_r, c)
        x_temporal = from_tokens(pixels_to_frames(xt, h * w, frames), h, w)
        return self.time_mixer(x, x_temporal, image_only_indicator)


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


# fields of the JAX VideoUNet (video_unet.py:120-143) that the port builds
# at V3D's values only; a config may pass them (configs/v3d_512.yaml does)
VIDEO_UNET_FIXED = dict(
    transformer_depth=1, use_scale_shift_norm=False, video_kernel_size=(3, 1, 1),
    merge_strategy="learned_with_images", merge_factor=0.5,
    extra_ff_mix_layer=True, use_spatial_context=True,
    use_linear_in_transformer=True, disable_temporal_crossattention=False,
    max_ddpm_temb_period=10000)


@register("video_unet")
class VideoUNet(nn.Module):
    """video_model.py:84-493 with V3D_512.yaml defaults.

    forward(x, timesteps, context, y, num_video_frames, image_only_indicator)
      x          ((b t), in_channels, h, w)   latent + concat-cond channels
      timesteps  ((b t),)                     c_noise
      context    ((b t), s_ctx, context_dim)  CLIP crossattn tokens
      y          ((b t), adm_in_channels)     fps / motion / cond-aug vector
    returns ((b t), out_channels, h, w) in float32.

    ``frames``: a ``parallel.frames.FrameShard``; x, timesteps, context and
    y are then this rank's rows of the batch (``image_only_indicator`` the
    whole (b, t)), and the result is this rank's rows.

    ``tp``: the model row ``parallel.tensor.tp_shard_`` bound, or None.

    The JAX module's other fields are taken only at V3D's values
    (``VIDEO_UNET_FIXED``); any other value raises.
    """

    tp = None

    def __init__(self, in_channels: int = 8, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, context_dim: int = 1024,
                 adm_in_channels: Optional[int] = 768,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_checkpoint: bool = False, **fixed):
        super().__init__()
        check_fixed("VideoUNet", fixed, VIDEO_UNET_FIXED)
        mc = model_channels
        emb_ch = 4 * mc
        self.model_channels = mc
        self.context_dim = context_dim
        self.compute_dtype = compute_dtype
        self.use_checkpoint = use_checkpoint
        self.time_embed = nn.Sequential(Linear(mc, emb_ch), nn.SiLU(),
                                        Linear(emb_ch, emb_ch))
        self.adm_in_channels = adm_in_channels
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
        self.out = nn.Sequential(GroupNorm32(ch, act="silu"), nn.Identity(),
                                 Conv2d(ch, out_channels, 3, padding=1))

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype: ``compute_dtype``, else the weights'."""
        return self.compute_dtype or self.time_embed[0].weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, num_video_frames: int = 1,
                image_only_indicator: Optional[torch.Tensor] = None,
                frames=None) -> torch.Tensor:
        t = num_video_frames
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dt))
        if self.adm_in_channels is not None:
            if y is None or y.shape[0] != x.shape[0]:
                raise ValueError("vector conditioning y must match the batch")
            emb = emb + self.label_emb(y.to(dt))
        if context is not None:
            context = context.to(dt)
        if frames is not None:
            # every row's embedding and each video's first-frame context
            frames = frames.bind(emb, context)
            image_only_indicator = frames.local(image_only_indicator)

        remat = self.use_checkpoint and torch.is_grad_enabled()

        def call(layer, *args):
            if not remat:
                return layer(*args)
            # the recompute re-issues a layer's collectives: all of them,
            # on every rank, so it must not stop early
            with set_checkpoint_early_stop(frames is None and self.tp is None):
                return checkpoint(layer, *args, use_reentrant=False)

        def run(block, h):
            for layer in block:
                if isinstance(layer, VideoResBlock):
                    h = call(layer, h, emb, t, image_only_indicator, frames)
                elif isinstance(layer, SpatialVideoTransformer):
                    h = call(layer, h, context, t, image_only_indicator, frames)
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
