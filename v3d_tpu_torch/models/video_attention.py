"""Temporal attention blocks (counterpart of v3d_tpu/models/video_attention.py;
sgm modules/video_attention.py).

Video batches are ``(b*t, ...)`` with frames fastest.  The temporal blocks
work on the free reshape ``(b, t, s, c)``: each pixel attends across the t
orbit frames with no transposes around the attention (kernels K2 and K3
read that layout directly), and the temporal cross-attention context stays
``(b, s_ctx, c)``, unrepeated (video_attention.py:244-253 repeats it per
pixel).  Parameter names follow the sgm checkpoint.

The attention layers and feed-forwards have the tensor-parallel forward of
``parallel.tensor`` (bound by ``tp_shard_``): a ``VideoTransformerBlock``
all-reduces four times over "model" (``ff_in``, ``attn1``, ``attn2``,
``ff``), a ``SpatialVideoTransformer`` seven times; the norms, the
AlphaBlender and the projections in and out stay replicated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.attention_blocks import (
    BasicTransformerBlock,
    FeedForward,
    from_tokens,
    to_tokens,
)
from v3d_tpu_torch.models.layers import (
    AlphaBlender,
    GroupNorm32,
    LayerNormF32,
    Linear,
    timestep_embedding,
)
from v3d_tpu_torch.ops.temporal_attention import (
    temporal_block_attention,
    temporal_core,
)
from v3d_tpu_torch.parallel.frames import frames_to_pixels, pixels_to_frames
from v3d_tpu_torch.parallel.tensor import column_weights, copy_to_model, row_output


class _QKVOut(nn.Module):
    """to_q/to_k/to_v (no bias) + to_out.0, named as CrossAttention's, and
    its tensor-parallel binding (``tp``, ``tp_plan``: ``parallel.tensor``)."""

    tp_kind = "attention"
    tp = tp_plan = None

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))


class TemporalSelfAttention(_QKVOut):
    """Self-attention over the frame axis of (b, t, s, c) tokens.

    Where the pixel count is a multiple of 64 and there are at most 8 heads
    (the ds1 levels), the whole layer is kernel K2, as the JAX package runs
    its fused Pallas block there (video_attention.py:96), with the weights
    cast to the activations' dtype as ``_pallas_block`` casts them.
    Elsewhere the projections are matmuls and K3 does the attention on
    their output.  Bound to a model row, K2 or K3 (chosen by the whole
    layer's heads) runs on this rank's heads, K2 with this rank's Q/K/V rows,
    its slice of the output projection and no bias, added after the
    all_reduce."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__(dim, dim, heads, dim_head)

    def takes_block(self, pixels: int) -> bool:
        """Whether a call on ``pixels`` pixels per frame runs K2 (else K3)."""
        return pixels % 64 == 0 and self.heads <= 8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.to_out[0]
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
            (wq, wk, wv, wo), h = column_weights(self, x.dtype)
            if self.takes_block(x.shape[2]):
                y = temporal_block_attention(
                    x, wq, wk, wv, wo.contiguous(), x.new_zeros(x.shape[-1]), h)
            else:
                y = F.linear(temporal_core(F.linear(x, wq), F.linear(x, wk),
                                           F.linear(x, wv), h), wo)
            return row_output(y, out.bias, self.tp)
        if self.takes_block(x.shape[2]):
            return temporal_block_attention(
                x, *(w.to(x.dtype) for w in (
                    self.to_q.weight, self.to_k.weight, self.to_v.weight,
                    out.weight, out.bias)), self.heads)
        o = temporal_core(self.to_q(x), self.to_k(x), self.to_v(x), self.heads)
        return out(o)


class TemporalCrossAttention(_QKVOut):
    """Cross-attention of (b, t, s, c) tokens to a per-video context
    (b, s_ctx, context_dim), shared by every frame and pixel."""

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, t, s, _ = x.shape
        d = self.dim_head
        if self.tp is None:
            h = self.heads
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        else:
            x, context = copy_to_model(x, self.tp), copy_to_model(context, self.tp)
            (wq, wk, wv, wo), h = column_weights(self, x.dtype)
            q, k, v = F.linear(x, wq), F.linear(context, wk), F.linear(context, wv)
        q = q.view(b, t, s, h, d)
        k, v = k.view(b, -1, h, d), v.view(b, -1, h, d)
        logits = torch.einsum("btshd,bkhd->btshk", q.float(), k.float())
        probs = torch.softmax(logits / math.sqrt(d), dim=-1).to(x.dtype)
        o = torch.einsum("btshk,bkhd->btshd", probs, v).reshape(b, t, s, h * d)
        if self.tp is None:
            return self.to_out(o)
        return row_output(F.linear(o, wo), self.to_out[0].bias, self.tp)


class VideoTransformerBlock(nn.Module):
    """video_attention.py:15-144: input FF, temporal self-attention, temporal
    cross-attention to the time context, FF.  Input ((b t), s, c)."""

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

    def forward(self, x: torch.Tensor, num_frames: int,
                context: torch.Tensor) -> torch.Tensor:
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
    """video_attention.py:146-301: a spatial transformer with a parallel
    temporal stack, merged per block by a learned AlphaBlender.

    Input ((b t), c, h, w); context ((b t), s_ctx, context_dim).  The
    temporal context is each video's first-frame context, (b, s_ctx,
    context_dim) (V3D's use_spatial_context).  Under ``frames`` (a bound
    ``parallel.frames.FrameShard``) x and context are this rank's rows, the
    frame embedding takes each row's global frame index, and the time stack
    runs on this rank's strip of pixels of every frame."""

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

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                num_frames: int, image_only_indicator, frames=None) -> torch.Tensor:
        bt, c, h, w = x.shape
        t = num_frames
        x_in = x
        if context is None or context.dim() != 3:
            raise ValueError("SpatialVideoTransformer needs a 3-D context")
        if frames is None:
            time_context = context[::t]
            index = torch.arange(t, dtype=torch.float32, device=x.device).repeat(bt // t)
        else:
            time_context = frames.time_context
            index = frames.frame_index(x.device).float()

        x = self.proj_in(to_tokens(self.norm(x)))
        t_emb = timestep_embedding(index, c)
        emb = self.time_pos_embed(t_emb.to(x.dtype))[:, None, :]
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            x = block(x, context)
            if frames is None:
                x_mix = time_block(x + emb, t, time_context)
            else:
                x_mix = pixels_to_frames(time_block(
                    frames_to_pixels(x + emb, frames), t, time_context), h * w, frames)
            x = self.time_mixer(x, x_mix, image_only_indicator)
        return from_tokens(self.proj_out(x), h, w) + x_in
