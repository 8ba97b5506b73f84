"""Plain building blocks of the reference models: a frozen copy of
``v3d_tpu_torch/models/layers.py`` and ``attention_blocks.py`` with every
kernel call replaced by its formula, float32 throughout, NCHW tensors in
default memory.  Parameter names are the port's (the sgm checkpoint's), so
one set of seeded weights fills both.

Every product takes its operands through ``self.num.q`` (``numerics.py``):
float32 for the reference, float8 for the control.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.numerics import F32

# attention scores are formed in blocks of at most this many float32 values
SCORE_BLOCK = 1 << 28


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def softmax_attention(q, k, v, num=F32) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (n, sq, d) / (n, sk, d), in blocks of
    query rows so that the scores stay under ``SCORE_BLOCK`` values."""
    n, sq, d = q.shape
    sk = k.shape[1]
    kq, vq = num.q(k), num.q(v)
    step = max(1, SCORE_BLOCK // max(1, n * sk))
    outs = []
    for i in range(0, sq, step):
        s = torch.matmul(num.q(q[:, i:i + step]), kq.transpose(1, 2)) / math.sqrt(d)
        outs.append(torch.matmul(num.q(torch.softmax(s, dim=-1)), vq))
    return torch.cat(outs, dim=1)


def heads_attention(q, k, v, heads: int, num=F32) -> torch.Tensor:
    """(b, sq, heads*d) / (b, sk, heads*d) -> (b, sq, heads*d)."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads

    def split(x, s):
        return x.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)

    o = softmax_attention(split(q, sq), split(k, sk), split(v, sk), num)
    return o.reshape(b, heads, sq, d).transpose(1, 2).reshape(b, sq, c)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm in float32, with the SiLU after it where ``act="silu"``."""

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 num_groups: int = 32, act: Optional[str] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.act = act

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return F.silu(y) if self.act == "silu" else y


class LayerNormF32(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class Linear(nn.Linear):
    num = F32

    def forward(self, x):
        return F.linear(self.num.q(x), self.num.q(self.weight),
                        None if self.bias is None else self.bias.float())


class Conv2d(nn.Conv2d):
    num = F32

    def forward(self, x):
        return self._conv_forward(self.num.q(x), self.num.q(self.weight),
                                  None if self.bias is None else self.bias.float())


class Conv3d(nn.Conv3d):
    num = F32

    def forward(self, x):
        return self._conv_forward(self.num.q(x), self.num.q(self.weight),
                                  None if self.bias is None else self.bias.float())


def conv_nd(dims: int, cin: int, cout: int, kernel_size, **kw) -> nn.Module:
    return (Conv2d if dims == 2 else Conv3d)(cin, cout, kernel_size, **kw)


def to_video(x: torch.Tensor, t: int) -> torch.Tensor:
    """((b t), c, h, w) -> (b, c, t, h, w)."""
    bt, c, h, w = x.shape
    return x.reshape(bt // t, t, c, h, w).permute(0, 2, 1, 3, 4)


def from_video(x: torch.Tensor) -> torch.Tensor:
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n, _, c = x.shape
    return x.reshape(n, h, w, c).permute(0, 3, 1, 2)


class AlphaBlender(nn.Module):
    """alpha * spatial + (1 - alpha) * temporal, alpha = 1 where the
    indicator is set, else sigmoid(mix_factor)."""

    def __init__(self, alpha: float = 0.5, alpha_shape: str = "btc"):
        super().__init__()
        self.alpha_shape = alpha_shape
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, x_spatial, x_temporal, image_only_indicator):
        alpha = torch.sigmoid(self.mix_factor[0].float())
        alpha = torch.where(image_only_indicator.bool(), torch.ones_like(alpha), alpha)
        if self.alpha_shape == "btc":
            alpha = alpha.reshape(-1, 1, 1)
        else:
            alpha = alpha[:, None, :, None, None]
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Upsample(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.op = Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GN-SiLU-conv, the embedding added, GN-SiLU-conv, plus the skip.
    ``dims=3`` on (b, c, t, h, w); ``exchange_temb_dims``: the embedding is
    (b, t, e); ``skip_t_emb``: no embedding."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, dims: int = 2,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 exchange_temb_dims: bool = False, skip_t_emb: bool = False):
        super().__init__()
        out_channels = out_channels or channels
        ks = (kernel_size,) * dims if isinstance(kernel_size, int) else tuple(kernel_size)
        pad = tuple(k // 2 for k in ks)
        self.exchange_temb_dims = exchange_temb_dims
        self.skip_t_emb = skip_t_emb
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, act="silu"), nn.Identity(),
            conv_nd(dims, channels, out_channels, ks, padding=pad))
        if not skip_t_emb:
            self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, act="silu"), nn.Identity(), nn.Dropout(0.0),
            conv_nd(dims, out_channels, out_channels, ks, padding=pad))
        self.skip_connection = (nn.Identity() if out_channels == channels
                                else conv_nd(dims, channels, out_channels, 1))

    def forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x))
        if not self.skip_t_emb:
            e = self.emb_layers(emb)
            if self.exchange_temb_dims:
                e = e.permute(0, 2, 1)[..., None, None]
            else:
                e = e.reshape(e.shape + (1,) * (h.dim() - 2))
            h = h + e
        return self.skip_connection(x) + self.out_layers[3](self.out_layers[0](h))


class CrossAttention(nn.Module):
    """Multi-head attention, self-attention when ``context`` is None."""

    num = F32

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        o = heads_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                            self.heads, self.num)
        return self.to_out(o)


class GEGLU(nn.Module):
    """Gated GELU, the gate's GELU in its tanh form (as the port)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0),
                                 Linear(inner, dim_out or dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.norm3 = LayerNormF32(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm, linear proj_in, the blocks, linear proj_out, residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.proj_out = Linear(inner, in_channels)

    def forward(self, x, context=None):
        _, _, h, w = x.shape
        tokens = self.proj_in(to_tokens(self.norm(x)))
        for block in self.transformer_blocks:
            tokens = block(tokens, context)
        return from_tokens(self.proj_out(tokens), h, w) + x
