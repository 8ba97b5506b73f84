"""Transformer blocks (counterpart of v3d_tpu/models/attention_blocks.py;
sgm modules/attention.py).  Tokens are (batch, seq, channels); LayerNorms and
softmax run in float32, products in the module dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.layers import GroupNorm32, LayerNormF32
from v3d_tpu_torch.ops.attention import attention_plain, flash_attn_fwd


class CrossAttention(nn.Module):
    """attention.py:260-351: MHA with no-bias QKV and a linear out; self-
    attention when ``context`` is None.

    Self-attention with dim_head 64 over >= 1024 tokens (a multiple of 512)
    runs kernel K1, where the JAX package runs the Pallas flash kernel
    (attention_blocks.py:98-108, attention.py:137-138): q/k/v go to it as
    (b, h, s, d) views of the projection output, no copies.  Every other
    site (cross-attention, short sequences) uses the plain formula."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, sq, _ = x.shape
        h, d = self.heads, self.dim_head
        ctx = x if context is None else context
        sk = ctx.shape[1]
        q = self.to_q(x).view(b, sq, h, d)
        k = self.to_k(ctx).view(b, sk, h, d)
        v = self.to_v(ctx).view(b, sk, h, d)
        if context is None and d == 64 and sq >= 1024 and sq % 512 == 0:
            o = flash_attn_fwd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)
        else:
            o = attention_plain(q, k, v)
        return self.to_out(o.reshape(b, sq, h * d))


class GEGLU(nn.Module):
    """Gated GELU.  The gate uses the tanh GELU, as the JAX package does
    (flax ``nn.gelu`` defaults to approximate=True); sgm uses the exact form
    there, a reference-side difference kept on purpose."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """attention.py:102-118: GEGLU MLP, 4x expansion (net.0.proj, net.2)."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0),
                                 nn.Linear(inner, dim_out or dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """attention.py:461-560: pre-norm self-attn, cross-attn, GEGLU FF."""

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


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(n, c, h, w) -> (n, h*w, c); free for channels_last memory."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n, h*w, c) -> (n, c, h, w) in channels_last memory."""
    n, _, c = x.shape
    return x.reshape(n, h, w, c).permute(0, 3, 1, 2)


class SpatialTransformer(nn.Module):
    """attention.py:624-764 with linear projections (V3D's use_linear):
    GroupNorm -> proj_in -> blocks -> proj_out, plus the residual.  Input
    (n, c, h, w); context (n, s_ctx, context_dim)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context=None):
        _, _, h, w = x.shape
        tokens = self.proj_in(to_tokens(self.norm(x)))
        for block in self.transformer_blocks:
            tokens = block(tokens, context)
        return from_tokens(self.proj_out(tokens), h, w) + x
