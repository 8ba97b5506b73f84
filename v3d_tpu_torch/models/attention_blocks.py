"""Transformer blocks (counterpart of v3d_tpu/models/attention_blocks.py;
sgm modules/attention.py).  Tokens are (batch, seq, channels); LayerNorms and
softmax run in float32, products in the module dtype.

``CrossAttention`` and ``FeedForward`` have a tensor-parallel forward: once
``parallel.tensor.tp_shard_`` has cut their parameters and bound a model row
(``tp``), Q/K/V and the GEGLU projection are column-parallel on this rank's
heads and columns and the projections back row-parallel, their outputs
all-reduced over "model".  Every other layer is replicated.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.layers import Conv2d, GroupNorm32, LayerNormF32, Linear
from v3d_tpu_torch.ops._dispatch import use_plain
from v3d_tpu_torch.ops.attention import (
    attention,
    attention_bhsd,
    attention_bhsd_route,
    attention_route,
)
from v3d_tpu_torch.parallel.tensor import column_weights, copy_to_model, row_output

# The self-attention projection layout (attention_blocks.py:19-35): "bhsd",
# the JAX package's default since r5, or "bshd", the r4 routing.  The
# V3D_ATTN_PROJ_LAYOUT environment switch is not read.
_PROJ_LAYOUT = "bhsd"


def set_proj_layout(name: str) -> None:
    global _PROJ_LAYOUT
    if name not in ("bshd", "bhsd"):
        raise ValueError(f"unknown projection layout {name!r}")
    _PROJ_LAYOUT = name


class CrossAttention(nn.Module):
    """attention.py:260-351: MHA with no-bias QKV and a linear out; self-
    attention when ``context`` is None.

    Routed as attention_blocks.py:98-118: in the "bhsd" layout, self-
    attention with dim_head 64 over >= 1024 tokens goes to
    ``attention_bhsd`` on (b, h, s, d) views of the projection output (by
    default K1, with K8/K7 for its gradient); every other call to
    ``attention`` on (b, s, h, d).  The projections and ``state_dict`` are
    the same on both routes.

    Bound to a model row (``tp``), it runs the heads of ``tp_plan`` (the
    route is the whole layer's: the same kernels on fewer heads) and
    all-reduces the output projection's partial sums."""

    tp_kind = "attention"
    tp = tp_plan = None

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def route(self, tokens: int, context_tokens: Optional[int],
              dtype: torch.dtype, on_card: bool) -> Tuple[str, str]:
        """(layout, backend) of a call over ``tokens`` query tokens, on
        ``context_tokens`` context tokens (None: self-attention), with
        activations of ``dtype``, on the card or not: the layout "bhsd" or
        "bshd", the backend as ``attention_bhsd_route`` / ``attention_route``
        resolve it ("xla" is the plain formula)."""
        d = self.dim_head
        if (_PROJ_LAYOUT == "bhsd" and context_tokens is None and d == 64
                and tokens >= 1024):
            return "bhsd", attention_bhsd_route(tokens, tokens, d, on_card)
        sk = tokens if context_tokens is None else context_tokens
        return "bshd", attention_route(tokens, sk, d, dtype, on_card)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, sq, _ = x.shape
        d = self.dim_head
        ctx = x if context is None else context
        sk = ctx.shape[1]
        layout, backend = self.route(sq, None if context is None else sk,
                                     x.dtype, not use_plain(x))
        if self.tp is None:
            h = self.heads
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        else:
            x = copy_to_model(x, self.tp)
            ctx = x if context is None else copy_to_model(context, self.tp)
            (wq, wk, wv, wo), h = column_weights(self, x.dtype)
            q, k, v = F.linear(x, wq), F.linear(ctx, wk), F.linear(ctx, wv)
        q, k, v = q.view(b, sq, h, d), k.view(b, sk, h, d), v.view(b, sk, h, d)
        if layout == "bhsd":
            o = attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), backend).transpose(1, 2)
        else:
            o = attention(q, k, v, backend)
        o = o.reshape(b, sq, h * d)
        if self.tp is None:
            return self.to_out(o)
        return row_output(F.linear(o, wo), self.to_out[0].bias, self.tp)


class GEGLU(nn.Module):
    """Gated GELU.  The gate uses the tanh GELU, as the JAX package does
    (flax ``nn.gelu`` defaults to approximate=True); sgm uses the exact form
    there, a reference-side difference kept on purpose."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """attention.py:102-118: GEGLU MLP, 4x expansion (net.0.proj, net.2).

    Bound to a model row (``tp``), ``net.0.proj`` holds this rank's value and
    gate rows (``parallel.tensor``'s half-wise cut), so the GEGLU forms this
    rank's columns, and ``net.2``'s matching input columns give a partial
    sum, all-reduced before the bias."""

    tp_kind = "geglu_mlp"
    tp = None

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0),
                                 Linear(inner, dim_out or dim))

    def forward(self, x):
        if self.tp is None:
            return self.net(x)
        y = self.net[0](copy_to_model(x, self.tp))
        out = self.net[2]
        return row_output(F.linear(y, out.weight.to(y.dtype)), out.bias, self.tp)


class BasicTransformerBlock(nn.Module):
    """attention.py:461-560: pre-norm self-attn, cross-attn, GEGLU FF.  With
    ``disable_self_attn`` the first attention also attends to the context."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None,
                                    n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.norm3 = LayerNormF32(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x), context if self.disable_self_attn else None) + x
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
    """attention.py:624-764: GroupNorm -> proj_in -> blocks -> proj_out,
    plus the residual.  Input (n, c, h, w); context (n, s_ctx, context_dim).
    The projections are linear on the tokens (V3D's and SD 2.x's
    ``use_linear``) or, with ``use_linear=False``, 1x1 convolutions on the
    map (SD 1.x)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 use_linear: bool = True, disable_self_attn: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.use_linear = use_linear
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        proj = Linear if use_linear else functools.partial(Conv2d, kernel_size=1)
        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  disable_self_attn)
            for _ in range(depth))
        self.proj_out = proj(inner, in_channels)

    def forward(self, x, context=None):
        _, _, h, w = x.shape
        if self.use_linear:
            tokens = self.proj_in(to_tokens(self.norm(x)))
        else:
            tokens = to_tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            tokens = block(tokens, context)
        if self.use_linear:
            return from_tokens(self.proj_out(tokens), h, w) + x
        return self.proj_out(from_tokens(tokens, h, w)) + x
