"""The reference CLIP image tower: a frozen copy of
``v3d_tpu_torch/models/clip_vit.py`` (open_clip's VisionTransformer, ViT-H/14
at its defaults) with its preprocessing, plain float32, the port's
parameter names.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv2d, LayerNormF32, Linear, heads_attention
from portbench.reference.numerics import F32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    num = F32

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x):
        qkv = F.linear(self.num.q(x), self.num.q(self.in_proj_weight),
                       self.in_proj_bias.float())
        return self.out_proj(heads_attention(*qkv.chunk(3, dim=-1), self.heads, self.num))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.ln_1 = LayerNormF32(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Linear(width, hidden)), ("gelu", nn.GELU()),
            ("c_proj", Linear(hidden, width))]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads) for _ in range(layers))


class CLIPVisionTransformer(nn.Module):
    """(n, 3, image_size, image_size) CLIP-normalised -> (n, output_dim)."""

    num = F32

    def __init__(self, width: int = 1280, layers: int = 32, heads: int = 16,
                 patch_size: int = 14, image_size: int = 224, output_dim: int = 1024):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x):
        x = self.conv1(x.float())
        n, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.float().expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.float()
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.num.q(self.ln_post(x)[:, 0]) @ self.num.q(self.proj)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of an antialiased Keys-cubic (a = -0.5) resize
    along one axis, the kernel widened by in/out when shrinking."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def clip_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(n, h, w, 3) in [-1, 1] -> resized to size^2, CLIP mean / std,
    channels-last."""
    _, h, w, _ = x.shape
    if (h, w) != (size, size):
        rh = torch.as_tensor(resize_matrix(h, size), device=x.device)
        rw = torch.as_tensor(resize_matrix(w, size), device=x.device)
        x = torch.einsum("nhwc,hH,wW->nHWc", x.float(), rh, rw)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
