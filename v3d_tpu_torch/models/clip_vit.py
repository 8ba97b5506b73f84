"""CLIP ViT image tower (counterpart of v3d_tpu/models/clip_vit.py; the
open_clip VisionTransformer inside sgm's FrozenOpenCLIPImageEmbedder,
modules.py:594-680).

ViT-H/14: width 1280, 32 layers, 16 heads, patch 14, image 224, proj 1024.
Parameter names are open_clip's ``model.visual.*`` keys without the prefix
(``conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``, ...).
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.core.registry import register
from v3d_tpu_torch.models.layers import LayerNormF32
from v3d_tpu_torch.ops.attention import attention

# CLIP normalisation (modules.py:631-636)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameters: packed in_proj (with bias) and
    out_proj.  Through the ``attention`` dispatcher, as in the JAX package
    (clip_vit.py:43): d = 80 at ViT-H takes the plain formula by default and
    under "flash", K9 under "packed"."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, s, c = x.shape
        d = c // self.heads
        q, k, v = (t.reshape(b, s, self.heads, d) for t in
                   F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        return self.out_proj(attention(q, k, v).reshape(b, s, c))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.ln_1 = LayerNormF32(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, hidden)), ("gelu", nn.GELU()),
            ("c_proj", nn.Linear(hidden, width))]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads)
                                       for _ in range(layers))


@register("clip_vit")
class CLIPVisionTransformer(nn.Module):
    """(n, 3, image_size, image_size) CLIP-normalised -> (n, output_dim)."""

    def __init__(self, width: int = 1280, layers: int = 32, heads: int = 16,
                 patch_size: int = 14, image_size: int = 224,
                 output_dim: int = 1024):
        super().__init__()
        grid = image_size // patch_size
        self.image_size = image_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x):
        x = self.conv1(x.to(self.conv1.weight.dtype))
        n, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (n, grid*grid, width)
        cls = self.class_embedding.to(x.dtype).expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x)[:, 0] @ self.proj.to(x.dtype)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5 (jax.image's "bicubic")."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@lru_cache(maxsize=8)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of jax.image.resize(..., "bicubic",
    antialias=True) along one axis, built as jax.image.scale_and_translate
    does (compute_weight_mat): the kernel widens by in/out when shrinking.
    torch's bicubic (a = -0.75, no antialias) differs."""
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
    """modules.py:644-656: (n, h, w, 3) in [-1, 1] -> bicubic antialiased
    resize to size^2 -> [0, 1] -> CLIP mean/std.  Channels-last, as the JAX
    clip_preprocess."""
    n, h, w, c = x.shape
    if (h, w) != (size, size):
        rh = torch.as_tensor(resize_matrix(h, size), device=x.device)
        rw = torch.as_tensor(resize_matrix(w, size), device=x.device)
        x = torch.einsum("nhwc,hH,wW->nHWc", x.float(), rh, rw)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
