"""DPT (dense prediction transformer), the Omnidata normal predictor
(counterpart of v3d_tpu/models/dpt.py, itself of mesh_recon/utils/dpt.py
DPTDepthModel with backbone "vitb_rn50_384" = timm
``vit_base_resnet50_384``: a ResNetV2-(3,4,9) stem feeding a ViT-B/16,
hooks [stage0, stage1, block8, block11], readout "project").  V3D uses it
to predict per-frame normals that supervise NeuS
(mesh_recon/datasets/v3d.py:173).

- NCHW, float32, full width.  Parameters are named as in
  ``omnidata_dpt_normal_v2.ckpt`` with the "model." prefix stripped, so the
  checkpoint loads strictly and ``core.keymap.convert_dpt_key`` maps every
  name to the JAX package's tree.  ``pretrained.model.norm`` and
  ``scratch.refinenet4.resConfUnit1`` are held and never read, as in the
  reference.
- Every resampling (the fusion blocks' x2 upsample with align_corners, the
  position-embedding resize, the antialiased input resize and the bicubic
  resize back) is the JAX package's numpy (out, in) matrix applied by
  einsum, not ``F.interpolate``, so the borders and taps are the same.
- The ResNetV2 convs are weight-standardised (population variance, eps
  1e-8) with TF-"SAME" padding (asymmetric at stride 2), padded explicitly;
  the max pool pads with -inf.  The decoder's 3x3 convs pad symmetrically.
  GroupNorm eps 1e-5, LayerNorm eps 1e-6, exact GELU, plain float32
  softmax attention (the JAX package has no kernel here).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Resize matrices (a copy of v3d_tpu/models/dpt.py:41-100)
# ---------------------------------------------------------------------------


def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out,in) row-stochastic bilinear interpolation matrix."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            pos = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            pos = (i + 0.5) * in_size / out_size - 0.5
        pos = min(max(pos, 0.0), in_size - 1.0)
        lo = int(math.floor(pos))
        hi = min(lo + 1, in_size - 1)
        w = pos - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch 'cubic convolution' kernel (A=-0.75), support [-2,2]."""
    t = np.abs(t)
    w = np.where(
        t <= 1.0,
        (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0),
    )
    return w.astype(np.float32)


def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) bicubic matrix, half-pixel sampling + border clamp
    (torch F.interpolate mode='bicubic', align_corners=False)."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        pos = (i + 0.5) * in_size / out_size - 0.5
        base = math.floor(pos)
        for tap in range(base - 1, base + 3):
            w = float(_cubic_weight(np.array(pos - tap)))
            m[i, min(max(tap, 0), in_size - 1)] += w
    return m


def _bilinear_aa_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Antialiased bilinear downsampling matrix — PIL/torch
    ``antialias=True`` semantics: triangle kernel stretched by the scale
    factor, taps truncated to the image then renormalized."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = np.arange(lo, hi)
        w = np.clip(1.0 - np.abs((taps + 0.5 - center) / support), 0.0, None)
        w = w / w.sum()
        m[i, lo:hi] = w
    return m


@functools.lru_cache(maxsize=64)
def resize_matrix(kind: str, in_size: int, out_size: int) -> np.ndarray:
    """The (out, in) matrix of one resize: "bilinear" (align_corners False),
    "bilinear_ac" (True), "bicubic", "antialias" (the antialiased matrix
    when shrinking, else bilinear; the JAX package's
    ``resize_bilinear_antialias``).  Cached: treat it as read-only."""
    if kind == "bicubic":
        return _bicubic_matrix(in_size, out_size)
    if kind == "antialias" and out_size < in_size:
        return _bilinear_aa_matrix(in_size, out_size)
    return _bilinear_matrix(in_size, out_size, kind == "bilinear_ac")


def resize(x: torch.Tensor, out_hw: Tuple[int, int], kind: str) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H', W') by two 1-D resize matrices."""
    mh, mw = (torch.tensor(resize_matrix(kind, n, o), device=x.device, dtype=x.dtype)
              for n, o in zip(x.shape[2:], out_hw))
    x = torch.einsum("oh,bchw->bcow", mh, x)
    return torch.einsum("pw,bcow->bcop", mw, x)


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF-"SAME" padding: the total split low = total // 2, high = rest."""
    ph, pw = (max((math.ceil(n / s) - 1) * s + k - n, 0) for n in x.shape[2:])
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


# ---------------------------------------------------------------------------
# ResNetV2 hybrid stem (timm vit_base_resnet50_384 patch_embed.backbone)
# ---------------------------------------------------------------------------


class StdConvSame(nn.Module):
    """Weight-standardised conv, TF-"SAME" padding, no bias (timm
    StdConv2dSame, eps 1e-8)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def forward(self, x):
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (w - mean) * torch.rsqrt(var + 1e-8)
        return F.conv2d(_same_pad(x, self.kernel, self.stride), w, None, self.stride)


class GroupNormAct(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) and an optional ReLU (timm GroupNormAct)."""

    def __init__(self, ch: int, act: bool = True):
        super().__init__(32, ch, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class _Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = StdConvSame(in_ch, out_ch, 1, stride)
        self.norm = GroupNormAct(out_ch, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class BottleneckV2(nn.Module):
    """timm ResNetV2 non-preact bottleneck: conv1x1-GN-relu,
    conv3x3(stride)-GN-relu, conv1x1-GN, + shortcut (a 1x1 projection when
    the shape changes), relu."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        mid = out_ch // 4
        self.downsample = (_Downsample(in_ch, out_ch, stride)
                           if in_ch != out_ch or stride != 1 else None)
        self.conv1 = StdConvSame(in_ch, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConvSame(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConvSame(mid, out_ch, 1)
        self.norm3 = GroupNormAct(out_ch, act=False)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


class _Stage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth: int, stride: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            BottleneckV2(in_ch if i == 0 else out_ch, out_ch, stride if i == 0 else 1)
            for i in range(depth))

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConvSame(3, 64, 7, 2)
        self.norm = GroupNormAct(64)

    def forward(self, x):
        y = self.norm(self.conv(x))
        # MaxPool2dSame(3, stride 2): -inf padding
        return F.max_pool2d(_same_pad(y, 3, 2, float("-inf")), 3, 2)


class ResNetV2Stem(nn.Module):
    """Stem + 3 stages of ResNetV2-(3,4,9); returns the stage outputs at
    strides 4, 8, 16."""

    def __init__(self, layers: Sequence[int] = (3, 4, 9)):
        super().__init__()
        self.stem = _Stem()
        chans = [64] + [256 * 2 ** i for i in range(len(layers))]
        self.stages = nn.ModuleList(
            _Stage(chans[i], chans[i + 1], d, 1 if i == 0 else 2)
            for i, d in enumerate(layers))

    def forward(self, x):
        y = self.stem(x)
        feats = []
        for s in self.stages:
            y = s(y)
            feats.append(y)
        return tuple(feats)


# ---------------------------------------------------------------------------
# ViT-B encoder (timm VisionTransformer, hybrid patch embedding)
# ---------------------------------------------------------------------------


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (LN eps 1e-6, exact-GELU MLP)."""

    def __init__(self, dim: int = 768, heads: int = 12):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.backbone = ResNetV2Stem()
        self.proj = nn.Conv2d(1024, dim, 1)


class _VisionTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, pos_grid: int):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)   # unused: the hooks fire before it


class _ProjectReadout(nn.Module):
    """readout "project": cat(tokens, cls) -> Linear(2d, d) -> GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t):
        cls, feat = t[:, :1], t[:, 1:]
        return self.project(torch.cat([feat, cls.expand_as(feat)], dim=-1))


class DPTHybridBackbone(nn.Module):
    """vit_base_resnet50_384 with DPT's hooks: the 4 reassembled feature
    maps (dpt.py:84-125 forward_vit, _make_vit_b_rn50_backbone)."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 hooks: Tuple[int, int] = (8, 11), pos_grid: int = 24):
        super().__init__()
        self.hooks, self.pos_grid, self.dim = hooks, pos_grid, dim
        self.model = _VisionTransformer(dim, depth, heads, pos_grid)
        # the reference's Sequential(readout, Transpose, Unflatten, conv[,
        # conv]): only indices 0, 3 (and 4) hold parameters
        self.act_postprocess3 = nn.Sequential(
            _ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, 768, 1))
        self.act_postprocess4 = nn.Sequential(
            _ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, 768, 1),
            nn.Conv2d(768, 768, 3, stride=2, padding=1))

    def forward(self, x):
        b, _, h, w = x.shape
        gh, gw = h // 16, w // 16
        m = self.model
        f1, f2, f3 = m.patch_embed.backbone(x)
        tokens = m.patch_embed.proj(f3).flatten(2).transpose(1, 2)    # (b, gh*gw, d)
        pos_tok, pos = m.pos_embed[:, :1], m.pos_embed[:, 1:]
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            # _resize_pos_embed (dpt.py:127-142): bilinear, align_corners=False
            pos = pos.reshape(1, self.pos_grid, self.pos_grid, self.dim).permute(0, 3, 1, 2)
            pos = resize(pos, (gh, gw), "bilinear").flatten(2).transpose(1, 2)
        tokens = torch.cat([m.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + torch.cat([pos_tok, pos], dim=1)
        hooked = {}
        for i, blk in enumerate(m.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                hooked[i] = tokens

        def reassemble(t, post):
            y = post[0](t).transpose(1, 2).reshape(b, self.dim, gh, gw)
            for conv in post[3:]:
                y = conv(y)
            return y

        return (f1, f2, reassemble(hooked[self.hooks[0]], self.act_postprocess3),
                reassemble(hooked[self.hooks[1]], self.act_postprocess4))


# ---------------------------------------------------------------------------
# DPT decoder (scratch: refinenets + head)
# ---------------------------------------------------------------------------


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip (dpt.py:772-838, bn=False)."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """dpt.py:840-903: optional skip-add (resConfUnit1), resConfUnit2, x2
    bilinear (align_corners=True), 1x1 out conv."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize(x, (2 * x.shape[2], 2 * x.shape[3]), "bilinear_ac")
        return self.out_conv(x)


class _Scratch(nn.Module):
    def __init__(self, features: int, num_channels: int):
        super().__init__()
        for i, c in enumerate((256, 512, 768, 768)):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1,
                                                        bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        # the reference's head: conv, Interpolate, conv, ReLU, conv, ReLU
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, num_channels, 1))


class DPT(nn.Module):
    """DPTDepthModel (dpt.py:917-998): hybrid backbone -> scratch 3x3 convs
    -> 4 fusion blocks -> head; ``num_channels=3`` and a final ReLU for
    normals."""

    def __init__(self, num_channels: int = 3, features: int = 256,
                 non_negative: bool = True):
        super().__init__()
        self.non_negative = non_negative
        self.pretrained = DPTHybridBackbone()
        self.scratch = _Scratch(features, num_channels)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "DPT":
        """Seeded weights for tests and smoke runs (no checkpoint in the
        repository): conv and linear weights normal with std
        1/sqrt(fan_in), biases and the token / position embeddings std 0.02,
        norms' scales 1 + N(0, 0.1^2) and offsets N(0, 0.1^2); the head's
        last conv scaled by 1/4 with bias 0.5, so that the outputs sit
        around [0, 1], the range of packed normals."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() > 1 and leaf == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            elif ".norm" in name:
                p.normal_(0.0, 0.1, generator=gen)
                if leaf == "weight":
                    p.add_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        last = self.scratch.output_conv[4]
        last.weight.mul_(0.25)
        last.bias.fill_(0.5)
        return self

    def forward(self, x):
        """x: (B, 3, H, W) in [0, 1] (normal mode has no input
        normalisation, dpt.py:1036-1040); H, W divisible by 32.  Returns
        (B, C, H, W): the fusion path ends at stride 2 and the head
        upsamples x2."""
        s = self.scratch
        l1, l2, l3, l4 = self.pretrained(x)
        l1, l2, l3, l4 = (s.layer1_rn(l1), s.layer2_rn(l2), s.layer3_rn(l3),
                          s.layer4_rn(l4))
        p = s.refinenet4(l4)
        p = s.refinenet3(p, l3)
        p = s.refinenet2(p, l2)
        p = s.refinenet1(p, l1)
        head = s.output_conv
        y = head[0](p)
        y = resize(y, (2 * y.shape[2], 2 * y.shape[3]), "bilinear_ac")
        y = head[4](F.relu(head[2](y)))
        return F.relu(y) if self.non_negative else y


def dpt_normal_inference(model: DPT, images: torch.Tensor,
                         infer_size: int = 384) -> torch.Tensor:
    """The reference wrapper (dpt.py:1036-1069, mode "normal"): resize to
    ``infer_size``^2 (antialiased), run, clamp to [0, 1], bicubic back to
    the input size.  images (B, H, W, 3) in [0, 1] -> normals (B, H, W, 3)."""
    h, w = images.shape[1:3]
    x = resize(images.permute(0, 3, 1, 2), (infer_size, infer_size), "antialias")
    n = model(x).clamp(0.0, 1.0)
    return resize(n, (h, w), "bicubic").permute(0, 2, 3, 1)
