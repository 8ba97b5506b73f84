"""FLUX.1 (black-forest-labs/flux ``src/flux/model.py``, ``modules/layers.py``):
the MMDiT of FLUX.1-dev, a rectified-flow transformer on 2x2 patches of a
16-channel latent.

The network takes what ``ImageDiffusionEngine`` hands any of its networks:
the (n, c, h, w) latent, the noise level (``timesteps``: the flow time t in
[0, 1], embedded at t x 1000), ``context`` (the T5 tokens), ``y`` (the
pooled CLIP vector) and ``guidance`` (the distilled guidance scale a row).
It packs the latent into (h/2)(w/2) tokens of 4c channels, runs 19
double-stream blocks (text and image keep their own weights and meet in
one joint attention) and 38 single-stream blocks (attention and MLP in
parallel from one modulated LayerNorm) on the joined sequence, and unpacks
the image tokens' velocity to (n, c, h, w), float32.

Numerics follow BFL's code in the parameters' dtype: LayerNorms are
affine-free (eps 1e-6) in float32 with the output in the activations'
dtype (``LayerNormNoAffine``: K10 on the card where no gradient is
wanted); the QK RMSNorm is computed in float32, cast back, then scaled;
RoPE rotates adjacent channel pairs in float32 (``apply_rope``); the joint
attention is ``ops.flash_attention.flash_attention`` on the (b, s, h, d)
layout (K9 at d = 128 on the card, the plain formula on the CPU); the
modulations, GELU and gates are plain torch.  Parameter names are the
checkpoint's (``double_blocks.0.img_attn.qkv.weight``, ...).

No registry name: the registry holds the JAX package's components, which
have no FLUX.1 (``portbench/configs/flux1-dev.py`` builds it directly).

Spans (``utils/trace.py``), inside the engine's ``unet.forward``:
``flux.embed``; ``flux.double`` (``block``) and ``flux.single``
(``block``), each holding a ``flux.attention`` (``tokens``: from the QK
norm to the attention's output); ``flux.final``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.models.layers import Linear, timestep_embedding
from v3d_tpu_torch.ops._dispatch import needs_grad, use_plain
from v3d_tpu_torch.ops.flash_attention import flash_attention
from v3d_tpu_torch.ops.layer_norm import (
    layer_norm_f32,
    layer_norm_f32_plain,
    layer_norm_route,
)
from v3d_tpu_torch.utils.trace import span

TIME_FACTOR = 1000.0   # flux's timestep_embedding(time_factor=1000)
THETA = 10_000         # RoPE's base
PATCH = 2              # the latent's patches are PATCH x PATCH


def rope_angles(ids: torch.Tensor, axes_dim: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (L, D / 2) float32, of positions ``ids`` (L, axes):
    axis i's position times THETA^(-2j / axes_dim[i]), j < axes_dim[i] / 2,
    in float64 (layers.py ``rope``), the axes' frequencies side by side."""
    angles = []
    for i, dim in enumerate(axes_dim):
        scale = torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim
        angles.append(ids[:, i].double()[:, None] * (1.0 / THETA ** scale)[None])
    a = torch.cat(angles, dim=-1)
    return torch.cos(a).float(), torch.sin(a).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate each adjacent channel pair (x0, x1) of x (b, L, h, D) by its
    angle: (cos x0 - sin x1, sin x0 + cos x1), in float32, back in x's
    dtype (layers.py ``apply_rope``)."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([c * x0 - s * x1, s * x0 + c * x1], dim=-1).flatten(-2).to(x.dtype)


def image_ids(h: int, w: int, device) -> torch.Tensor:
    """(h w, 3) positions of the packed patches: (0, row, col)."""
    ids = torch.zeros(h, w, 3, device=device)
    ids[..., 1] = torch.arange(h, device=device)[:, None]
    ids[..., 2] = torch.arange(w, device=device)[None, :]
    return ids.reshape(h * w, 3)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(n, c, h, w) -> (n, (h/p)(w/p), c p p) for p = PATCH, channels in
    (c, ph, pw) order (sampling.py ``prepare``)."""
    p = PATCH
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, (h // p) * (w // p), c * p * p)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of ``pack`` for an (n, c, h, w) latent."""
    p = PATCH
    n, _, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(n, h // p, w // p, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, h, w)


class LayerNormNoAffine(nn.Module):
    """LayerNorm with no weight or bias, statistics in float32, output in
    the input's dtype: one launch of K10 on the card where no gradient is
    wanted (``layer_norm_route``), else the plain formula."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layer_norm_route(not use_plain(x), needs_grad(x)) == "k10":
            return layer_norm_f32(x, None, None, self.eps)
        return layer_norm_f32_plain(x, None, None, self.eps)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden_dim)
        self.out_layer = Linear(hidden_dim, hidden_dim)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        rrms = torch.rsqrt(x.float().pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (x.float() * rrms).to(x.dtype) * self.scale.to(x.dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def forward(self, q, k, v):
        return self.query_norm(q).to(v.dtype), self.key_norm(k).to(v.dtype)


class SelfAttention(nn.Module):
    """The double block's per-stream projections: ``qkv`` and ``proj``
    around the joint attention, ``norm`` its QK RMSNorm."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.norm = QKNorm(dim // num_heads)
        self.proj = Linear(dim, dim)

    def split(self, x: torch.Tensor):
        """x (b, L, dim) -> q, k, v (b, L, heads, d), views of one product."""
        return self.qkv(x).unflatten(-1, (3, self.num_heads, -1)).unbind(2)


class Modulation(nn.Module):
    """shift, scale, gate (and a second triple where ``double``), each
    (b, 1, dim), from silu(vec)."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = Linear(dim, self.multiplier * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)


def joint_attention(q, k, v, pe) -> torch.Tensor:
    """RoPE on q and k (b, L, h, d), the attention, -> (b, L, h d)."""
    cos, sin = pe
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return flash_attention(q, k, v).flatten(2)


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        mlp = int(hidden_size * mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden_size, double=True))
            setattr(self, f"{s}_norm1", LayerNormNoAffine())
            setattr(self, f"{s}_attn", SelfAttention(hidden_size, num_heads))
            setattr(self, f"{s}_norm2", LayerNormNoAffine())
            setattr(self, f"{s}_mlp", nn.Sequential(
                Linear(hidden_size, mlp), nn.GELU(approximate="tanh"), Linear(mlp, hidden_size)))

    def forward(self, img, txt, vec, pe):
        im1_shift, im1_scale, im1_gate, im2_shift, im2_scale, im2_gate = self.img_mod(vec)
        tx1_shift, tx1_scale, tx1_gate, tx2_shift, tx2_scale, tx2_gate = self.txt_mod(vec)
        img_q, img_k, img_v = self.img_attn.split(
            (1 + im1_scale) * self.img_norm1(img) + im1_shift)
        txt_q, txt_k, txt_v = self.txt_attn.split(
            (1 + tx1_scale) * self.txt_norm1(txt) + tx1_shift)
        t = txt.shape[1]
        with span("flux.attention", tokens=t + img.shape[1]):
            img_q, img_k = self.img_attn.norm(img_q, img_k, img_v)
            txt_q, txt_k = self.txt_attn.norm(txt_q, txt_k, txt_v)
            attn = joint_attention(torch.cat([txt_q, img_q], 1), torch.cat([txt_k, img_k], 1),
                                   torch.cat([txt_v, img_v], 1), pe)
        txt_attn, img_attn = attn[:, :t], attn[:, t:]
        img = img + im1_gate * self.img_attn.proj(img_attn)
        img = img + im2_gate * self.img_mlp((1 + im2_scale) * self.img_norm2(img) + im2_shift)
        txt = txt + tx1_gate * self.txt_attn.proj(txt_attn)
        txt = txt + tx2_gate * self.txt_mlp((1 + tx2_scale) * self.txt_norm2(txt) + tx2_shift)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.linear1 = Linear(hidden_size, hidden_size * 3 + self.mlp_hidden_dim)
        self.linear2 = Linear(hidden_size + self.mlp_hidden_dim, hidden_size)
        self.norm = QKNorm(hidden_size // num_heads)
        self.pre_norm = LayerNormNoAffine()
        self.modulation = Modulation(hidden_size, double=False)

    def forward(self, x, vec, pe):
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = self.linear1((1 + scale) * self.pre_norm(x) + shift).split(
            [3 * self.hidden_size, self.mlp_hidden_dim], dim=-1)
        q, k, v = qkv.unflatten(-1, (3, self.num_heads, -1)).unbind(2)
        with span("flux.attention", tokens=x.shape[1]):
            q, k = self.norm(q, k, v)
            attn = joint_attention(q, k, v, pe)
        out = self.linear2(torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=2))
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.norm_final = LayerNormNoAffine()
        self.linear = Linear(hidden_size, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 2 * hidden_size))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        return self.linear((1 + scale[:, None]) * self.norm_final(x) + shift[:, None])


class Flux(nn.Module):
    """FLUX.1's transformer (model.py ``Flux``) on the engine's latents."""

    def __init__(self, in_channels: int = 64, vec_in_dim: int = 768,
                 context_in_dim: int = 4096, hidden_size: int = 3072,
                 mlp_ratio: float = 4.0, num_heads: int = 24, depth: int = 19,
                 depth_single_blocks: int = 38, axes_dim: Sequence[int] = (16, 56, 56)):
        super().__init__()
        if hidden_size % num_heads or sum(axes_dim) != hidden_size // num_heads:
            raise ValueError(f"Flux: heads of {hidden_size}/{num_heads} and RoPE axes "
                             f"{tuple(axes_dim)} disagree")
        self.axes_dim = tuple(axes_dim)
        self.img_in = Linear(in_channels, hidden_size)
        self.time_in = MLPEmbedder(256, hidden_size)
        self.vector_in = MLPEmbedder(vec_in_dim, hidden_size)
        self.guidance_in = MLPEmbedder(256, hidden_size)
        self.txt_in = Linear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio)
            for _ in range(depth_single_blocks))
        self.final_layer = LastLayer(hidden_size, in_channels)
        self._pe: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def positions(self, tokens: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoPE's (cos, sin) of ``tokens`` text tokens (ids 0) then an
        (h, w) grid of patches, made once a shape and device."""
        key = (tokens, h, w, str(device))
        if key not in self._pe:
            ids = torch.cat([torch.zeros(tokens, 3, device=device), image_ids(h, w, device)])
            self._pe[key] = rope_angles(ids, self.axes_dim)
        return self._pe[key]

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor = None, y: torch.Tensor = None,
                guidance: torch.Tensor = None) -> torch.Tensor:
        n, _, h, w = x.shape
        if context is None or y is None or guidance is None:
            raise ValueError("Flux needs context, y and (guidance-distilled) guidance")
        dt = self.img_in.weight.dtype
        with span("flux.embed"):
            img = self.img_in(pack(x.to(dt)))
            vec = self.time_in(timestep_embedding(TIME_FACTOR * timesteps, 256).to(dt))
            vec = vec + self.guidance_in(timestep_embedding(TIME_FACTOR * guidance, 256).to(dt))
            vec = vec + self.vector_in(y.to(dt))
            txt = self.txt_in(context.to(dt))
            pe = self.positions(txt.shape[1], h // PATCH, w // PATCH, x.device)
        for i, block in enumerate(self.double_blocks):
            with span("flux.double", block=i):
                img, txt = block(img, txt, vec, pe)
        x = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_blocks):
            with span("flux.single", block=i):
                x = block(x, vec, pe)
        with span("flux.final"):
            out = self.final_layer(x[:, txt.shape[1]:], vec)
            return unpack(out, h, w).float()
