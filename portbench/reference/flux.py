"""The reference FLUX.1: the transformer of black-forest-labs/flux
(``src/flux/model.py``, ``modules/layers.py``), its rectified-flow Euler
over the shifted schedule (``sampling.py``) and the 16-channel decode with
the autoencoder's scale and shift, in plain float32 PyTorch with the
checkpoint's parameter names.  It imports nothing of the port.

Every product takes its operands through ``num.q`` (``numerics.py``).
Departures from BFL's code, none of them in the mathematics:
- BFL runs in the weights' dtype (bf16): the time and guidance scalars are
  rounded to bf16 before their embedding, and the schedule is computed in
  float32 torch; here everything is float32 and the schedule is computed
  in float64 and rounded to float32 once, as the port does.
- The latent is (n, h, w, c) on the way in and out of ``FluxPipeline``
  (the port's engine layout); the network packs the NCHW latent as BFL's
  ``rearrange(img, "b c (h ph) (w pw) -> b (h w) (c ph pw)")`` does.
- Attention scores are formed in blocks of query rows
  (``layers.softmax_attention``), the same formula.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Linear, softmax_attention, timestep_embedding
from portbench.reference.numerics import F32

TIME_FACTOR = 1000.0
THETA = 10_000
PATCH = 2


# -- the schedule ---------------------------------------------------------------

def flux_sigmas(n: int, image_tokens: int, base_shift: float = 0.5, max_shift: float = 1.15,
                base_tokens: int = 256, max_tokens: int = 4096) -> np.ndarray:
    """get_schedule(n, image_tokens): time_shift(mu, 1, linspace(1, 0, n + 1))
    with mu = get_lin_function(base_tokens, base_shift, max_tokens,
    max_shift)(image_tokens); float32, 1 first and 0 last."""
    m = (max_shift - base_shift) / (max_tokens - base_tokens)
    mu = base_shift + m * (image_tokens - base_tokens)
    t = np.linspace(1.0, 0.0, n + 1, dtype=np.float64)
    out = np.zeros_like(t)
    live = t > 0
    out[live] = math.exp(mu) / (math.exp(mu) + (1.0 / t[live] - 1.0))
    return out.astype(np.float32)


# -- the transformer -------------------------------------------------------------

def rope(pos: torch.Tensor, dim: int):
    """(cos, sin) of positions (L,) at dim / 2 frequencies, float64 -> f32."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    out = pos.double()[:, None] * (1.0 / THETA ** scale)[None]
    return torch.cos(out).float(), torch.sin(out).float()


def embed_nd(ids: torch.Tensor, axes_dim: Sequence[int]):
    """EmbedND: each axis' rope, the frequencies side by side."""
    parts = [rope(ids[:, i], d) for i, d in enumerate(axes_dim)]
    return torch.cat([c for c, _ in parts], -1), torch.cat([s for _, s in parts], -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, h, L, d): each adjacent pair (x0, x1) to (cos x0 - sin x1,
    sin x0 + cos x1)."""
    x = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], -1).flatten(-2)


class JointAttention(nn.Module):
    """``attention(q, k, v, pe)``: RoPE on q and k, softmax(q k^T / sqrt(d))
    v on (b, heads, L, d), -> (b, L, heads d)."""

    num = F32

    def __init__(self, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head

    def forward(self, q, k, v, pe):
        cos, sin = pe
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        b, h, L, d = q.shape
        o = softmax_attention(q.reshape(b * h, L, d), k.reshape(b * h, L, d),
                              v.float().reshape(b * h, L, d), self.num)
        return o.reshape(b, h, L, d).transpose(1, 2).reshape(b, L, h * d)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """nn.LayerNorm(elementwise_affine=False, eps=1e-6)."""
    return F.layer_norm(x.float(), x.shape[-1:], None, None, 1e-6)


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
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + 1e-6) * self.scale.float()


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.norm = QKNorm(dim // num_heads)
        self.proj = Linear(dim, dim)

    def qkv_heads(self, x):
        """rearrange(qkv, "B L (K H D) -> K B H L D"), q and k normed."""
        b, L, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, L, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        return self.norm.query_norm(q), self.norm.key_norm(k), v


class Modulation(nn.Module):
    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = Linear(dim, self.multiplier * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        mlp = int(hidden_size * mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden_size, double=True))
            setattr(self, f"{s}_attn", SelfAttention(hidden_size, num_heads))
            setattr(self, f"{s}_mlp", nn.Sequential(
                Linear(hidden_size, mlp), nn.GELU(approximate="tanh"), Linear(mlp, hidden_size)))
        self.attention = JointAttention(num_heads, hidden_size // num_heads)

    def forward(self, img, txt, vec, pe):
        i1, i2 = (self.img_mod(vec)[j:j + 3] for j in (0, 3))
        t1, t2 = (self.txt_mod(vec)[j:j + 3] for j in (0, 3))
        img_q, img_k, img_v = self.img_attn.qkv_heads((1 + i1[1]) * layer_norm(img) + i1[0])
        txt_q, txt_k, txt_v = self.txt_attn.qkv_heads((1 + t1[1]) * layer_norm(txt) + t1[0])
        attn = self.attention(torch.cat((txt_q, img_q), 2), torch.cat((txt_k, img_k), 2),
                              torch.cat((txt_v, img_v), 2), pe)
        t = txt.shape[1]
        txt_attn, img_attn = attn[:, :t], attn[:, t:]
        img = img + i1[2] * self.img_attn.proj(img_attn)
        img = img + i2[2] * self.img_mlp((1 + i2[1]) * layer_norm(img) + i2[0])
        txt = txt + t1[2] * self.txt_attn.proj(txt_attn)
        txt = txt + t2[2] * self.txt_mlp((1 + t2[1]) * layer_norm(txt) + t2[0])
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.linear1 = Linear(hidden_size, hidden_size * 3 + self.mlp_hidden_dim)
        self.linear2 = Linear(hidden_size + self.mlp_hidden_dim, hidden_size)
        self.norm = QKNorm(hidden_size // num_heads)
        self.modulation = Modulation(hidden_size, double=False)
        self.attention = JointAttention(num_heads, hidden_size // num_heads)

    def forward(self, x, vec, pe):
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = torch.split(self.linear1((1 + scale) * layer_norm(x) + shift),
                               [3 * self.hidden_size, self.mlp_hidden_dim], dim=-1)
        b, L, _ = qkv.shape
        q, k, v = qkv.reshape(b, L, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        attn = self.attention(self.norm.query_norm(q), self.norm.key_norm(k), v, pe)
        return x + gate * self.linear2(torch.cat((attn, gelu_tanh(mlp)), 2))


class LastLayer(nn.Module):
    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.linear = Linear(hidden_size, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 2 * hidden_size))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        return self.linear((1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :])


class Flux(nn.Module):
    """model.py ``Flux`` on (n, c, h, w) latents: packs 2x2 patches, the
    blocks, unpacks the velocity."""

    def __init__(self, in_channels: int = 64, vec_in_dim: int = 768,
                 context_in_dim: int = 4096, hidden_size: int = 3072,
                 mlp_ratio: float = 4.0, num_heads: int = 24, depth: int = 19,
                 depth_single_blocks: int = 38, axes_dim: Sequence[int] = (16, 56, 56)):
        super().__init__()
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

    def forward(self, x, timesteps, context, y, guidance):
        n, c, h, w = x.shape
        p = PATCH
        hp, wp = h // p, w // p
        img = x.float().reshape(n, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5)
        img = self.img_in(img.reshape(n, hp * wp, c * p * p))
        vec = self.time_in(timestep_embedding(TIME_FACTOR * timesteps.float(), 256))
        vec = vec + self.guidance_in(timestep_embedding(TIME_FACTOR * guidance.float(), 256))
        vec = vec + self.vector_in(y.float())
        txt = self.txt_in(context.float())
        t = txt.shape[1]
        img_ids = torch.zeros(hp, wp, 3, device=x.device)
        img_ids[..., 1] = torch.arange(hp, device=x.device)[:, None]
        img_ids[..., 2] = torch.arange(wp, device=x.device)[None, :]
        ids = torch.cat([torch.zeros(t, 3, device=x.device), img_ids.reshape(hp * wp, 3)])
        pe = embed_nd(ids, self.axes_dim)
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, pe)
        seq = torch.cat((txt, img), 1)
        for block in self.single_blocks:
            seq = block(seq, vec, pe)
        out = self.final_layer(seq[:, t:], vec)
        out = out.reshape(n, hp, wp, c, p, p).permute(0, 3, 1, 4, 2, 5)
        return out.reshape(n, c, h, w)


# -- the pipeline ------------------------------------------------------------------

class FluxPipeline:
    """The flow denoiser D(x, t) = x - t v(x, t), Euler over the shifted
    schedule from the noise itself, and the decode of z / scale + shift."""

    def __init__(self, transformer, decoder, scale_factor: float, shift_factor: float):
        self.transformer, self.decoder = transformer, decoder
        self.scale_factor, self.shift_factor = scale_factor, shift_factor

    def velocity(self, x: torch.Tensor, sigma: torch.Tensor, cond: Dict) -> torch.Tensor:
        """v on (n, h, w, c) latents."""
        out = self.transformer(x.float().permute(0, 3, 1, 2), sigma, cond["crossattn"],
                               cond["vector"], cond["guidance"])
        return out.permute(0, 2, 3, 1)

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond: Dict) -> torch.Tensor:
        s = sigma.float().reshape(-1, 1, 1, 1)
        return x.float() - s * self.velocity(x, sigma, cond)

    def euler(self, sigmas: np.ndarray, noise: torch.Tensor, cond: Dict) -> torch.Tensor:
        """sampling.py ``denoise``: img + (t_prev - t_curr) v, from the noise."""
        x = noise.float()
        for s, s1 in zip(sigmas[:-1], sigmas[1:]):
            sig = torch.full((x.shape[0],), float(s), device=x.device)
            x = x + (float(s1) - float(s)) * self.velocity(x, sig, cond)
        return x

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(n, h, w, 16) -> (n, H, W, 3) in [0, 1]."""
        x = self.decoder((z.float() / self.scale_factor + self.shift_factor).permute(0, 3, 1, 2))
        return ((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
