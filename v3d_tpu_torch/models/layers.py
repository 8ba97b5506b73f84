"""Shared building blocks of the diffusion UNet (counterpart of
v3d_tpu/models/layers.py; sgm diffusionmodules/util.py and openaimodel.py).

Feature maps are NCHW tensors in ``channels_last`` memory (NCTHW in
``channels_last_3d`` for the temporal convs), so cuDNN sees the NHWC layout
while the weights keep the checkpoint's (O, I, kh, kw) shapes.  Norms compute
in float32 whatever the module dtype (GroupNorm32 semantics,
util.py:274-277).  ``Linear`` / ``Conv2d`` / ``Conv3d`` compute in their
input's dtype, as flax's ``dtype=`` does, so f32 master weights can train
under bf16 compute.  Parameter names follow the sgm checkpoint.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from v3d_tpu_torch.ops.group_norm import group_norm_act, group_norm_act_split


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, cos first (diffusionmodules/util.py:207-231)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm evaluated in float32, cast back to the input dtype, with an
    optional SiLU fused in before the cast (``act="silu"``), through
    ``ops.group_norm.group_norm_act`` (kernel K6 on the card).  eps is 1e-5
    in the UNet and 1e-6 in the VAE and the transformers' ``norm``.  Where a
    module fuses the SiLU, an ``nn.Identity`` holds the SiLU's old place in
    its Sequential, so parameter names stay the checkpoint's.  ``split``
    (rows, reduce): each sample's ``rows`` spatial positions lie on several
    ranks, x holds this rank's, and ``reduce`` adds the statistics over the
    ranks (``group_norm_act_split``; the frame-parallel UNet's temporal
    GroupNorms)."""

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 num_groups: int = 32, act: Optional[str] = None):
        super().__init__(num_groups, num_channels, eps=eps)
        if act not in (None, "silu"):
            raise ValueError(f"GroupNorm32: act must be None or 'silu', got {act}")
        self.act = act

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        if split is not None:
            return group_norm_act_split(x, self.weight, self.bias, self.num_groups,
                                        self.eps, self.act == "silu", *split)
        return group_norm_act(x, self.weight, self.bias, self.num_groups,
                              self.eps, self.act == "silu")


class LayerNormF32(nn.LayerNorm):
    """LayerNorm evaluated in float32 (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _cast(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear in the input's dtype (weights cast per call; a no-op when
    they already match)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv3d(nn.Conv3d):
    """nn.Conv3d in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


def conv_nd(dims: int, cin: int, cout: int, kernel_size, **kw) -> nn.Module:
    return (Conv2d if dims == 2 else Conv3d)(cin, cout, kernel_size, **kw)


def to_video(x: torch.Tensor, t: int) -> torch.Tensor:
    """((b t), c, h, w) -> (b, c, t, h, w); a view (channels_last in,
    channels_last_3d out)."""
    bt, c, h, w = x.shape
    return x.reshape(bt // t, t, c, h, w).permute(0, 2, 1, 3, 4)


def from_video(x: torch.Tensor) -> torch.Tensor:
    """(b, c, t, h, w) -> ((b t), c, h, w), the inverse of ``to_video``."""
    b, c, t, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)


class AlphaBlender(nn.Module):
    """Spatial/temporal mix with the "learned_with_images" strategy, the one
    V3D uses (diffusionmodules/util.py:312-369): alpha is 1 (spatial only)
    where ``image_only_indicator`` is set, else sigmoid(mix_factor).
    ``alpha_shape``: "btc" for ((b t), s, c) tokens, "bcthw" for
    (b, c, t, h, w) video maps.  An indicator of one dim holds one entry a
    row of x, whatever its shape (a frame-parallel rank's rows)."""

    def __init__(self, alpha: float = 0.5, alpha_shape: str = "btc"):
        super().__init__()
        if alpha_shape not in ("btc", "bcthw"):
            raise ValueError(alpha_shape)
        self.alpha_shape = alpha_shape
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, x_spatial, x_temporal, image_only_indicator):
        if image_only_indicator is None:
            raise ValueError("AlphaBlender needs image_only_indicator (b, t)")
        alpha = torch.sigmoid(self.mix_factor[0].float())
        alpha = torch.where(image_only_indicator.bool(),
                            torch.ones_like(alpha), alpha)  # (b, t)
        if image_only_indicator.dim() == 1:
            alpha = alpha.reshape((-1,) + (1,) * (x_spatial.dim() - 1))
        elif self.alpha_shape == "btc":
            alpha = alpha.reshape(-1, 1, 1)
        else:
            alpha = alpha[:, None, :, None, None]
        alpha = alpha.to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Upsample(nn.Module):
    """Nearest x2 + 3x3 conv (openaimodel.py:117-168)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3x3 conv, symmetric pad 1 (openaimodel.py:170-218)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.op = Conv2d(channels, out_channels or channels, 3, stride=2,
                         padding=1)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GN-SiLU-conv ResBlock with a timestep-embedding bias
    (openaimodel.py:220-365).

    ``dims=2`` on (n, c, h, w); ``dims=3`` on (b, c, t, h, w), where a
    ``kernel_size`` of (3, 1, 1) gives a temporal-only conv.  With
    ``exchange_temb_dims`` the embedding arrives (b, t, e) and is broadcast
    per frame.  ``skip_t_emb`` drops the embedding (the VAE's temporal
    stacks).  With ``use_scale_shift_norm`` (openaimodel.py:334-341) the
    embedding is a (scale, shift) pair applied after the out-norm:
    ``GN(h) * (1 + scale) + shift``, then SiLU; that norm runs without the
    fused SiLU and ``out_layers.1`` is the SiLU itself.  ``split`` goes to
    both GroupNorms (``GroupNorm32``)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, dims: int = 2,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 exchange_temb_dims: bool = False, skip_t_emb: bool = False,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        out_channels = out_channels or channels
        ks = (kernel_size,) * dims if isinstance(kernel_size, int) else tuple(kernel_size)
        pad = tuple(k // 2 for k in ks)
        self.dims = dims
        self.exchange_temb_dims = exchange_temb_dims
        self.skip_t_emb = skip_t_emb
        self.use_scale_shift_norm = use_scale_shift_norm
        # the GroupNorm + SiLU pairs are fused (K6); Identity keeps the index
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, act="silu"), nn.Identity(),
            conv_nd(dims, channels, out_channels, ks, padding=pad))
        if not skip_t_emb:
            self.emb_layers = nn.Sequential(nn.SiLU(), Linear(
                emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels))
        out_norm = ((GroupNorm32(out_channels), nn.SiLU()) if use_scale_shift_norm
                    else (GroupNorm32(out_channels, act="silu"), nn.Identity()))
        self.out_layers = nn.Sequential(
            *out_norm, nn.Dropout(0.0),
            conv_nd(dims, out_channels, out_channels, ks, padding=pad))
        self.skip_connection = (
            nn.Identity() if out_channels == channels
            else conv_nd(dims, channels, out_channels, 1))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                split=None) -> torch.Tensor:
        # in_layers.1 and, without scale-shift, out_layers.1 are Identity
        h = self.in_layers[2](self.in_layers[0](x, split))
        if not self.skip_t_emb:
            e = self.emb_layers(emb).to(h.dtype)
            if self.exchange_temb_dims:  # (b, t, c) -> (b, c, t, 1, 1)
                e = e.permute(0, 2, 1)[..., None, None]
            else:
                e = e.reshape(e.shape + (1,) * (h.dim() - 2))
            if self.use_scale_shift_norm:
                scale, shift = e.chunk(2, dim=1)
                h = self.out_layers[0](h, split) * (1 + scale) + shift
                return self.skip_connection(x) + self.out_layers[1:](h)
            h = h + e
        return self.skip_connection(x) + self.out_layers[1:](self.out_layers[0](h, split))
