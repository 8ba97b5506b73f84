"""GroupNorm(32) + optional SiLU in float32: kernel K6 and the plain formula.

Counterpart of v3d_tpu/ops/fused_groupnorm.py.  ``group_norm_act`` is the
port of ``group_norm_act`` (fused_groupnorm.py:176-222): the forward is K6
(csrc/group_norm.cu, the port of the two-pass ``_pallas_group_norm``,
:90-138) and the backward recomputes through the plain formula, as
``_gn_bwd`` (:214-219) does; the JAX package has no backward kernel here.

Tensors are NCHW / NCTHW in ``channels_last`` / ``channels_last_3d`` memory,
so the kernel reads them as (B, L, C) with channels fastest, as the Pallas
kernel's (B, L, C) blocks.  Scale and bias may be float32 or bfloat16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from v3d_tpu_torch.ops._dispatch import (
    DTYPE_CODES,
    launch,
    needs_grad,
    plain_vjp,
    use_plain,
)

# blocks the statistics pass aims for, whatever B (the card has 132 SMs)
_STATS_BLOCKS = 1024
_MAX_CHANNELS = 4096


def group_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain version of K6, line for line ``_reference``
    (fused_groupnorm.py:141-163) on the (B, C, *spatial) layout."""
    C = x.shape[1]
    G = num_groups
    xf = x.float()
    red = tuple(range(2, x.dim()))
    n_per_ch = xf[0, 0].numel()
    s1 = torch.sum(xf, dim=red)
    s2 = torch.sum(xf * xf, dim=red)
    B = s1.shape[0]
    g1 = torch.sum(s1.reshape(B, G, C // G), dim=-1)
    g2 = torch.sum(s2.reshape(B, G, C // G), dim=-1)
    n = n_per_ch * (C // G)
    mean = g1 / n
    var = torch.clamp(g2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = torch.repeat_interleave(mean, C // G, dim=-1)
    inv_c = torch.repeat_interleave(inv, C // G, dim=-1)
    shape = (B, C) + (1,) * (x.dim() - 2)
    ch = (C,) + (1,) * (x.dim() - 2)
    y = ((xf - mean_c.reshape(shape))
         * (inv_c.reshape(shape) * scale.float().reshape(ch))
         + bias.float().reshape(ch))
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def channels_last_rows(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(B, L, C) when x (B, C, *spatial) lies in channels-last memory, so
    that it reads as a contiguous (B, L, C) array; else None."""
    if x.dim() < 3:
        return None
    rows = x.permute(0, *range(2, x.dim()), 1)
    if not rows.is_contiguous():
        return None
    return x.shape[0], x[0, 0].numel(), x.shape[1]


def group_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5,
                   silu: bool = False) -> torch.Tensor:
    """GroupNorm(num_groups) with f32 statistics (+ SiLU in f32), output in
    x.dtype and x's channels-last memory.  On a CUDA tensor K6; it raises on
    memory that is not channels-last rather than copy."""
    if use_plain(x, scale, bias):
        return group_norm_act_plain(x, scale, bias, num_groups, eps, silu)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"group_norm: needs float32 or bfloat16, got {x.dtype}")
    code = DTYPE_CODES[x.dtype]
    rows = channels_last_rows(x)
    if rows is None:
        raise ValueError(f"group_norm: x {tuple(x.shape)} strides {x.stride()} "
                         f"is not in channels-last memory")
    B, L, C = rows
    vec = 16 // x.element_size()
    if (C % num_groups or C % vec or C > _MAX_CHANNELS or B > 65535
            or min(B, L) == 0 or x.data_ptr() % 16):
        raise ValueError(f"group_norm: needs C a multiple of {num_groups} and "
                         f"{vec}, C <= {_MAX_CHANNELS}, 1 <= B <= 65535, a "
                         f"16-byte aligned x; got {tuple(x.shape)}")
    sdt = {torch.float32: 0, torch.bfloat16: 1}.get(scale.dtype)
    if (sdt is None or bias.dtype != scale.dtype or scale.shape != (C,)
            or bias.shape != (C,) or not scale.is_contiguous()
            or not bias.is_contiguous()):
        raise TypeError(f"group_norm: scale/bias must be contiguous ({C},) "
                        f"float32 or bfloat16, got {scale.dtype} "
                        f"{tuple(scale.shape)} {bias.dtype} {tuple(bias.shape)}")
    splits = max(1, min(-(-_STATS_BLOCKS // B), L))
    scratch = torch.empty(2 * B * splits * C + 2 * B * C, dtype=torch.float32,
                          device=x.device)
    y = torch.empty_like(x)
    launch("group_norm", "v3d_group_norm", x.device, code, x.data_ptr(),
           y.data_ptr(), scale.data_ptr(), bias.data_ptr(), sdt,
           scratch.data_ptr(), B, L, C, num_groups, splits, float(eps),
           int(silu))
    return y


class _GroupNormAct(torch.autograd.Function):
    """K6 forward; the backward recomputes through the plain formula
    (``_gn_bwd``, fused_groupnorm.py:214-219)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (num_groups, eps, silu)
        return group_norm_fwd(x, scale, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(group_norm_act_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, *ctx.config)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5,
                   silu: bool = False) -> torch.Tensor:
    """GroupNorm in f32 (+ optional fused SiLU), output in x.dtype
    (``group_norm_act``, fused_groupnorm.py:176-189), differentiable."""
    if needs_grad(x, scale, bias):
        return _GroupNormAct.apply(x, scale, bias, num_groups, eps, silu)
    return group_norm_fwd(x, scale, bias, num_groups, eps, silu)
