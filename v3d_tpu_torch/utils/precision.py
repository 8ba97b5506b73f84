"""Convolutions held in full float32 on the card, forward and backward.

cuDNN runs float32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, and PyTorch leaves it on.  A
``cudnn.flags`` block around the forward call does not reach the backward,
which autograd runs after the block has closed; ``conv2d_f32`` turns TF32
off in both.  The losses whose value or gradient the JAX package takes in
float32 (SSIM, LPIPS) use it, so the entry points compute what the tests
and chip_smoke.py hold, whatever the caller's setting.  On the CPU it is
``F.conv2d`` and its usual gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _no_tf32():
    """A ``cudnn.flags`` block with TF32 off and the other flags kept."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2dF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.groups, ctx.has_bias = padding, groups, bias is not None
        with _no_tf32():
            return F.conv2d(x, weight, bias, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        pad = ctx.padding
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                [1, 1], [pad, pad], [1, 1], False, [0, 0], ctx.groups,
                [need[0], need[1], ctx.has_bias and need[2]])
        return gx, gw, gb, None, None


def conv2d_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               padding: int = 0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` (stride 1, square ``padding``) in full float32 on the
    card, its gradients too."""
    return _Conv2dF32.apply(x, weight, bias, padding, groups)
