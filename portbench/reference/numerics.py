"""How the reference rounds the operands of its products.

``Numerics()`` is the reference proper: float32 operands, float32
accumulation (the caller turns TF32 off: ``float32_exact``).
``Numerics("fp8")`` is the control: every operand of a matrix product or
convolution (weights, activations, attention scores and probabilities) is
rounded to float8 e4m3 with one scale a tensor (its absolute maximum to
448, e4m3's largest finite value), and the product accumulates in float32,
as an fp8 tensor-core product does.  Norms, softmax and the elementwise
arithmetic stay float32 in both.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class Numerics:
    def __init__(self, mode=None):
        if mode not in (None, "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision holds it (float32)."""
        t = t.float()
        if self.mode is None:
            return t
        d = t.detach()
        scale = E4M3_MAX / d.abs().amax().clamp(min=1e-30)
        rounded = (d * scale).to(torch.float8_e4m3fn).float() / scale
        # the rounded value, with the gradient passing through the rounding
        return t + (rounded - d)


F32 = Numerics()


def set_numerics(model: torch.nn.Module, numerics: Numerics) -> torch.nn.Module:
    """Give every module of ``model`` that takes products ``numerics``."""
    for m in model.modules():
        if hasattr(m, "num"):
            m.num = numerics
    return model


@contextlib.contextmanager
def float32_exact():
    """Matrix products and convolutions in true float32 inside the block (no
    TF32 on the card)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
