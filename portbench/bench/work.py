"""The yardstick's arithmetic: the card's peaks, the least time of a piece of
work, the operations and bytes of the port's kernels computed from their
shapes (copied from ``chip_smoke.py``: ``bound_ms``, ``_attention_work``,
``group_norm_work``, ``flash_bwd_work``), and the work a model does,
counted from the plain reference on the meta device: its FLOPs
(``FlopCounterMode``) and the shape of every attention and GroupNorm call
(forward hooks).  None of it reads the port's launch counters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12    # FLOP/s, tensor cores
PEAK_FP32 = 67e12     # FLOP/s, outside the tensor cores
PEAK_HBM = 3.35e12    # bytes/s


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16):
    """(least time in ms, what bounds it): operations over the peak of their
    type or bytes over the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_work(b, h, sq, sk, d, size):
    """(FLOPs, bytes) of softmax(q k^T) v: two products; q, k, v read once,
    o written once."""
    return 4 * b * h * sq * sk * d, (2 * b * h * sq * d + 2 * b * h * sk * d) * size


def group_norm_work(shape, silu: bool, elem: int, param_elem: int):
    """(FLOPs, bytes) of one GroupNorm call on ``shape``: the statistics and
    the affine (5 an element, 8 with SiLU); x read once, y written once,
    scale and bias read once."""
    n = math.prod(shape)
    return (8 if silu else 5) * n, 2 * n * elem + 2 * shape[1] * param_elem


# products per (q, k) pair of the attention backward: the dq kernel (S, dP,
# dQ) and the dk/dv kernel (S^T, dP^T, dV, dK)
BWD_PRODUCTS = {"dq": 3, "dkv": 4}


def flash_bwd_work(b, h, s, products):
    """(FLOPs, bytes) of backward work at (b, h, s, 64) self-attention:
    ``products`` 64-deep products of 2 b h s^2 64 FLOP each; six (b, h, s,
    64) bf16 tensors and two f32 row vectors moved once."""
    return products * 2 * b * h * s * s * 64, 6 * b * h * s * 64 * 2 + 2 * b * h * s * 4


def model_work(fn: Callable[[], object], model: torch.nn.Module) -> Dict:
    """Run ``fn`` (a forward of the reference ``model`` on meta tensors) and
    return its FLOPs and its calls: ``attention`` (b, heads, sq, sk, d, self
    or not) of every CrossAttention-like module (``to_q`` / ``to_k`` and
    ``heads``), ``group_norm`` ((shape), silu) of every GroupNorm."""
    from portbench.reference.layers import CrossAttention, GroupNorm32

    calls: Dict[str, List] = {"attention": [], "group_norm": []}
    hooks = []

    def on_attention(mod, args, kwargs, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        sk = x.shape[1] if ctx is None else ctx.shape[1]
        calls["attention"].append((x.shape[0], mod.heads, x.shape[1], sk,
                                   mod.dim_head, ctx is None))

    def on_norm(mod, args, out):
        calls["group_norm"].append((tuple(args[0].shape), mod.act == "silu"))

    for m in model.modules():
        if isinstance(m, CrossAttention):
            hooks.append(m.register_forward_hook(on_attention, with_kwargs=True))
        elif isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_hook(on_norm))
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn()
    finally:
        for h in hooks:
            h.remove()
    return {"flops": float(counter.get_total_flops()), **calls}


def k1_sites(calls):
    """The attention calls (``model_work``'s) that the port's default routing
    sends to K1 (``ops/attention.py``: the "bhsd" layout's auto pick):
    self-attention at d = 64 over sq = sk >= 1024 tokens, a multiple of 512."""
    return [a for a in calls
            if a[5] and a[4] == 64 and a[2] == a[3] and a[2] >= 1024 and a[2] % 512 == 0]
