"""Multi-head attention: kernel K1 and the plain formula.

Counterpart of v3d_tpu/ops/attention.py.  The JAX package sends the
spatial self-attention at >= 1024 tokens with d = 64 to the stock Pallas
flash kernel (``attention_bhsd``, attention.py:142-168) and every other site
to the plain formula (``xla_attention``, :213-219).  Here the first is
``flash_attn_fwd`` (hand-written CUDA, csrc/flash_attn_fwd.cu) and the
second ``attention_plain``: an f32 softmax between two matmuls.
"""

from __future__ import annotations

import math

import torch

from v3d_tpu_torch.ops._dispatch import check_kernel_inputs, launch, use_plain

_LOGIT_BYTES_PER_CHUNK = 1 << 30


def _batch_chunks(b: int, logit_bytes_per_item: int):
    """Batch slices that keep the materialised f32 logits near 1 GiB (the
    plain formula would hold 12 GB at the ds1 shape); the math is unchanged."""
    step = max(1, _LOGIT_BYTES_PER_CHUNK // max(1, logit_bytes_per_item))
    return [slice(i, min(b, i + step)) for i in range(0, b, step)]


def _softmax_attention(q, k, v, logits_eq: str, out_eq: str):
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum(logits_eq, q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum(out_eq, weights, v)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, h, d) -> (b, sq, h, d)
    (xla_attention, attention.py:213-219)."""
    b, sq, h, _ = q.shape
    per = h * sq * k.shape[1] * 4
    outs = [_softmax_attention(q[sl], k[sl], v[sl], "bqhd,bkhd->bhqk",
                               "bhqk,bkhd->bqhd")
            for sl in _batch_chunks(b, per)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of K1: q (b, h, sq, d), k/v (b, h, sk, d) -> (b, h, sq, d)
    (the bhsd formula of attention.py:180-186)."""
    b, h, sq, _ = q.shape
    per = h * sq * k.shape[2] * 4
    outs = [_softmax_attention(q[sl], k[sl], v[sl], "bhqd,bhkd->bhqk",
                               "bhqk,bhkd->bhqd")
            for sl in _batch_chunks(b, per)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on the (b, h, s, d) layout, d = 64.

    q/k/v may be strided views (unit stride on d), as the projection output
    is.  The result is a (b, h, sq, d) view of a (b, sq, h, d)-contiguous
    buffer, so merging the heads for the output projection is free."""
    if use_plain(q, k, v):
        return flash_attn_fwd_plain(q, k, v)
    code = check_kernel_inputs("flash_attn_fwd", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attn_fwd: bad shapes {q.shape} {k.shape} "
                         f"{v.shape}")
    b, h, sq, d = q.shape
    if d != 64 or k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"flash_attn_fwd: needs (b, h, s, 64) q/k/v, got "
                         f"{q.shape} {k.shape}")
    sk = k.shape[2]
    if min(b, h, sq, sk) == 0 or b * h > 65535:
        raise ValueError(f"flash_attn_fwd: batch*heads must be in "
                         f"[1, 65535], got {q.shape} {k.shape}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    o = o.transpose(1, 2)
    launch("flash_attn_fwd", "v3d_flash_attn_fwd", q.device, code,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq,
           sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *o.stride()[:3])
    return o
