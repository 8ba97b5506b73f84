"""Flash attention on the (b, s, h, d) layout: the routes of T2-T4, and K9.

Counterpart of v3d_tpu/ops/flash_attention.py.  The JAX package has three
Pallas forwards of one function, softmax(q k^T / sqrt(d)) v, that differ
only in how the TPU fetches a head: ``_flash_forward`` (T2) on (b*h, s, d)
after a transpose, ``_flash_heads_forward`` (T3) with the heads unrolled
over the (s, h*d) channels, and ``_flash_packed_forward`` (T4) with the head
chosen by the channel block index.  On the card they are one call
(``flash_bh``): a kernel that reads (b, h, s, d) through arbitrary b/h/s
strides takes the (b, s, h, d) input as a strided view, so nothing is
copied.  d = 64 runs K1 (csrc/flash_attn_fwd.cu), d = 80, 128 and 512 run K9
(``flash_attn_fwd_wide``, csrc/flash_attn_fwd_wide.cu); any other d on the
card raises.

``flash_attention`` keeps the JAX wrapper's routing: blocks clamped to the
sequence, and the plain formula where they do not tile it or d is neither
64 nor a multiple of 128 (flash_attention.py:318-326).  The block sizes
choose nothing else.  ``flash_attention_packed`` has no such test
(ROADMAP C4: there the JAX kernel's grid skips a ragged tail of keys; the
kernels here read every key).  The backward recomputes through the plain
formula, as ``_flash_bh_bwd`` / ``_flash_heads_bwd`` / ``_flash_packed_bwd``
do (:114-117, :297-300, :247-260); K7/K8 belong to T1's stock kernel.
"""

from __future__ import annotations

import torch

from v3d_tpu_torch.ops._dispatch import launch, needs_grad, plain_vjp, use_plain
from v3d_tpu_torch.ops.attention import (
    _check_bhsd,
    _like_projection,
    attention_plain,
    flash_attn_fwd,
    flash_attn_fwd_plain,
)

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
WIDE_HEAD_DIMS = (80, 128, 512)  # K9's compiled head widths

# The plain formulas: ``_xla_reference_bshd`` on (b, s, h, d); on the (b, h,
# s, d) views the kernels take, ``_xla_reference`` is K1's plain version,
# which is also K9's (f32 softmax, P in q's dtype).
xla_reference_bshd = attention_plain
flash_attn_fwd_wide_plain = flash_attn_fwd_plain


def flash_attn_fwd_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """K9: softmax(q k^T / sqrt(d)) v on the (b, h, s, d) layout for d = 80,
    128 or 512 (ValueError for any other).  q/k/v may be strided views with
    unit stride on d; the result is a (b, h, sq, d) view of a (b, sq, h,
    d)-contiguous buffer, as K1's."""
    if use_plain(q, k, v):
        return flash_attn_fwd_wide_plain(q, k, v)
    code = _check_bhsd("flash_attn_fwd_wide", q, k, v, WIDE_HEAD_DIMS)
    b, h, sq, d = q.shape
    o = _like_projection(b, sq, h, d, q)
    launch("flash_attn_fwd_wide", "v3d_flash_attn_fwd_wide", q.device, code, d,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq,
           k.shape[2], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *o.stride()[:3])
    return o


def flash_bh_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """The forward of T2-T4 on (b, h, s, d) views: K1 at d = 64, else K9."""
    if q.shape[-1] == 64:
        return flash_attn_fwd(q, k, v)
    return flash_attn_fwd_wide(q, k, v)


class _FlashRecompute(torch.autograd.Function):
    """``flash_bh_fwd``, with the backward recomputed through the plain
    formula (``_flash_bh_bwd``, flash_attention.py:114-117)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_bh_fwd(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(flash_attn_fwd_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


def flash_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """``_flash_bh`` (flash_attention.py:105-120) on (b, h, s, d): q (b, h,
    sq, d), k/v (b, h, sk, d) -> (b, h, sq, d)."""
    if needs_grad(q, k, v):
        return _FlashRecompute.apply(q, k, v)
    return flash_bh_fwd(q, k, v)


def _bshd(q, k, v):
    """``flash_bh`` on (b, s, h, d) through (b, h, s, d) views."""
    return flash_bh(q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2)).transpose(1, 2)


def flash_tiles(sq: int, sk: int, d: int, block_q: int, block_k: int) -> bool:
    """``flash_attention``'s own test (flash_attention.py:318-323): the blocks,
    clamped to the sequence, tile it, and d is 64 or a multiple of 128."""
    bq, bk = min(block_q, sq), min(block_k, sk)
    return sq % bq == 0 and sk % bk == 0 and (d == 64 or d % 128 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    heads_resident: bool = None) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, h, d) -> (b, sq, h, d): T2's route, or
    T3's with ``heads_resident`` and 1 < h <= 10 (flash_attention.py:336;
    the same call here, so the flag chooses nothing); the plain formula
    where the shapes do not tile."""
    if not flash_tiles(q.shape[1], k.shape[1], q.shape[3], block_q, block_k):
        return attention_plain(q, k, v)
    return _bshd(q, k, v)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_q: int = DEFAULT_BLOCK_Q,
                           block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """T4's route (flash_attention.py:266-277): (b, s, h, d) -> (b, s, h, d)
    at any sequence length and block size."""
    return _bshd(q, k, v)
