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
(``flash_attn_fwd_wide``, csrc/flash_attn_fwd_wide.cu; its launch plan is
``flash_wide_plan``); any other d on the card raises.

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
    tma_ready,
)

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
WIDE_HEAD_DIMS = (80, 128, 512)  # K9's compiled head widths

# The plain formulas: ``_xla_reference_bshd`` on (b, s, h, d); on the (b, h,
# s, d) views the kernels take, ``_xla_reference`` is K1's plain version,
# which is also K9's (f32 softmax, P in q's dtype).
xla_reference_bshd = attention_plain
flash_attn_fwd_wide_plain = flash_attn_fwd_plain


# K9's bf16 kernel (csrc/flash_attn_fwd_wide.cu ``Wide<D>``): consumer
# warpgroups, query rows a block (at d = 512 the two warpgroups share 64
# rows and split O's d columns; one of them computes S and hands P over),
# keys a K/V tile, ring slots; every tile is loaded as
# 64-column boxes of 128-byte rows (128-byte swizzle) plus, at d = 80, one
# 16-column box (32-byte swizzle).
WIDE_BF16 = {80: dict(consumers=1, block_q=64, block_k=128, stages=2, split_d=False),
             128: dict(consumers=2, block_q=128, block_k=128, stages=2, split_d=False),
             512: dict(consumers=2, block_q=64, block_k=32, stages=2, split_d=True)}
# K9's f32 kernel: 256 threads, 64 query rows and 64 keys a tile, K chunks
# of 64 columns (d = 80: all 80), V chunks of 4096 / d keys (d = 80: 64),
# a ring of 3 chunk slots.
WIDE_F32_THREADS, WIDE_F32_Q, WIDE_F32_K = 256, 64, 64


def flash_wide_plan(b: int, h: int, sq: int, sk: int, d: int,
                    dtype: torch.dtype) -> dict:
    """The launch of K9 for a (b, h, sq, d) x (b, h, sk, d) call: route
    ("wgmma" for bf16, "fma" for f32), grid, threads, dynamic shared memory
    (``v3d_flash_attn_fwd_wide_smem``), the key tiles each block walks and
    the key splits (1: one launch writes o; the VAE encode's 64 blocks are
    one partial wave, PERF.md); bf16 also the TMA boxes of a Q and of a K/V
    tile as (rows, columns, swizzle bytes), f32 its chunks a tile."""
    if d not in WIDE_HEAD_DIMS:
        raise ValueError(f"flash_wide_plan: d must be one of {WIDE_HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16:
        c = WIDE_BF16[d]
        bq, bk, st = c["block_q"], c["block_k"], c["stages"]
        cols = [64] * (d // 64) + ([d % 64] if d % 64 else [])
        # the hand-over: two tile parities of P's fragments and two rescale
        # factors, then two row sums, a consumer thread
        handover = (2 * (bk // 4 + 2) + 2) * 128 * 4 if c["split_d"] else 0
        return {"route": "wgmma", "grid": (-(-sq // bq), b * h),
                "threads": 128 * (c["consumers"] + 1), "consumers": c["consumers"],
                "split_d": c["split_d"], "stages": st,
                "smem": bq * d * 2 + 2 * st * bk * d * 2 + handover
                + 8 * (1 + 4 * st) + 1024,
                "q_boxes": [(bq, n, 2 * n) for n in cols],
                "kv_boxes": [(bk, n, 2 * n) for n in cols],
                "kv_tiles": -(-sk // bk), "splits": 1}
    if dtype != torch.float32:
        raise TypeError(f"flash_wide_plan: float32 or bfloat16, got {dtype}")
    vec = d % 64 == 0
    dc = 64 if vec else d
    vk = 4096 // d if vec else WIDE_F32_K
    slot = max(WIDE_F32_K * (dc + 4), vk * d)
    return {"route": "fma", "grid": (-(-sq // WIDE_F32_Q), b * h),
            "threads": WIDE_F32_THREADS,
            "smem": 4 * (WIDE_F32_Q * (d + 4) + 3 * slot
                         + WIDE_F32_K * (WIDE_F32_Q + 4)),
            "chunks": {"k": d // dc, "v": WIDE_F32_K // vk},
            "kv_tiles": -(-sk // WIDE_F32_K), "splits": 1}


def flash_attn_fwd_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """K9: softmax(q k^T / sqrt(d)) v on the (b, h, s, d) layout for d = 80,
    128 or 512 (ValueError for any other).  q/k/v may be strided views with
    unit stride on d; in bf16 an operand whose base or strides are not
    16-byte multiples is copied to an aligned buffer first (``tma_ready``).
    The result is a (b, h, sq, d) view of a (b, sq, h, d)-contiguous buffer,
    as K1's."""
    if use_plain(q, k, v):
        return flash_attn_fwd_wide_plain(q, k, v)
    code = _check_bhsd("flash_attn_fwd_wide", q, k, v, WIDE_HEAD_DIMS)
    b, h, sq, d = q.shape
    if q.dtype == torch.bfloat16:
        (q, qs), (k, ks), (v, vs) = tma_ready(q), tma_ready(k), tma_ready(v)
    else:
        qs, ks, vs = q.stride()[:3], k.stride()[:3], v.stride()[:3]
    o = _like_projection(b, sq, h, d, q)
    launch("flash_attn_fwd_wide", "v3d_flash_attn_fwd_wide", q.device, code, d,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq,
           k.shape[2], *qs, *ks, *vs, *o.stride()[:3])
    return o


def flash_wide_probe(d: int, which: int, a: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """One of K9's bf16 products alone at width ``d``, on the card, in f32:
    ``which`` 0 is S = a (64, d) @ b (bk, d)^T, both read K-major (at d = 80
    the 64-column atom and the 16-column one; at d = 512 by the warpgroup
    that hands P over), 1 is O = a (64, bk) @ b (bk, d) with a in register
    fragments and b MN-major (at d = 512 half the columns a warpgroup); bk is the kernel's key tile (``WIDE_BF16``).  a, b contiguous
    bf16 on one CUDA device.  For the card tests and chip_smoke.py; not K9,
    so not counted."""
    from v3d_tpu_torch.kernels.build import library

    bk = WIDE_BF16[d]["block_k"]
    shapes = {0: ((64, d), (bk, d), (64, bk)), 1: ((64, bk), (bk, d), (64, d))}
    a_shape, b_shape, out_shape = shapes[which]
    for name, x, shape in (("a", a, a_shape), ("b", b, b_shape)):
        if (x.device.type != "cuda" or x.dtype != torch.bfloat16
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"flash_wide_probe({d}, {which}): {name} must be "
                             f"contiguous bf16 {shape} on the card, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = library().v3d_flash_wide_probe(
            d, which, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_wide_probe({d}, {which}): launch failed, error {err}")
    return out


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
