"""Temporal attention over the t frames: kernels K2 and K3, plain versions.

Counterpart of v3d_tpu/ops/temporal_attention.py.  Tokens keep the
``(b, t, s, c)`` layout of the VideoUNet's frame-major batch throughout.

- ``temporal_block_attention`` (K2, csrc/temporal_block.cu; replaces
  ``_pallas_block``): the whole temporal self-attention layer, QKV
  projection, per-(pixel, head) softmax over frames and output projection, in
  one kernel (bf16 on wgmma + TMA, ``temporal_block_plan``).
- ``temporal_core`` (K3, csrc/temporal_core.cu; replaces ``_pallas_core``):
  the attention alone, on q/k/v in the ``(b, t, s, heads * dh)`` layout the
  projection matmul writes.
- ``temporal_attention`` / ``temporal_attention_mxu`` (T5, T6): the public
  (B, t, h, d) APIs, the same function as ``_pallas_core``, so K3 on a
  (B, t, 1, h * d) view; no model calls them.

K2 and K3 are differentiable: as the JAX package's custom VJPs (``_block_bwd``,
``_core_bwd``, temporal_attention.py:232-235, :373-377), the backward
recomputes through the plain formula; there is no backward kernel.

Weights are in the torch Linear layout, ``(out, in)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from v3d_tpu_torch.ops._dispatch import (
    check_kernel_inputs,
    launch,
    needs_grad,
    plain_vjp,
    use_plain,
)
from v3d_tpu_torch.ops.attention import attention_plain, tma_operand, tma_strides

# per-block shared memory the card grants (bytes)
_MAX_SMEM = 232448


# K3's bf16 kernel (csrc/temporal_core.cu): 4 warps a block, each walking
# (pixel, head) items through 2 shared-memory slots of three t x dh bf16
# slabs (head width padded to a multiple of 32, rows 8 elements wider),
# after one zero row; the grid is what fits on the card at once, or fewer.
K3_WARPS = 4
K3_SLOTS = 2


def temporal_core_plan(b: int, t: int, s: int, heads: int, dh: int) -> dict:
    """K3's bf16 launch: (pixel, head) items, the most blocks it takes (one
    item a slot), threads and dynamic shared memory per block; the card's
    occupancy caps the blocks (``v3d_temporal_core_grid``)."""
    items = b * s * heads
    pitch = -(-dh // 32) * 32 + 8
    return {"items": items, "max_blocks": -(-items // (K3_WARPS * K3_SLOTS)),
            "threads": 32 * K3_WARPS,
            "smem": 2 * pitch * (1 + K3_WARPS * K3_SLOTS * 3 * t)}


# K2 (csrc/temporal_block.cu).  The bf16 wgmma + TMA kernel: 3 warpgroups
# (two consumers of 64 token rows, one producer), 128 // t pixels x t frames
# a block, a 5-slot ring of 6 KB weight chunks; x, the head outputs and k,
# v in 16 KB tiles of 128 rows; out-projection passes of 160 columns.  The
# FMA kernel: 256 threads, 2 pixels a block.
K2_TILE_ROWS = 128
K2_STAGES = 5
K2_TILE = K2_TILE_ROWS * 128
K2_STAGE_BYTES = 3 * 64 * 16 * 2
K2_OUT_N = 160
K2_FMA_PIX = 2


def temporal_block_plan(b: int, t: int, s: int, c: int, heads: int, dh: int,
                        dtype=torch.bfloat16) -> dict:
    """K2's launch: ``path`` "wgmma" (bf16, dh = 64, c a multiple of 160 and
    the tiles within the card's shared memory) or "fma"; ``pixels`` and
    ``rows`` (token rows) a block, ``grid``, ``threads``, ring ``stages``,
    dynamic shared memory ``smem`` (``v3d_temporal_block_smem``)."""
    inner = heads * dh
    smem = (c // 64 + inner // 64 + 2) * K2_TILE + K2_STAGES * K2_STAGE_BYTES \
        + 8 * (1 + 2 * K2_STAGES) + 1024
    if (dtype == torch.bfloat16 and dh == 64 and c % K2_OUT_N == 0
            and 1 <= t <= 32 and smem <= _MAX_SMEM):
        pix = K2_TILE_ROWS // t
        return {"path": "wgmma", "pixels": pix, "rows": pix * t,
                "grid": b * -(-s // pix), "threads": 384, "stages": K2_STAGES,
                "smem": smem}
    elem = 4 if dtype == torch.float32 else 2
    rows = t * K2_FMA_PIX
    smem = (4 * (3 * rows * (dh + 1) + 64 * 33 + K2_FMA_PIX * t * (t + 1))
            + elem * (rows * c + rows * inner))
    return {"path": "fma", "pixels": K2_FMA_PIX, "rows": rows,
            "grid": b * -(-s // K2_FMA_PIX), "threads": 256, "stages": 0,
            "smem": smem}


def temporal_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Plain version of K3: (b, t, s, heads*dh) x3 -> (b, t, s, heads*dh),
    softmax over the key frames (``_xla_core``, temporal_attention.py:189)."""
    b, t, s, hd = q.shape
    dh = hd // heads
    split = (b, t, s, heads, dh)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("btshd,bushd->bshtu", q.reshape(split).float(),
                          k.reshape(split).float()) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bshtu,bushd->btshd", p, v.reshape(split))
    return o.reshape(b, t, s, hd)


def temporal_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """18-frame softmax attention per (b, pixel, head) on (b, t, s, heads*dh)
    q/k/v (any b/t/s strides, unit channel stride).  Returns a contiguous
    (b, t, s, heads*dh) tensor."""
    if needs_grad(q, k, v):
        return _TemporalCore.apply(q, k, v, heads)
    return temporal_core_fwd(q, k, v, heads)


class _TemporalCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return temporal_core_fwd(q, k, v, heads)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(temporal_core_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, ctx.heads)


def temporal_core_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """The forward of ``temporal_core``: K3, or its plain version."""
    if use_plain(q, k, v):
        return temporal_core_plain(q, k, v, heads)
    code = check_kernel_inputs("temporal_core", q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"temporal_core: q/k/v must share one (b, t, s, hd) "
                         f"shape, got {q.shape} {k.shape} {v.shape}")
    b, t, s, hd = q.shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"temporal_core: {hd} channels do not split into "
                         f"{heads} heads")
    dh = hd // heads
    if not (1 <= t <= 32 and dh <= 128 and b * s > 0):
        raise ValueError(f"temporal_core: needs 1 <= t <= 32, dh <= 128, "
                         f"got t={t} dh={dh} shape {q.shape}")
    o = torch.empty((b, t, s, hd), dtype=q.dtype, device=q.device)
    launch("temporal_core", "v3d_temporal_core", q.device, code, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, s, heads, dh,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    return o


def temporal_block_attention_plain(x: torch.Tensor, wq: torch.Tensor,
                                   wk: torch.Tensor, wv: torch.Tensor,
                                   wo: torch.Tensor, bo: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """Plain version of K2 (``_block_xla``, temporal_attention.py:286)."""
    q, k, v = (torch.matmul(x, w.t()) for w in (wq, wk, wv))
    o = temporal_core_plain(q, k, v, heads)
    return torch.matmul(o, wo.t()) + bo


def temporal_block_attention(x: torch.Tensor, wq: torch.Tensor,
                             wk: torch.Tensor, wv: torch.Tensor,
                             wo: torch.Tensor, bo: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """Fused temporal self-attention layer: x (b, t, s, c) post-norm tokens ->
    (b, t, s, c).  wq/wk/wv (heads*dh, c), wo (c, heads*dh), bo (c,), all in
    x's dtype (the caller casts them, as ``_pallas_block`` does,
    temporal_attention.py:332-335)."""
    if needs_grad(x, wq, wk, wv, wo, bo):
        return _TemporalBlock.apply(x, wq, wk, wv, wo, bo, heads)
    return temporal_block_fwd(x, wq, wk, wv, wo, bo, heads)


class _TemporalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, bo, heads):
        ctx.save_for_backward(x, wq, wk, wv, wo, bo)
        ctx.heads = heads
        return temporal_block_fwd(x, wq, wk, wv, wo, bo, heads)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(temporal_block_attention_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, ctx.heads)


def temporal_block_fwd(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       heads: int, prof: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The forward of ``temporal_block_attention``: K2, or its plain
    version.  ``prof``: an int64 CUDA tensor of 6 per block of the wgmma
    kernel that receives each block's clock64 cycles (x wait, QKV products,
    softmax, output projection, store) and rows (chip_smoke.py phase 3)."""
    if use_plain(x, wq, wk, wv, wo, bo):
        return temporal_block_attention_plain(x, wq, wk, wv, wo, bo, heads)
    code = check_kernel_inputs("temporal_block", x, wq, wk, wv, wo, bo)
    if x.dim() != 4:
        raise ValueError(f"temporal_block: x must be (b, t, s, c), got "
                         f"{x.shape}")
    b, t, s, c = x.shape
    inner = wq.shape[0]
    if heads <= 0 or inner % heads:
        raise ValueError(f"temporal_block: {inner} channels do not split into "
                         f"{heads} heads")
    dh = inner // heads
    for name, w, shape in (("wq", wq, (inner, c)), ("wk", wk, (inner, c)),
                           ("wv", wv, (inner, c)), ("wo", wo, (c, inner)),
                           ("bo", bo, (c,))):
        if tuple(w.shape) != shape or not w.is_contiguous():
            raise ValueError(f"temporal_block: {name} must be contiguous "
                             f"{shape}, got {tuple(w.shape)} {w.stride()}")
    if not (1 <= t <= 32 and 1 <= dh <= 64 and b * s > 0):
        raise ValueError(f"temporal_block: needs 1 <= t <= 32, dh <= 64, got "
                         f"t={t} dh={dh} shape {x.shape}")
    plan = temporal_block_plan(b, t, s, c, heads, dh, x.dtype)
    if plan["smem"] > _MAX_SMEM:
        raise ValueError(f"temporal_block: shape {x.shape} with {heads} heads "
                         f"needs {plan['smem']} B of shared memory (> {_MAX_SMEM})")
    if plan["path"] == "wgmma":
        # TMA reads x through its strides where they are 16-byte multiples
        x = tma_operand(x)
        strides = tma_strides(x)
        for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
            if w.data_ptr() % 16:
                raise ValueError(f"temporal_block: {name} is not 16-byte aligned")
    else:
        strides = x.stride()[:3]
    out = torch.empty((b, t, s, c), dtype=x.dtype, device=x.device)
    launch("temporal_block", "v3d_temporal_block", x.device, code,
           x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
           wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, t, s, c, heads,
           dh, *strides, None if prof is None else prof.data_ptr())
    return out


# -- the batched (B, t, h, d) APIs (temporal_attention.py:50-168) -------------


def _frames_view(x: torch.Tensor) -> torch.Tensor:
    """(B, t, h, d) -> a (B, t, 1, h*d) view for K3 (one copy where (h, d)
    are not contiguous, as T5's own ``prep`` transposes)."""
    b, t, h, d = x.shape
    if x.stride(3) != 1 or x.stride(2) != d:
        x = x.contiguous()
    return x.view(b, t, 1, h * d)


def _batched_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    b, t, h, d = q.shape
    o = temporal_core(_frames_view(q), _frames_view(k), _frames_view(v), h)
    return o.view(b, t, h, d)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_b: int = 512) -> torch.Tensor:
    """T5 (``temporal_attention``, :50-77): q/k/v (B, t, h, d) -> (B, t, h,
    d), softmax over the key frames, f32 throughout on the TPU.  K3 with
    heads = h on (B, t, 1, h*d) views; ``block_b`` (the TPU's lane block)
    chooses nothing."""
    return _batched_core(q, k, v)


def temporal_attention_mxu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pack: int = 7, inner: int = 8) -> torch.Tensor:
    """T6 (``temporal_attention_mxu``, :137-168): T5's function, which the TPU
    packs 7 samples to a block-diagonal 126 x 126 product.  K3 as T5; K3
    keeps P in f32 where T6 rounds it to q's dtype before P V (:131), so
    the two differ by bf16 rounding.  ``pack`` and ``inner`` choose
    nothing."""
    return _batched_core(q, k, v)


def temporal_attention_packed(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pack: int = 7) -> torch.Tensor:
    """``temporal_attention_packed`` (:80-107), pure XLA in the JAX package:
    the block-diagonal mask makes it exactly the plain attention formula over
    the t frames, P in q's dtype; the plain version of T5 and T6."""
    return attention_plain(q, k, v)
