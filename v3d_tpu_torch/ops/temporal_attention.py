"""Temporal attention over the t frames: kernels K2 and K3, plain versions.

Counterpart of v3d_tpu/ops/temporal_attention.py.  Tokens keep the
``(b, t, s, c)`` layout of the VideoUNet's frame-major batch throughout.

- ``temporal_block_attention`` (K2, csrc/temporal_block.cu; replaces
  ``_pallas_block``): the whole temporal self-attention layer, QKV
  projection, per-(pixel, head) softmax over frames and output projection, in
  one kernel.
- ``temporal_core`` (K3, csrc/temporal_core.cu; replaces ``_pallas_core``):
  the attention alone, on q/k/v in the ``(b, t, s, heads * dh)`` layout the
  projection matmul writes.

Weights are in the torch Linear layout, ``(out, in)``.
"""

from __future__ import annotations

import math

import torch

from v3d_tpu_torch.ops._dispatch import check_kernel_inputs, launch, use_plain

# per-block shared memory the card grants (bytes)
_MAX_SMEM = 232448


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
    (b, t, s, c).  wq/wk/wv (heads*dh, c), wo (c, heads*dh), bo (c,)."""
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
    from v3d_tpu_torch.kernels.build import library

    smem = library().v3d_temporal_block_smem(code, t, c, heads, dh)
    if smem > _MAX_SMEM:
        raise ValueError(f"temporal_block: shape {x.shape} with {heads} heads "
                         f"needs {smem} B of shared memory (> {_MAX_SMEM})")
    out = torch.empty((b, t, s, c), dtype=x.dtype, device=x.device)
    launch("temporal_block", "v3d_temporal_block", x.device, code,
           x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
           wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, t, s, c, heads,
           dh, *x.stride()[:3])
    return out
