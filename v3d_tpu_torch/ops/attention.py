"""Multi-head attention: kernels K1, K7, K8, the plain formulas and the
backend dispatcher.

Counterpart of v3d_tpu/ops/attention.py.  By default the JAX package sends
the spatial self-attention at >= 1024 tokens with d = 64 to the stock Pallas
flash kernel (``attention_bhsd``, attention.py:142-168) and every other site
to the plain formula (``xla_attention``, :213-219).  Here the first is
``flash_attention``: the forward ``flash_attn_fwd`` (K1, csrc/flash_attn_fwd.cu)
and, under autograd, the backward ``flash_attn_bwd`` (K8 for dQ, then K7 for
dK/dV, csrc/flash_attn_bwd.cu), the counterparts of the stock kernel's
``_flash_attention_bwd_dq`` / ``_dkv``.  The second is ``attention_plain``:
an f32 softmax between two matmuls.

``attention`` / ``attention_bhsd`` are the dispatcher, ported line for line
with its setters (``set_default_backend``, ``set_spatial_override``) and
pickers: the "flash" and "packed" backends go to ops/flash_attention.py
(T2-T4 on K1 or K9).  Tensors on the card stand where the JAX package asks
"on TPU"; CPU tensors and ``reference_mode()`` make the pickers answer
"xla", as the JAX package's do off the TPU.  The environment switches
``V3D_SPATIAL_ATTN`` / ``V3D_ATTN_PROJ_LAYOUT`` are not read: the setters are
the API.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from v3d_tpu_torch.ops._dispatch import (
    check_kernel_inputs,
    launch,
    needs_grad,
    use_plain,
)

_LOGIT_BYTES_PER_CHUNK = 1 << 30


def _batch_chunks(b: int, logit_bytes_per_item: int):
    """Batch slices that keep the materialised f32 logits near 1 GiB (the
    plain formula would hold 12 GB at the ds1 shape); the math is unchanged."""
    step = max(1, _LOGIT_BYTES_PER_CHUNK // max(1, logit_bytes_per_item))
    return [slice(i, min(b, i + step)) for i in range(0, b, step)]


def _softmax_attention(q, k, v, logits_eq: str, out_eq: str,
                       with_lse: bool = False):
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum(logits_eq, q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum(out_eq, weights, v)
    return (out, torch.logsumexp(logits, dim=-1)) if with_lse else out


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


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         with_lse: bool = False):
    """Plain version of K1: q (b, h, sq, d), k/v (b, h, sk, d) -> (b, h, sq, d)
    (the bhsd formula of attention.py:180-186); with ``with_lse`` also each
    row's f32 log-sum-exp of the scaled logits, (b, h, sq)."""
    b, h, sq, _ = q.shape
    per = h * sq * k.shape[2] * 4
    outs = [_softmax_attention(q[sl], k[sl], v[sl], "bhqd,bhkd->bhqk",
                               "bhqk,bhkd->bhqd", with_lse)
            for sl in _batch_chunks(b, per)]
    if with_lse:
        return _cat([o for o, _ in outs]), _cat([m for _, m in outs])
    return _cat(outs)


def _check_bhsd(name: str, q, k, v, head_dims=(64,)) -> int:
    code = check_kernel_inputs(name, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    b, h, sq, d = q.shape
    if (d not in head_dims or k.shape[0] != b or k.shape[1] != h
            or k.shape[3] != d):
        raise ValueError(f"{name}: needs (b, h, s, d) q/k/v with d one of "
                         f"{', '.join(map(str, head_dims))}, got "
                         f"{q.shape} {k.shape}")
    sk = k.shape[2]
    if min(b, h, sq, sk) == 0 or b * h > 65535:
        raise ValueError(f"{name}: batch*heads must be in "
                         f"[1, 65535], got {q.shape} {k.shape}")
    return code


def _like_projection(b, s, h, d, ref):
    """A (b, h, s, d) view of a (b, s, h, d)-contiguous buffer: the layout
    the projections write and the output projection reads."""
    return torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1),
                               dtype=ref.dtype, device=ref.device)


# K1's bf16 kernel (csrc/flash_attn_fwd.cu): blocks of 64 query rows per
# consumer warpgroup plus one producer warpgroup, K/V tiles of 128 keys in a
# ring of 3 slots; dynamic shared memory = the Q tile + 3 x (K + V) tiles of
# 16 KB, 10 mbarriers, 1 KB of alignment slack.
K1_CONSUMERS = 2
K1_BLOCK_Q = 64 * K1_CONSUMERS
K1_BLOCK_K = 128
K1_THREADS = 128 * (K1_CONSUMERS + 1)
K1_STAGES = 3
K1_SMEM = (K1_BLOCK_Q * 64 * 2 + 2 * K1_STAGES * K1_BLOCK_K * 64 * 2
           + 8 * (1 + 3 * K1_STAGES) + 1024)
TMA_ALIGN = 16  # bytes: a tensor map's base address and strides


def flash_fwd_plan(b: int, h: int, sq: int, sk: int) -> dict:
    """The launch of K1's bf16 kernel for a (b, h, sq, 64) x (b, h, sk, 64)
    call: grid (query blocks, b*h), threads, shared memory, and the K/V
    tiles each block walks."""
    return {"grid": (-(-sq // K1_BLOCK_Q), b * h), "threads": K1_THREADS,
            "smem": K1_SMEM, "kv_tiles": -(-sk // K1_BLOCK_K)}


# K8 and K7 (csrc/flash_attn_bwd.cu): the same three warpgroups as K1.  K8:
# 128 query rows a block (Q and dO loaded once, 32 KB), K/V tiles of 128
# keys in a ring of 3 slots (32 KB a slot), 10 mbarriers.  K7: 128 keys a
# block (K and V in registers), Q/dO tiles of 64 query rows and their lse
# and D (2 x 256 B) in a ring of 4 slots, 8 mbarriers.  1 KB of alignment
# slack each.
BWD_THREADS = K1_THREADS
DQ_BLOCK_Q, DQ_BLOCK_K, DQ_STAGES = 64 * K1_CONSUMERS, 128, 3
DKV_BLOCK_K, DKV_BLOCK_Q, DKV_STAGES = 64 * K1_CONSUMERS, 64, 4
DQ_SMEM = (2 * DQ_BLOCK_Q * 64 * 2 + 2 * DQ_STAGES * DQ_BLOCK_K * 64 * 2
           + 8 * (1 + 3 * DQ_STAGES) + 1024)
DKV_SMEM = (DKV_STAGES * (2 * DKV_BLOCK_Q * 64 * 2 + 2 * DKV_BLOCK_Q * 4)
            + 8 * 2 * DKV_STAGES + 1024)
BWD_PROF_SLOTS = 7  # clock64 phases a block (csrc/flash_attn_bwd.cu)


def stats_pitch(sq: int) -> int:
    """Row pitch (elements) of the row-statistics scratch K8 writes for K7:
    sq rounded up to 4, so that a 2-D tensor map's row stride is a
    multiple of 16 bytes."""
    return -(-sq // 4) * 4


def flash_bwd_plan(b: int, h: int, sq: int, sk: int) -> dict:
    """The launches of K8 ("dq") and K7 ("dkv") for a (b, h, sq, 64) x (b,
    h, sk, 64) backward: grid, threads, shared memory, ring depth and the
    tiles each block walks; ``stats`` is the shape of K8's row-statistics
    scratch (lse * log2 e and D of every row)."""
    return {"dq": {"grid": (-(-sq // DQ_BLOCK_Q), b * h), "threads": BWD_THREADS,
                   "smem": DQ_SMEM, "stages": DQ_STAGES,
                   "tiles": -(-sk // DQ_BLOCK_K)},
            "dkv": {"grid": (-(-sk // DKV_BLOCK_K), b * h), "threads": BWD_THREADS,
                    "smem": DKV_SMEM, "stages": DKV_STAGES,
                    "tiles": -(-sq // DKV_BLOCK_Q)},
            "stats": (b * h, 2, stats_pitch(sq))}


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The (b, h, s) element strides under which a tensor map can read the
    (b, h, s, d) tensor ``t`` in place, or None: its base and every stride
    must be a multiple of 16 bytes, d unit-stride.  A dim of size 1 is never
    stepped, so its stride is replaced by the row width (a stride of 0 or an
    odd one there does not matter)."""
    shape, stride = t.shape, t.stride()
    if stride[-1] != 1 or t.data_ptr() % TMA_ALIGN:
        return None
    size, d = t.element_size(), shape[-1]
    sb = d if shape[0] == 1 else stride[0]
    sh = d if shape[1] == 1 else stride[1]
    ss = d if shape[2] == 1 else stride[2]
    if (sb <= 0 or sh <= 0 or ss <= 0 or (sb * size) % TMA_ALIGN
            or (sh * size) % TMA_ALIGN or (ss * size) % TMA_ALIGN):
        return None
    return sb, sh, ss


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where a tensor map can read it (``tma_strides``), else an
    aligned contiguous copy of it (a new allocation, 16-byte aligned)."""
    return tma_ready(t)[0]


def tma_ready(t: torch.Tensor):
    """``tma_operand(t)`` and its ``tma_strides``, in one pass."""
    strides = tma_strides(t)
    if strides is None:
        t = t.clone(memory_format=torch.contiguous_format)
        strides = tma_strides(t)
    return t, strides


def wgmma_probe(which: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One of K1's two bf16 products alone, on the card, in f32: ``which`` 0
    is S = a (64, 64) @ b (128, 64)^T with both operands K-major (Q K^T),
    1 is O = a (64, 128) @ b (128, 64) with a read into register fragments
    and b MN-major (P V).  a, b contiguous bf16 on one CUDA device.  For
    the card tests and chip_smoke.py; not K1, so not counted."""
    from v3d_tpu_torch.kernels.build import library

    shapes = {0: ((64, 64), (K1_BLOCK_K, 64), (64, K1_BLOCK_K)),
              1: ((64, K1_BLOCK_K), (K1_BLOCK_K, 64), (64, 64))}
    a_shape, b_shape, out_shape = shapes[which]
    for name, x, shape in (("a", a, a_shape), ("b", b, b_shape)):
        if (x.device.type != "cuda" or x.dtype != torch.bfloat16
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"wgmma_probe({which}): {name} must be contiguous "
                             f"bf16 {shape} on the card, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = library().v3d_flash_wgmma_probe(
            which, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma_probe({which}): launch failed, error {err}")
    return out


def flash_bwd_wgmma_probe(which: int, a: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
    """One of K7's register-A products alone, on the card, in f32:
    ``which`` 0 is a (64, 64) @ b (64, 64)^T with b read K-major (S^T = K
    Q^T), 1 is a @ b with b read MN-major (dV += P^T dO); a is read into
    register fragments as K7 reads K and V.  a, b contiguous bf16 on one
    CUDA device.  For the card tests and chip_smoke.py; not counted."""
    from v3d_tpu_torch.kernels.build import library

    for name, x in (("a", a), ("b", b)):
        if (x.device.type != "cuda" or x.dtype != torch.bfloat16
                or tuple(x.shape) != (64, 64) or not x.is_contiguous()):
            raise ValueError(f"flash_bwd_wgmma_probe({which}): {name} must be "
                             f"contiguous bf16 (64, 64) on the card, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    out = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = library().v3d_flash_bwd_wgmma_probe(
            which, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_wgmma_probe({which}): launch failed, "
                           f"error {err}")
    return out


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   with_lse: bool = False):
    """softmax(q k^T / sqrt(d)) v on the (b, h, s, d) layout, d = 64.

    q/k/v may be strided views (unit stride on d), as the projection output
    is; in bf16 an operand whose base or strides are not 16-byte multiples
    is copied to an aligned buffer first (``tma_operand``).  The result is
    a (b, h, sq, d) view of a (b, sq, h, d)-contiguous buffer, so merging
    the heads for the output projection is free.  With ``with_lse`` the
    kernel also writes each row's log-sum-exp (b, h, sq), the residual the
    backward needs; the inference path does not ask."""
    if use_plain(q, k, v):
        return flash_attn_fwd_plain(q, k, v, with_lse)
    code = _check_bhsd("flash_attn_fwd", q, k, v)
    b, h, sq, d = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(x) for x in (q, k, v))
        strides = [tma_strides(x) for x in (q, k, v)]
    else:
        strides = [x.stride()[:3] for x in (q, k, v)]
    o = _like_projection(b, sq, h, d, q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch("flash_attn_fwd", "v3d_flash_attn_fwd", q.device, code,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq,
           k.shape[2], *strides[0], *strides[1], *strides[2],
           *o.stride()[:3], None if lse is None else lse.data_ptr())
    return (o, lse) if with_lse else o


def flash_attn_bwd_plain(q, k, v, o, lse, do):
    """Plain version of K7/K8: the analytic softmax-attention gradient on
    the (b, h, s, d) layout, in f32, in the batch chunks of the forward.
    P = exp(q k^T / sqrt(d) - lse), D = rowsum(do * o),
    dS = P * (do v^T - D); dq = dS k / sqrt(d), dk = dS^T q / sqrt(d),
    dv = P^T do.  Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    parts = []
    for sl in _batch_chunks(b, h * sq * k.shape[2] * 4):
        qf, kf, vf, of, dof = (x[sl].float() for x in (q, k, v, o, do))
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                      - lse[sl, ..., None])
        dsum = (dof * of).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - dsum)
        parts.append((torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale,
                      torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale,
                      torch.einsum("bhqk,bhqd->bhkd", p, dof)))
    return tuple(_cat([pt[i] for pt in parts]).to(q.dtype) for i in range(3))


def flash_attn_bwd(q, k, v, o, lse, do):
    """Gradients (dq, dk, dv) of ``flash_attn_fwd`` given the output ``o``,
    its log-sum-exp ``lse`` and the incoming gradient ``do``, all (b, h, s,
    64) with unit stride on d.  K8 (dq, and each row's D = rowsum(do * o)
    and lse in a scratch) runs first, then K7 (dk, dv); an operand whose
    base or strides are not 16-byte multiples is copied to an aligned
    buffer first (``tma_operand``).  The gradients are (b, h, s, d) views of
    (b, s, h, d) buffers, like q/k/v.  The kernels take bf16 only."""
    if use_plain(q, k, v, o, do):
        return flash_attn_bwd_plain(q, k, v, o, lse, do)
    _check_bhsd("flash_attn_bwd", q, k, v)
    if q.dtype != torch.bfloat16 or o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_attn_bwd: the kernels take bfloat16 q/k/v/o/do, "
                        f"got {q.dtype} {o.dtype} {do.dtype}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.stride(-1) != 1
            or do.stride(-1) != 1):
        raise ValueError(f"flash_attn_bwd: o/do must be unit-stride {q.shape}, "
                         f"got {o.shape} {o.stride()} {do.shape} {do.stride()}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attn_bwd: lse must be contiguous float32 "
                         f"{(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do = (tma_operand(x) for x in (q, k, v, o, do))
    dq, dk, dv = (_like_projection(b, s, h, d, q) for s in (sq, sk, sk))
    stats = bwd_stats_scratch(b, h, sq, q.device)
    _bwd_dq(q, k, v, o, lse, do, stats, dq)
    _bwd_dkv(q, k, v, do, stats, dk, dv)
    return dq, dk, dv


def bwd_stats_scratch(b: int, h: int, sq: int, device) -> torch.Tensor:
    """K8's row statistics for K7 (``flash_bwd_plan``'s ``stats``)."""
    return torch.empty((b * h, 2, stats_pitch(sq)), dtype=torch.float32,
                       device=device)


def _strides(*tensors):
    """(b, h, s) element strides of each tensor, as tensor maps read them
    (``tma_strides``; the caller made each operand readable)."""
    return (ctypes.c_longlong * (3 * len(tensors)))(*[
        x for t in tensors for x in (tma_strides(t) or t.stride()[:3])])


def _bwd_dq(q, k, v, o, lse, do, stats, dq, prof=None) -> None:
    """K8: dq, and each row's lse * log2 e and D = rowsum(do * o) into
    ``stats`` for K7 (operands checked and aligned by the caller).
    ``prof``: None, or an int64 CUDA tensor of BWD_PROF_SLOTS a block for
    the clock64 phases."""
    b, h, sq, _ = q.shape
    launch("flash_attn_bwd_dq", "v3d_flash_attn_bwd_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), b, h,
           sq, k.shape[2], _strides(q, k, v, o, do, dq),
           None if prof is None else prof.data_ptr())


def _bwd_dkv(q, k, v, do, stats, dk, dv, prof=None) -> None:
    """K7: dk and dv, reading K8's ``stats`` (as ``_bwd_dq``)."""
    b, h, sq, _ = q.shape
    launch("flash_attn_bwd_dkv", "v3d_flash_attn_bwd_dkv", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           stats.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq,
           k.shape[2], _strides(q, k, v, do, dk, dv),
           None if prof is None else prof.data_ptr())


class _FlashAttention(torch.autograd.Function):
    """K1 forward with its log-sum-exp; backward K8 + K7 (plain versions for
    CPU tensors or in reference_mode)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attn_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attn_bwd(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """``flash_attn_fwd`` with a gradient: under autograd the forward also
    keeps its log-sum-exp and the backward runs K8/K7; otherwise it is the
    inference forward alone."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    return flash_attn_fwd(q, k, v)


# -- the backend dispatcher (attention.py:23-219) ------------------------------

BACKENDS = ("auto", "xla", "flash", "flash_jax", "packed")
_DEFAULT_BACKEND = "auto"
# routes the >= 1024-token self-attention levels (None: the measured picks)
_SPATIAL_OVERRIDE: Optional[str] = None


def set_default_backend(name: str) -> None:
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}, not in {BACKENDS}")
    _DEFAULT_BACKEND = name


def set_spatial_override(name: Optional[str]) -> None:
    """Route the >= 1024-token self-attention levels to ``name`` (None: the
    measured picks)."""
    global _SPATIAL_OVERRIDE
    if name not in (None, "packed", "flash", "flash_jax"):
        raise ValueError(f"unknown spatial override {name!r}")
    _SPATIAL_OVERRIDE = name


def flash_blocks(dtype: torch.dtype, sq: int, sk: int) -> Tuple[int, int]:
    """The TPU block sizes the "flash" and "packed" routes pass on
    (attention.py:54-59, :75-83): (512, 1024) for bf16, (256, 512)
    otherwise, halved (not below 128) until they divide the sequence.  On the
    card they only decide flash_attention's fallback."""
    bq, bk = (512, 1024) if dtype == torch.bfloat16 else (256, 512)
    while bq > 128 and sq % bq != 0:
        bq //= 2
    while bk > 128 and sk % bk != 0:
        bk //= 2
    return bq, bk


def _pick_backend_dims(sq: int, sk: int, d: int, on_card: bool) -> str:
    """The auto pick for the (b, s, h, d) layout (attention.py:88-105)."""
    if not (on_card and d == 64 and sq == sk):
        return "xla"
    if _SPATIAL_OVERRIDE and sq >= 1024:
        return _SPATIAL_OVERRIDE
    if sq >= 2048 and sq % 512 == 0:
        return "flash"
    if sq == 1024:
        return "flash_jax"
    return "xla"


def _pick_backend_bhsd(sq: int, sk: int, d: int, on_card: bool) -> str:
    """The auto pick for the (b, h, s, d) layout (attention.py:122-139)."""
    if not (on_card and d == 64 and sq == sk):
        return "xla"
    if _SPATIAL_OVERRIDE and sq >= 1024:
        return _SPATIAL_OVERRIDE
    if sq >= 1024 and sq % 512 == 0:
        return "flash_jax"
    return "xla"


def attention_route(sq: int, sk: int, d: int, dtype: torch.dtype,
                    on_card: bool, backend: Optional[str] = None) -> str:
    """The route ``attention`` takes: "xla", "flash", "flash_jax" or
    "packed".  A "flash" call whose blocks do not tile the sequence, or
    whose d flash_attention does not take, is "xla" (its fallback)."""
    from v3d_tpu_torch.ops.flash_attention import flash_tiles

    backend = backend or _DEFAULT_BACKEND
    if backend == "auto":
        backend = _pick_backend_dims(sq, sk, d, on_card)
    if backend == "flash" and not flash_tiles(sq, sk, d,
                                              *flash_blocks(dtype, sq, sk)):
        return "xla"
    return backend


def attention_bhsd_route(sq: int, sk: int, d: int, on_card: bool,
                         backend: Optional[str] = None) -> str:
    """The route ``attention_bhsd`` takes: "xla", "flash", "flash_jax" or
    "packed" (the last two run the same kernel there)."""
    backend = backend or _DEFAULT_BACKEND
    if backend in ("auto", "packed"):
        backend = _pick_backend_bhsd(sq, sk, d, on_card)
    return backend


def route_kernel(route: str, d: int) -> Optional[str]:
    """The ``LAUNCHES`` key of the kernel a route launches at head width d
    (on the card), or None for the plain formula."""
    if route == "xla":
        return None
    return "flash_attn_fwd" if d == 64 else "flash_attn_fwd_wide"


def _on_card(*tensors: torch.Tensor) -> bool:
    """The JAX pickers' "on TPU": CUDA tensors outside reference_mode()."""
    return not use_plain(*tensors)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              backend: Optional[str] = None) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, h, d) -> (b, sq, h, d), through the
    backend ``backend`` (default: the one ``set_default_backend`` chose)."""
    from v3d_tpu_torch.ops import flash_attention as fa

    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    route = attention_route(sq, sk, d, q.dtype, _on_card(q, k, v), backend)
    if route == "packed":
        return fa.flash_attention_packed(q, k, v, *flash_blocks(q.dtype, sq, sk))
    if route == "flash_jax":
        return jax_flash_attention(q, k, v)
    if route == "flash":
        return fa.flash_attention(q, k, v, *flash_blocks(q.dtype, sq, sk))
    return xla_attention(q, k, v)


def attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Attention on the (b, h, s, d) layout (attention.py:142-186): "flash_jax"
    is K1 with its K7/K8 backward, "flash"/"packed" T2's route (the kernel,
    the backward recomputed), "xla" the plain formula."""
    from v3d_tpu_torch.ops import flash_attention as fa

    d = q.shape[3]
    route = attention_bhsd_route(q.shape[2], k.shape[2], d,
                                 _on_card(q, k, v), backend)
    if route == "flash_jax" and d == 64:
        return flash_attention(q, k, v)
    if route in ("flash_jax", "flash", "packed"):
        return fa.flash_bh(q, k, v)
    return flash_attn_fwd_plain(q, k, v)


def jax_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """The stock kernel's route on (b, s, h, d) (attention.py:189-210): K1
    (and K7/K8 under autograd) on (b, h, s, d) views, so its transposes are
    free.  At d != 64, T2's route."""
    from v3d_tpu_torch.ops import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_attention(qt, kt, vt) if q.shape[3] == 64 else fa.flash_bh(qt, kt, vt)
    return out.transpose(1, 2)


xla_attention = attention_plain
