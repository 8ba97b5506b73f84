"""GroupNorm(32) + optional SiLU in float32: kernel K6 and the plain formula.

Counterpart of v3d_tpu/ops/fused_groupnorm.py.  ``group_norm_act`` is the
port of ``group_norm_act`` (fused_groupnorm.py:176-222): the forward is K6
(csrc/group_norm.cu, the port of the two-pass ``_pallas_group_norm``,
:90-138; one launch where a slice of whole groups fits in a thread-block
cluster's shared memory, else two, as ``group_norm_plan`` says) and the
backward recomputes through the plain formula, as
``_gn_bwd`` (:214-219) does; the JAX package has no backward kernel here.

``group_norm_act_split`` is the GroupNorm of samples whose rows lie on
several ranks (the frame-parallel UNet's temporal GroupNorms,
parallel/frames.py): K6's statistics entry sums this rank's rows
(``group_norm_stats``), the caller's ``reduce`` adds the sums over the
ranks, and K6's apply entry normalises with them (``group_norm_apply``):
T9's two pallas_calls (:100, :126) with the collective between them.

Tensors are NCHW / NCTHW in ``channels_last`` / ``channels_last_3d`` memory,
so the kernel reads them as (B, L, C) with channels fastest, as the Pallas
kernel's (B, L, C) blocks.  Scale and bias may be float32 or bfloat16.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch

from v3d_tpu_torch.ops._dispatch import (
    DTYPE_CODES,
    launch,
    needs_grad,
    plain_vjp,
    use_plain,
)

_MAX_CHANNELS = 4096

# K6's launch plan (csrc/group_norm.cu), mirrored here so that the CPU tests
# and chip_smoke.py can read it: 256 threads a block; a one-launch block
# takes <= 100 KB of shared memory (two blocks an SM: with one, nothing
# overlaps a block's load with its store); clusters of <= 8 blocks (the
# portable size), or 16 where no slicing fits 8, and blocks of up to the
# card's 227 KB (one an SM) where no slicing fits 100 KB; the two-launch
# path runs at most 4 blocks an SM (its kernels' registers allow 4 of 256
# threads), all in one wave.  Plans take the card's SM count (the H100
# SXM's 132 where no card is asked).
GN_THREADS = 256
GN_SMEM_CAP = 100 * 1024
GN_SMEM_MAX = 232448
GN_SMS = 132
GN_BLOCKS_PER_SM = 2
GN_TWO_PASS_PER_SM = 4
# a slice's rows are read as runs of W * elem contiguous bytes; below two
# 32-byte sectors the two-launch path, which reads whole rows, moves fewer
GN_MIN_ROW_BYTES = 64


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _slice_smem(W: int, gpc: int, rows: int, elem: int) -> int:
    """``slice_smem`` of csrc/group_norm.cu: rows, (row step, channel)
    partials, group sums, mean / inv."""
    vpr = W * elem // 16
    rstep = 1 if vpr >= GN_THREADS else GN_THREADS // vpr
    return _align16(rows * W * elem) + rstep * W * 2 * 4 + 4 * gpc * 4


def _slicings(B: int, L: int, C: int, G: int, elem: int, clusters,
              cap: int = GN_SMEM_CAP) -> list:
    """Every slicing of whole groups into clusters of one of ``clusters``
    sizes whose blocks fit ``cap`` bytes, rows of >= 64 bytes."""
    cpg = C // G
    cands = []
    for gpc in (d for d in range(1, G + 1) if G % d == 0):
        W = gpc * cpg
        if (W * elem) % 16 or W * elem < GN_MIN_ROW_BYTES:
            continue
        for cs in clusters:
            rows = -(-L // cs)
            if cs > 1 and rows * (cs - 1) >= L:
                continue  # a block would hold no row
            smem = _slice_smem(W, gpc, rows, elem)
            if smem <= cap:
                cands.append(dict(gpc=gpc, cluster=cs, rows_per_block=rows,
                                  smem=smem, blocks=cs * B * G // gpc,
                                  row_bytes=W * elem))
    return cands


@functools.lru_cache(maxsize=None)
def group_norm_plan(B: int, L: int, C: int, G: int, dtype=torch.bfloat16,
                    sms: int = GN_SMS) -> dict:
    """How K6 runs a (B, L, C) GroupNorm(G) call on a card of ``sms`` SMs.

    ``path`` "one_launch": slices of ``gpc`` whole groups of one sample (rows
    of W = gpc * C / G channels, W * elem a multiple of 16 bytes), each held
    by a cluster of ``cluster`` blocks of ``rows_per_block`` rows in
    ``smem`` <= 100 KB of shared memory, rows of >= 64 bytes; clusters of
    <= 8 blocks, of 16 where no slicing fits 8, and blocks of up to 227 KB
    in clusters of 16 where no slicing fits 100 KB; among the slicings that fit,
    the ones that give the most blocks up to two an SM, then the longest
    contiguous rows (up to 256 bytes), then the smallest cluster.
    "two_launch": statistics then normalisation over ``grid`` = (splits, B)
    blocks, ``smem`` for the statistics kernel.  ``launches``: CUDA kernels
    a call."""
    elem = 4 if dtype == torch.float32 else 2
    cands = (_slicings(B, L, C, G, elem, (1, 2, 4, 8))
             or _slicings(B, L, C, G, elem, (16,))
             or _slicings(B, L, C, G, elem, (16,), GN_SMEM_MAX))
    if cands:
        want = min(GN_BLOCKS_PER_SM * sms, max(c["blocks"] for c in cands))
        best = max((c for c in cands if c["blocks"] >= want),
                   key=lambda c: (min(c["row_bytes"], 256), -c["cluster"],
                                  c["row_bytes"]))
        return dict(path="one_launch", launches=1, threads=GN_THREADS,
                    grid=(best["blocks"],), splits=0,
                    **{k: best[k] for k in ("gpc", "cluster", "rows_per_block",
                                            "smem", "row_bytes")})
    return dict(path="two_launch", launches=2, **_two_launch_grid(B, L, C, elem, sms),
                gpc=G, cluster=1, row_bytes=C * elem)


def _two_launch_grid(B: int, L: int, C: int, elem: int, sms: int) -> dict:
    """threads, grid (splits, B), splits, rows_per_block and the statistics
    kernel's smem of the two-launch path, which the split entries share."""
    ncv = C * elem // 16
    rps = 1 if ncv >= GN_THREADS else GN_THREADS // ncv
    # B * splits <= the blocks resident at once: a second, partial wave of
    # blocks that each walk ~1/splits of a sample doubles the time
    splits = max(1, min(GN_TWO_PASS_PER_SM * sms // B, L))
    return dict(threads=rps * ncv, grid=(splits, B), splits=splits,
                rows_per_block=-(-L // splits), smem=2 * rps * C * 4)


@functools.lru_cache(maxsize=None)
def group_norm_split_plan(B: int, L: int, C: int, dtype=torch.bfloat16,
                          sms: int = GN_SMS) -> dict:
    """How K6's split entries run on (B, L, C): the two-launch path's grid,
    one launch each (statistics, then apply)."""
    elem = 4 if dtype == torch.float32 else 2
    return dict(path="split", launches=1, **_two_launch_grid(B, L, C, elem, sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain version of K6, line for line ``_reference``
    (fused_groupnorm.py:141-163) on the (B, C, *spatial) layout: the
    statistics, then the normalisation."""
    n = x[0, 0].numel() * (x.shape[1] // num_groups)
    return group_norm_apply_plain(x, group_norm_stats_plain(x, num_groups), scale,
                                  bias, num_groups, n, eps, silu)


def group_norm_stats_plain(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """Plain version of K6's statistics entry: (B, G, 2) float32 per-group
    (sum x, sum x^2) of x (B, C, *spatial), per channel first."""
    C = x.shape[1]
    G = num_groups
    xf = x.float()
    red = tuple(range(2, x.dim()))
    s1 = torch.sum(xf, dim=red)
    s2 = torch.sum(xf * xf, dim=red)
    B = s1.shape[0]
    g1 = torch.sum(s1.reshape(B, G, C // G), dim=-1)
    g2 = torch.sum(s2.reshape(B, G, C // G), dim=-1)
    return torch.stack([g1, g2], dim=-1)


def group_norm_apply_plain(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, num_groups: int, count: float,
                           eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain version of K6's apply entry: x normalised with the (B, G, 2)
    sums of ``count`` elements a group (+ SiLU), in x.dtype."""
    C = x.shape[1]
    G = num_groups
    xf = x.float()
    mean = sums[..., 0] / count
    var = torch.clamp(sums[..., 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = torch.repeat_interleave(mean, C // G, dim=-1)
    inv_c = torch.repeat_interleave(inv, C // G, dim=-1)
    shape = (x.shape[0], C) + (1,) * (x.dim() - 2)
    ch = (C,) + (1,) * (x.dim() - 2)
    y = ((xf - mean_c.reshape(shape))
         * (inv_c.reshape(shape) * scale.float().reshape(ch))
         + bias.float().reshape(ch))
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def channels_last_rows(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(B, L, C) when x (B, C, *spatial) lies in channels-last memory, so
    that it reads as a contiguous (B, L, C) array; else None.  A dim of size
    1 is never stepped, so its stride does not count."""
    if x.dim() < 3:
        return None
    B, C = x.shape[:2]
    L = math.prod(x.shape[2:])
    expect = C
    for d in range(x.dim() - 1, 1, -1):
        if x.shape[d] > 1 and x.stride(d) != expect:
            return None
        expect *= x.shape[d]
    if (C > 1 and x.stride(1) != 1) or (B > 1 and x.stride(0) != C * L):
        return None
    return B, L, C


def group_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5,
                   silu: bool = False,
                   prof: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(num_groups) with f32 statistics (+ SiLU in f32), output in
    x.dtype and x's channels-last memory.  On a CUDA tensor K6; it raises on
    memory that is not channels-last rather than copy.  ``prof``: an int64
    CUDA tensor of 4 per block of a one-launch plan that receives each
    block's clock64 cycles (load, statistics + cluster combine, normalise +
    store) and rows (chip_smoke.py phase 3)."""
    if use_plain(x, scale, bias):
        return group_norm_act_plain(x, scale, bias, num_groups, eps, silu)
    code, (B, L, C) = _kernel_rows(x, num_groups)
    sdt = _param_code(scale, bias, C)
    sms = _sm_count(x.device.index) if x.is_cuda else GN_SMS
    plan = group_norm_plan(B, L, C, num_groups, x.dtype, sms)
    splits = plan["splits"]
    scratch = None  # the two-launch path's partials, mean / inv and tickets
    if splits:
        scratch = torch.empty(2 * B * num_groups * (splits + 1) + B,
                              dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    launch("group_norm", "v3d_group_norm", x.device, code, x.data_ptr(),
           y.data_ptr(), scale.data_ptr(), bias.data_ptr(), sdt,
           scratch.data_ptr() if splits else None, B, L, C, num_groups,
           float(eps), int(silu), plan["gpc"], plan["cluster"],
           plan["rows_per_block"], splits,
           None if prof is None else prof.data_ptr())
    return y


def _kernel_rows(x: torch.Tensor, num_groups: int) -> Tuple[int, Tuple[int, int, int]]:
    """K6's dtype code and (B, L, C) of x; raises on what K6 does not take."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"group_norm: needs float32 or bfloat16, got {x.dtype}")
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
    return DTYPE_CODES[x.dtype], rows


def _param_code(scale: torch.Tensor, bias: torch.Tensor, C: int) -> int:
    """K6's code of the scale / bias dtype; raises on what K6 does not take."""
    sdt = {torch.float32: 0, torch.bfloat16: 1}.get(scale.dtype)
    if (sdt is None or bias.dtype != scale.dtype or scale.shape != (C,)
            or bias.shape != (C,) or not scale.is_contiguous()
            or not bias.is_contiguous()):
        raise TypeError(f"group_norm: scale/bias must be contiguous ({C},) "
                        f"float32 or bfloat16, got {scale.dtype} "
                        f"{tuple(scale.shape)} {bias.dtype} {tuple(bias.shape)}")
    return sdt


def group_norm_stats_fwd(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(B, G, 2) float32 per-group (sum x, sum x^2) of x (B, C, *spatial) in
    channels-last memory: on a CUDA tensor K6's statistics entry."""
    if use_plain(x):
        return group_norm_stats_plain(x, num_groups)
    code, (B, L, C) = _kernel_rows(x, num_groups)
    sms = _sm_count(x.device.index)
    splits = group_norm_split_plan(B, L, C, x.dtype, sms)["splits"]
    sums = torch.empty((B, num_groups, 2), dtype=torch.float32, device=x.device)
    # the partials, then the tickets (B ints, zeroed by the entry)
    scratch = torch.empty(2 * B * num_groups * splits + B, dtype=torch.float32,
                          device=x.device)
    launch("group_norm_stats", "v3d_group_norm_stats", x.device, code, x.data_ptr(),
           sums.data_ptr(), scratch.data_ptr(), B, L, C, num_groups, splits)
    return sums


def group_norm_apply_fwd(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int, count: float,
                         eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """x normalised with the (B, G, 2) float32 ``sums`` of ``count`` elements
    a group (+ SiLU), output in x.dtype and x's channels-last memory: on a
    CUDA tensor K6's apply entry."""
    if use_plain(x, sums, scale, bias):
        return group_norm_apply_plain(x, sums, scale, bias, num_groups, count, eps, silu)
    code, (B, L, C) = _kernel_rows(x, num_groups)
    sdt = _param_code(scale, bias, C)
    if (sums.dtype != torch.float32 or tuple(sums.shape) != (B, num_groups, 2)
            or not sums.is_contiguous() or not count > 0):
        raise ValueError(f"group_norm_apply: sums must be contiguous float32 "
                         f"({B}, {num_groups}, 2) and count > 0, got {sums.dtype} "
                         f"{tuple(sums.shape)}, count {count}")
    splits = group_norm_split_plan(B, L, C, x.dtype, _sm_count(x.device.index))["splits"]
    y = torch.empty_like(x)
    launch("group_norm_apply", "v3d_group_norm_apply", x.device, code, x.data_ptr(),
           y.data_ptr(), sums.data_ptr(), scale.data_ptr(), bias.data_ptr(), sdt, B, L,
           C, num_groups, float(count), float(eps), int(silu), splits)
    return y


class _GroupNormStats(torch.autograd.Function):
    """K6's statistics entry; the backward recomputes through the plain
    formula."""

    @staticmethod
    def forward(ctx, x, num_groups):
        ctx.save_for_backward(x)
        ctx.num_groups = num_groups
        return group_norm_stats_fwd(x, num_groups)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(group_norm_stats_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, ctx.num_groups)


class _GroupNormApply(torch.autograd.Function):
    """K6's apply entry; the backward recomputes through the plain formula
    (gradients of x, the sums, scale and bias)."""

    @staticmethod
    def forward(ctx, x, sums, scale, bias, num_groups, count, eps, silu):
        ctx.save_for_backward(x, sums, scale, bias)
        ctx.config = (num_groups, count, eps, silu)
        return group_norm_apply_fwd(x, sums, scale, bias, num_groups, count, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(group_norm_apply_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, *ctx.config)


def group_norm_act_split(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float, silu: bool, rows: int,
                         reduce: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """GroupNorm (+ SiLU) of samples whose ``rows`` spatial positions lie on
    several ranks, x (B, C, *spatial) this rank's share of them: this rank's
    (B, G, 2) sums, added over the ranks by ``reduce`` (differentiable, the
    same collective on every rank), then the normalisation with the global
    sums.  Differentiable; K6's two split entries on the card."""
    count = rows * (x.shape[1] // num_groups)
    if needs_grad(x, scale, bias):
        sums = reduce(_GroupNormStats.apply(x, num_groups))
        return _GroupNormApply.apply(x, sums, scale, bias, num_groups, count, eps, silu)
    sums = reduce(group_norm_stats_fwd(x, num_groups))
    return group_norm_apply_fwd(x, sums, scale, bias, num_groups, count, eps, silu)


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
