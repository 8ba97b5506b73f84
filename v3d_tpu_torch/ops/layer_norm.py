"""LayerNorm over the last dim in float32, output in x's dtype: kernel K10
and the plain formula.

``LayerNormF32`` (models/layers.py) computed ``F.layer_norm`` on an f32
copy of x and cast back: on a bf16 activation five launches that move 20
bytes an element.  K10 (csrc/layer_norm.cu) is one pass: each row read
once into registers, f32 statistics (the mean, then the sum of squared
deviations), weight and bias applied in f32, the row rounded once and
written once.  It replaces no TPU kernel; the JAX package leaves
LayerNorm to XLA's fusion.  An affine-free LayerNorm (FLUX.1's: weight
and bias None) runs the same launch on a unit weight and a zero bias.  It
has no backward: ``layer_norm_route`` sends a call that wants a gradient
to the plain formula, whose autograd is PyTorch's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from v3d_tpu_torch.ops._dispatch import DTYPE_CODES, launch, use_plain

LN_MAX_C = 4096            # the generic instance's slots: 32 lanes x 128 elements
LN_THREADS = 256
LN_WARPS = LN_THREADS // 32
# widths compiled with the row length fixed (csrc/layer_norm.cu dispatch):
# the UNets' 320 / 640 / 1280, CLIP ViT-H's 1280, ViT-L's 1024
LN_FIXED_WIDTHS = (320, 640, 1024, 1280)


def layer_norm_route(on_card: bool, wants_grad: bool) -> str:
    """Where a ``LayerNormF32`` call runs: "k10" for a card tensor when no
    gradient is wanted (sampling, conditioning: ``torch.no_grad()``, or
    frozen weights on a constant input), else "plain", the f32 formula
    under PyTorch's autograd (training, and every CPU call)."""
    return "k10" if on_card and not wants_grad else "plain"


def layer_norm_f32_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K10: LayerNormF32's formula, an f32 LayerNorm over
    the last dim of x's f32 copy, cast back to x.dtype; no affine where
    weight and bias are None."""
    if weight is None:
        return F.layer_norm(x.float(), x.shape[-1:], None, None, eps).to(x.dtype)
    return F.layer_norm(x.float(), weight.shape, weight.float(), bias.float(),
                        eps).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _unit_affine(C: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's parameters of an affine-free LayerNorm: f32 ones and zeros."""
    return (torch.ones(C, dtype=torch.float32, device=device),
            torch.zeros(C, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def layer_norm_plan(rows: int, C: int, dtype=torch.bfloat16, vec_ok: bool = True) -> dict:
    """How K10 runs ``rows`` rows of C.

    ``path`` "fixed" where C is one of ``LN_FIXED_WIDTHS`` and 16-byte
    loads may read x (``vec_ok``): ``lanes`` threads a row, the largest
    power of two <= 32 that divides the row's 16-byte packs, each lane
    ``slots`` of them (bf16: 4-5, f32: 5-10).  "generic" otherwise (C <=
    ``LN_MAX_C``): a warp a row, packs of 16 bytes where ``vec_ok`` and C
    allow, else of one element.  ``vec``: elements a pack.  Each warp
    takes ``rows_per_task`` = 32 / lanes consecutive rows, a block of 256
    threads ``rows_per_block``; ``grid``: as many blocks as that takes
    (the card's block scheduler keeps every SM at its residency;
    csrc/layer_norm.cu says why not a grid of resident blocks).  ``smem``:
    weight and bias in f32."""
    if not 1 <= C <= LN_MAX_C:
        raise ValueError(f"layer_norm: C must lie in 1..{LN_MAX_C}, got {C}")
    if rows < 1:
        raise ValueError(f"layer_norm: needs a row, got {rows}")
    elem = 4 if dtype == torch.float32 else 2
    pack = 16 // elem
    vec = pack if vec_ok and C % pack == 0 else 1
    if vec == pack and C in LN_FIXED_WIDTHS:
        packs = C // pack
        lanes = 32
        while packs % lanes:
            lanes //= 2
        path = "fixed"
    else:
        lanes, path = 32, "generic"
    per_task = 32 // lanes
    per_block = LN_WARPS * per_task
    return dict(path=path, lanes=lanes, vec=vec, slots=-(-C // (lanes * vec)),
                threads=LN_THREADS, rows_per_task=per_task, rows_per_block=per_block,
                grid=(-(-rows // per_block),), smem=2 * C * 4)


def layer_norm_rows(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(rows, C, ld) where x reads as rows of C unit-stride elements, row r
    at r * ld (its leading dims collapse to one stride, ld >= C); else
    None.  A dim of size 1 is never stepped, so its stride does not count."""
    return _rows(x.shape, x.stride())


@functools.lru_cache(maxsize=1024)
def _rows(shape: Tuple[int, ...], stride: Tuple[int, ...]):
    """``layer_norm_rows`` of a (shape, stride), cached: a forward's calls
    repeat a few dozen layouts, and the host paces the sampling loop."""
    if not shape:
        return None
    C = shape[-1]
    if C > 1 and stride[-1] != 1:
        return None
    ld = expect = None
    for d in range(len(shape) - 2, -1, -1):
        if shape[d] == 1:
            continue
        if ld is None:
            ld = expect = stride[d]
        elif stride[d] != expect:
            return None
        expect *= shape[d]
    ld = C if ld is None else ld
    if ld < C:
        return None
    return math.prod(shape) // C if C else 0, C, ld


def layer_norm_f32(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over x's last dim with f32 statistics and affine (none
    where weight and bias are None), output in x.dtype, contiguous.  On a
    CUDA tensor K10, counted in ``LAUNCHES["layer_norm"]``; it raises on
    what K10 does not take (C above ``LN_MAX_C``, a non-unit stride on C,
    leading dims that do not collapse to one row stride) rather than fall
    back.  No gradient."""
    if weight is None and bias is None:
        if use_plain(x):
            return layer_norm_f32_plain(x, None, None, eps)
        weight, bias = _unit_affine(x.shape[-1], x.device)
    if use_plain(x, weight, bias):
        return layer_norm_f32_plain(x, weight, bias, eps)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"layer_norm: needs float32 or bfloat16 x, got {x.dtype}")
    layout = layer_norm_rows(x)
    if layout is None:
        raise ValueError(f"layer_norm: x {tuple(x.shape)} strides {x.stride()} is not "
                         f"rows of unit stride on C at one row stride")
    rows, C, ld = layout
    if C > LN_MAX_C:
        raise ValueError(f"layer_norm: C {C} is above K10's {LN_MAX_C}")
    pdt = DTYPE_CODES.get(weight.dtype)
    if (pdt is None or bias.dtype != weight.dtype or weight.shape != (C,)
            or bias.shape != (C,) or not weight.is_contiguous()
            or not bias.is_contiguous()):
        raise TypeError(f"layer_norm: weight/bias must be contiguous ({C},) float32 "
                        f"or bfloat16, got {weight.dtype} {tuple(weight.shape)} "
                        f"{bias.dtype} {tuple(bias.shape)}")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    size = x.element_size()
    vec_ok = x.data_ptr() % 16 == 0 and (rows == 1 or ld * size % 16 == 0)
    plan = layer_norm_plan(rows, C, x.dtype, vec_ok)
    launch("layer_norm", "v3d_layer_norm", x.device, DTYPE_CODES[x.dtype], pdt,
           x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows, C, ld,
           float(eps), plan["lanes"], plan["vec"], int(plan["path"] == "fixed"),
           plan["grid"][0])
    return y
