"""The frame-parallel VideoUNet forward over "data": a batch's (b t) frames
spread over the ranks (counterpart of the all-to-alls that XLA places where
v3d_tpu/parallel/mesh.py:7-10 shards the CFG-doubled orbit over the data
axis).

Each rank holds a contiguous block of the batch's rows (``shard_block``'s;
the ranks must divide them, and a block may straddle two videos).  Spatial
layers work on a rank's rows alone.  A temporal sub-block needs every frame
of a pixel: ``frames_to_pixels`` turns this rank's rows of ((b t), s, c)
tokens into every row of this rank's strip of pixels, ((b t), s_r, c)
(``pixel_strips``), and ``pixels_to_frames`` turns them back.  The temporal
GroupNorms normalise over whole videos, so their statistics span the
strips: each rank sums its strip, ``all_reduce_sum`` adds the sums, and
each rank normalises with the global ones
(``ops.group_norm.group_norm_act_split``, K6's split entries on the card).

Every exchange is an autograd Function whose backward is the inverse
exchange (an all_reduce's is an all_reduce of the cotangent, an
all_gather's an all_reduce and this rank's block), so the parameter
gradients summed over the ranks are one process's.  Every rank issues the
same collectives in the same order: a forward, and a layer that activation
checkpointing recomputes (the whole layer: ``VideoUNet`` turns the
recompute's early stop off).

On NCCL an exchange is one ``all_to_all_single``.  Gloo (two ranks sharing
a card) takes CUDA tensors in all_reduce / broadcast / all_gather only, so
there it is an all_gather and a slice.  The group's backend decides
(``EXCHANGE``); an unknown backend raises.

On the meta device (the dry run's full-size stage) an exchange, an
all_reduce or a gather moves nothing and returns its result's shape; an
exchange counts in ``TRAFFIC`` the bytes its all_to_all would receive.  CPU
and CUDA tensors always communicate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from v3d_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_index,
    axis_size,
    pixel_strips,
)

# how each backend exchanges blocks (module docstring)
EXCHANGE = {"nccl": "all_to_all", "gloo": "all_gather"}

# the frames <-> pixels exchanges of this process and the bytes they
# received (its own block included); reset with ``reset_traffic``
TRAFFIC: Dict[str, int] = {"exchanges": 0, "bytes": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """One rank's share of a frame-parallel forward: ``rows`` global (b t)
    rows of videos of ``num_frames`` frames split over ``size`` ranks of
    ``group`` (None: one rank and no collective), this rank ``index``.
    ``bind`` adds the forward's gathered inputs: ``emb``, every row's
    timestep embedding, and ``time_context``, each video's first-frame
    context."""

    group: Optional[object]
    size: int
    index: int
    rows: int
    num_frames: int
    mode: str
    emb: Optional[torch.Tensor] = None
    time_context: Optional[torch.Tensor] = None

    @property
    def block(self) -> slice:
        per = self.rows // self.size
        return slice(self.index * per, (self.index + 1) * per)

    @property
    def videos(self) -> int:
        return self.rows // self.num_frames

    def frame_index(self, device) -> torch.Tensor:
        """The global frame index (0 .. t-1) of each of this rank's rows."""
        b = self.block
        return torch.arange(b.start, b.stop, device=device) % self.num_frames

    def local(self, per_frame: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (b, t) per-frame tensor, as ((b t)_r,)."""
        return per_frame.reshape(-1)[self.block]

    def bind(self, emb: torch.Tensor, context: Optional[torch.Tensor]) -> "FrameShard":
        """This shard with every row's ``emb`` and each video's first-frame
        ``context`` (this rank's rows of both given), gathered: one
        all_gather each."""
        ctx = None if context is None else gather_rows(context, self)[::self.num_frames]
        return dataclasses.replace(self, emb=gather_rows(emb, self), time_context=ctx)

    def split_norm(self, pixels: int) -> Tuple[int, Callable]:
        """``(rows, reduce)`` of ``group_norm_act_split`` for a GroupNorm over
        (t, pixels) of each video whose strips lie on the ranks."""
        return self.num_frames * pixels, lambda sums: all_reduce_sum(sums, self)


def frame_shard(mesh, rows: int, num_frames: int) -> FrameShard:
    """The FrameShard of this rank for a batch of ``rows`` (b t) rows of
    videos of ``num_frames`` frames over "data" of ``mesh``; raises where the
    ranks do not divide the rows, or the rows are not whole videos."""
    size, index = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    if rows % num_frames:
        raise ValueError(f"{rows} rows are not whole videos of {num_frames} frames")
    if rows % size:
        raise ValueError(f"{rows} frames (b t) do not split over {DATA_AXIS}={size}: "
                         f"the ranks must divide them")
    group = axis_group(mesh, DATA_AXIS)
    mode = "none"
    if group is not None:
        backend = str(dist.get_backend(group))
        if backend not in EXCHANGE:
            raise ValueError(f"frame-parallel forward: no exchange for backend {backend!r}")
        mode = EXCHANGE[backend]
    return FrameShard(group, size, index, rows, num_frames, mode)


def _count(*received: torch.Tensor) -> None:
    """One exchange that received ``received``."""
    TRAFFIC["exchanges"] += 1
    TRAFFIC["bytes"] += sum(t.numel() * t.element_size() for t in received)


def _gather(x: torch.Tensor, fs: FrameShard) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(fs.size)]
    if x.device.type != "meta":
        dist.all_gather(parts, x.contiguous(), group=fs.group)
    return parts


def _all_reduce(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    y = x.contiguous().clone()
    if y.device.type != "meta":
        dist.all_reduce(y, group=fs.group)
    return y


def _to_pixels(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    """(R, s, c) rows of this rank -> (rows, s_r, c), every row of its strip."""
    strips = pixel_strips(x.shape[1], fs.size)
    a, b = strips[fs.index]
    if x.device.type == "meta":
        out = x.new_empty((fs.rows, b - a, x.shape[2]))
        _count(out)
        return out
    if fs.mode == "all_gather":
        full = torch.cat(_gather(x, fs))
        _count(full)
        return full[:, a:b].contiguous()
    R, c = x.shape[0], x.shape[2]
    send = torch.cat([x[:, i:j].reshape(-1) for i, j in strips])
    out = torch.empty(fs.size * R * (b - a) * c, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, send, [R * (b - a) * c] * fs.size,
                           [R * (j - i) * c for i, j in strips], group=fs.group)
    _count(out)
    return out.view(fs.size * R, b - a, c)


def _to_frames(x: torch.Tensor, s: int, fs: FrameShard) -> torch.Tensor:
    """(rows, s_r, c) of this rank's strip -> (R, s, c), every pixel of its
    rows."""
    strips = pixel_strips(s, fs.size)
    R, c = fs.rows // fs.size, x.shape[2]
    blk = fs.block
    if x.device.type == "meta":
        out = x.new_empty((R, s, c))
        _count(out)
        return out
    if fs.mode == "all_gather":
        widest = max(j - i for i, j in strips)
        padded = torch.nn.functional.pad(x, (0, 0, 0, widest - x.shape[1]))
        parts = _gather(padded, fs)
        _count(*parts)
        return torch.cat([p[blk, :j - i] for p, (i, j) in zip(parts, strips)], dim=1)
    out = torch.empty(R * s * c, dtype=x.dtype, device=x.device)
    sizes = [R * (j - i) * c for i, j in strips]
    dist.all_to_all_single(out, x.contiguous().view(-1), sizes,
                           [R * x.shape[1] * c] * fs.size, group=fs.group)
    _count(out)
    return torch.cat([p.view(R, j - i, c) for p, (i, j) in zip(out.split(sizes), strips)],
                     dim=1)


class _FramesToPixels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fs):
        ctx.fs, ctx.s = fs, x.shape[1]
        return _to_pixels(x, fs)

    @staticmethod
    def backward(ctx, grad):
        return _to_frames(grad, ctx.s, ctx.fs), None


class _PixelsToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, fs):
        ctx.fs = fs
        return _to_frames(x, s, fs)

    @staticmethod
    def backward(ctx, grad):
        return _to_pixels(grad, ctx.fs), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fs):
        ctx.fs = fs
        return _all_reduce(x, fs)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.fs), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fs):
        ctx.fs, ctx.n = fs, x.shape[0]
        return torch.cat(_gather(x, fs))

    @staticmethod
    def backward(ctx, grad):
        g = _all_reduce(grad, ctx.fs)
        i = ctx.fs.index * ctx.n
        return g[i:i + ctx.n], None


def frames_to_pixels(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    """(R, s, c) tokens of this rank's R rows -> (rows, s_r, c): every row of
    the batch at this rank's strip of the s pixels."""
    return x if fs.group is None else _FramesToPixels.apply(x, fs)


def pixels_to_frames(x: torch.Tensor, s: int, fs: FrameShard) -> torch.Tensor:
    """The inverse of ``frames_to_pixels``: (rows, s_r, c) -> (R, s, c)."""
    return x if fs.group is None else _PixelsToFrames.apply(x, s, fs)


def all_reduce_sum(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    """The sum of x over the ranks, differentiable."""
    return x if fs.group is None else _AllReduceSum.apply(x, fs)


def gather_rows(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    """Every rank's x (n, ...), the same shape on each, in rank order:
    (ranks * n, ...), differentiable."""
    return x if fs.group is None else _GatherRows.apply(x, fs)
