"""The 3DGS tile compositor: kernels T10 (forward) and T11 (backward), plain
version.

Counterpart of the compositors of v3d_tpu/gs: ``_composite_xla``
(render.py:174-268, the oracle) and the Pallas pair ``composite_tiles_fwd``
/ ``composite_tiles_bwd`` (pallas_raster.py:267-375) behind the custom VJP
of render.py:271-337.

Inputs, as ``gs/render.py build_slabs`` makes them:
- slab (n_cells, Kc, 10) f32, per coarse cell the depth-sorted gaussians as
  rows [mx, my, conic a, b, c, r, g, b, opacity, depth], dead entries
  (opacity 0) last;
- live_count (n_cells,) int32, the live entries of each cell;
- cell_of_tile (n_tiles,) int32 and tile_xy (n_tiles, 2) int32, the cell and
  the pixel origin of each 16x16 tile.

Outputs: rgb (n_tiles, 256, 3), acc and depth (n_tiles, 256), raw (the
background is blended by the caller from acc).  Per pixel, front to back,
gaussian i has alpha_i = min(0.99, op exp(power)) where power <= 0 and that
is >= 1/255 (else 0), and weight w_i = alpha_i T_i while T_i =
prod_{j<i}(1 - alpha_j) >= 1e-4 (else 0).

- ``composite_plain``: the plain version, the math of ``_composite_xla``
  (depth chunks with a carried transmittance, tiles in chunks under
  ``torch.utils.checkpoint``); autograd gives its gradient.
- ``composite_checkpoints_plain``: the plain version of T10's other
  outputs, the checkpoints T11 reads (ts, last, k_stop).
- ``composite_fwd`` / ``composite_bwd``: the launch wrappers of T10 / T11
  (csrc/gs_composite_fwd.cu, csrc/gs_composite_bwd.cu).
- ``tile_reach``: the plain version of the per-tile cull of T11
  (csrc/gs_composite.cuh ``tile_reach``): which gaussians can pass the
  alpha test at some pixel of a tile; ``reach_boxes`` / ``pixel_boxes_meet``:
  the same boxes in whole pixels, T10's table and its test on a band of a
  tile.
- ``GSComposite``: the autograd Function that ties them; its forward saves
  the slab and T10's checkpoints (ts, each pixel's last composited gaussian,
  k_stop), its backward launches T11.
- ``composite``: the dispatcher the renderer calls.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from v3d_tpu_torch.ops._dispatch import launch, use_plain

TILE = 16
P = TILE * TILE
CHUNK = 128          # gaussians per T10 batch = per checkpoint row of ts
ATTR = 10
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
# the cull's margins (csrc/gs_composite.cuh): the relative float error of
# the alpha test's power per unit of conic condition, and the test's own
# rounding in log units
REACH_EPS = 1e-6
REACH_DELTA = 1e-5
FWD_SPLIT = 4       # T10's blocks a tile, each over a band of 16 / FWD_SPLIT pixel rows
FWD_PROF_SLOTS = 6  # T10's clock64 phases and counts a tile (``composite_fwd``)
BWD_PROF_SLOTS = 6  # T11's clock64 phases and counts a block (``composite_bwd``)


def tile_pixels(tile_xy: torch.Tensor) -> torch.Tensor:
    """(n, 2) int tile origins -> (n, 256, 2) float pixel coordinates (x, y),
    pixel p = 16 * y + x within the tile."""
    py, px = torch.meshgrid(torch.arange(TILE), torch.arange(TILE),
                            indexing="ij")
    offs = torch.stack([px.reshape(-1), py.reshape(-1)], -1).to(tile_xy.device)
    return (tile_xy[:, None, :] + offs[None]).float()


def _composite_tiles(slab: torch.Tensor, pix: torch.Tensor, depth_chunk: int):
    """slab (C or 1, K, 10), pix (C, P, 2) -> rgb (C, P, 3), acc, dep (C, P)."""
    C = pix.shape[0]
    T = pix.new_ones(C, P)
    rgb = pix.new_zeros(C, P, 3)
    acc = pix.new_zeros(C, P)
    dep = pix.new_zeros(C, P)
    for k0 in range(0, slab.shape[1], depth_chunk):
        ch = slab[:, k0:k0 + depth_chunk]
        d = pix[:, :, None, :] - ch[:, None, :, 0:2]          # (C, P, D, 2)
        dx, dy = d[..., 0], d[..., 1]
        con = ch[:, None, :, 2:5]
        # the same products and sums, in the same order, as T10's pair_alpha
        power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
                 - con[..., 1] * dx * dy)
        alpha = torch.clamp(ch[:, None, :, 8] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        t_local = torch.cumprod(1.0 - alpha, dim=-1)
        t_excl = T[..., None] * torch.cat(
            [torch.ones_like(t_local[..., :1]), t_local[..., :-1]], dim=-1)
        w = alpha * t_excl * (t_excl >= T_EPS)                # (C, P, D)
        rgb = rgb + (w[..., None] * ch[:, None, :, 5:8]).sum(2)
        acc = acc + w.sum(-1)
        dep = dep + (w * ch[:, None, :, 9]).sum(-1)
        T = T * t_local[..., -1]
    return rgb, acc, dep


def _reach_box(slab: torch.Tensor, exact: bool = False):
    """The cull's box of each slab row (csrc/gs_composite.cuh reach_box), in
    float64: (none, every, hx, hy): ``none`` where the row reaches no pixel
    (op < 1/255; dead slots have op 0), ``every`` where it is admitted
    whatever the pixels (a conic that is not positive definite, rho >= 1/2
    or a non-finite entry), else it can pass the alpha test only within mx
    +- hx, my +- hy: the box of the ellipse a dx^2 + 2 b dx dy + c dy^2 <= 2
    L, L = ln(255 op), |dx| <= sqrt(2 L c / det), |dy| <= sqrt(2 L a / det),
    det = ac - b^2, conservative against the float rounding of the test (as
    T11's cull, in float64): 2 (L + REACH_DELTA) / (1 - rho) in place of 2
    L, rho = REACH_EPS (|a| + |b| + |c|) / lambda_min, and a pixel of
    padding.  ``exact``: the box of 2 L itself, unpadded (the work the
    inputs need, chip_smoke.py's bound)."""
    g = slab.double()
    a, b, c = (g[..., i] for i in range(2, 5))
    det = a * c - b * b
    if exact:
        rho, delta, pad = torch.zeros_like(det), 0.0, 0.0
    else:
        lmax = 0.5 * (a + c) + torch.sqrt(0.25 * (a - c) ** 2 + b * b)
        rho = REACH_EPS * (a.abs() + b.abs() + c.abs()) * lmax / det
        delta, pad = REACH_DELTA, 1.0
    r = 2.0 * (torch.log(255.0 * g[..., 8]).clamp(min=0.0) + delta) / (1.0 - rho)
    hx = torch.sqrt(r * c / det) + pad
    hy = torch.sqrt(r * a / det) + pad
    none = slab[..., 8] < ALPHA_MIN
    every = ~none & (~torch.isfinite(g[..., [0, 1, 2, 3, 4, 8]]).all(-1)
                     | ~((det > 0) & (a > 0)) | (rho >= 0.5))
    return none, every, hx, hy


def tile_reach(slab: torch.Tensor, tile_xy: torch.Tensor,
               exact: bool = False) -> torch.Tensor:
    """bool (n_tiles, K): whether gaussian k of each tile's cell rows can
    pass the alpha test (alpha >= 1/255) at some pixel of the tile.  slab
    (n_tiles or 1, K, 10), the rows each tile sees; tile_xy (n_tiles, 2).
    False where the box of ``_reach_box`` misses the tile's pixels (or the
    row reaches none), true where it meets them or the row is admitted
    everywhere."""
    none, every, hx, hy = _reach_box(slab, exact)
    mx, my = slab[..., 0].double(), slab[..., 1].double()
    x0 = tile_xy[:, 0, None].double()
    y0 = tile_xy[:, 1, None].double()
    hit = ((mx + hx >= x0) & (mx - hx <= x0 + TILE - 1)
           & (my + hy >= y0) & (my - hy <= y0 + TILE - 1))
    return ~none & (every | hit)


def reach_boxes(slab: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """int16 (..., K, 4): T10's table of the cull's boxes in whole pixels
    (csrc/gs_composite.cuh reach_pixel_box), per slab row (x_lo, x_hi,
    y_lo, y_hi) = (ceil(mx - hx), floor(mx + hx), ceil(my - hy), floor(my +
    hy)) clamped to int16; an empty box where the row reaches no pixel, all
    of int16 where it is admitted everywhere.  A block of pixels x0..x1,
    y0..y1 (integers in [0, 32752]) meets it (``pixel_boxes_meet``) exactly
    where it meets the box of ``tile_reach``: on a whole tile the two tests
    agree."""
    none, every, hx, hy = _reach_box(slab, exact)
    mx, my = slab[..., 0].double(), slab[..., 1].double()
    box = torch.stack([torch.ceil(mx - hx), torch.floor(mx + hx),
                       torch.ceil(my - hy), torch.floor(my + hy)], -1)
    box = box.clamp(-32768.0, 32767.0)
    box = torch.where(every[..., None], box.new_tensor([-32768.0, 32767.0] * 2), box)
    box = torch.where(none[..., None], box.new_tensor([32767.0, -32768.0] * 2), box)
    return box.to(torch.int16)


def pixel_boxes_meet(boxes: torch.Tensor, x0, x1, y0, y1) -> torch.Tensor:
    """Whether each box of ``reach_boxes`` meets the pixels x0..x1, y0..y1
    (ints or tensors broadcast against boxes[..., 0])."""
    b = boxes.int()
    return (b[..., 1] >= x0) & (b[..., 0] <= x1) & (b[..., 3] >= y0) & (b[..., 2] <= y1)


def composite_plain(slab: torch.Tensor, live_count: torch.Tensor,
                    cell_of_tile: torch.Tensor, tile_xy: torch.Tensor,
                    depth_chunk: int = 256, tile_chunk: int = 32):
    """Plain version of T10 (its autograd is T11's): every slab entry is
    composited (``live_count`` is not needed: dead entries have alpha 0).
    ``tile_chunk`` tiles at a time, each chunk under ``checkpoint`` when a
    gradient is wanted, so the backward keeps one chunk's (C, 256, D)
    intermediates at a time."""
    del live_count
    pix_all = tile_pixels(tile_xy)
    shared = slab.shape[0] == 1
    want_grad = torch.is_grad_enabled() and slab.requires_grad
    outs = []
    for t0 in range(0, pix_all.shape[0], tile_chunk):
        pix = pix_all[t0:t0 + tile_chunk]
        cells = slab if shared else slab[cell_of_tile[t0:t0 + tile_chunk].long()]
        if want_grad:
            outs.append(checkpoint(_composite_tiles, cells, pix, depth_chunk,
                                   use_reentrant=False))
        else:
            outs.append(_composite_tiles(cells, pix, depth_chunk))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def composite_checkpoints_plain(slab: torch.Tensor, live_count: torch.Tensor,
                                cell_of_tile: torch.Tensor, tile_xy: torch.Tensor):
    """Plain version of T10's checkpoints, the second result of
    ``composite_fwd``: ts (n_tiles, n_chunks + 1, 256) f32, last (n_tiles,
    256) int32, k_stop (n_tiles,) int32.

    Per pixel, front to back in slab order, T *= 1 - alpha at each gaussian
    that passes the alpha test while T >= 1e-4 (alpha rounded as T10's
    pair_alpha; the product in float32, one gaussian at a time, as T10
    takes it), and T stays where it fell below 1e-4.  ``last``: the slab
    index of the pixel's last composited gaussian, or -1.  ``k_stop``: the
    first 128-row batch at whose start no pixel of the tile has T >= 1e-4,
    at most ceil(min(live, Kc) / 128): a pixel that died at slab index
    ``last`` is dead from batch last // 128 + 1 on.  ``ts[k]``, k < k_stop:
    the pixel's T before slab row 128 k; ``ts[k_stop]``: its final T; the
    rows after k_stop (T10 leaves them unwritten) are NaN."""
    n_tiles, kc = cell_of_tile.shape[0], slab.shape[1]
    n_chunks = -(-kc // CHUNK)
    cell = cell_of_tile.long()
    pix = tile_pixels(tile_xy)
    T = pix.new_ones(n_tiles, P)
    last = torch.full((n_tiles, P), -1, dtype=torch.int32, device=slab.device)
    ts = pix.new_empty(n_tiles, n_chunks + 1, P)
    for k in range(n_chunks):
        ts[:, k] = T
        ch = slab[:, k * CHUNK:(k + 1) * CHUNK][cell]                  # (n, D, 10)
        dx = pix[:, :, None, 0] - ch[:, None, :, 0]
        dy = pix[:, :, None, 1] - ch[:, None, :, 1]
        con = ch[:, None, :, 2:5]
        power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
                 - con[..., 1] * dx * dy)
        alpha = torch.clamp(ch[:, None, :, 8] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        for j in range(ch.shape[1]):
            hit = (T >= T_EPS) & (alpha[..., j] > 0)
            T = torch.where(hit, T * (1.0 - alpha[..., j]), T)
            last = torch.where(hit, k * CHUNK + j, last)
    ts[:, n_chunks] = T
    chunks = (live_count.long().clamp(max=kc)[cell] + CHUNK - 1) // CHUNK
    dead_from = torch.where(T < T_EPS, last.long() // CHUNK + 1, chunks[:, None])
    k_stop = torch.minimum(dead_from.max(1).values, chunks)
    rows = torch.arange(n_chunks + 1, device=slab.device)[None, :, None]
    final = ts.gather(1, k_stop[:, None, None].expand(-1, 1, P))
    ts = torch.where(rows < k_stop[:, None, None], ts,
                     torch.where(rows == k_stop[:, None, None], final, float("nan")))
    return ts, last, k_stop.int()


def _check(name: str, slab, live_count, cell_of_tile, tile_xy) -> None:
    if slab.dtype != torch.float32 or slab.dim() != 3 or slab.shape[2] != ATTR:
        raise ValueError(f"{name}: slab must be float32 (n_cells, Kc, {ATTR}), "
                         f"got {slab.dtype} {tuple(slab.shape)}")
    n_tiles = cell_of_tile.shape[0]
    for nm, x, shape in (("live_count", live_count, (slab.shape[0],)),
                         ("cell_of_tile", cell_of_tile, (n_tiles,)),
                         ("tile_xy", tile_xy, (n_tiles, 2))):
        if x is not None and (x.dtype != torch.int32 or tuple(x.shape) != shape):
            raise ValueError(f"{name}: {nm} must be int32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if n_tiles == 0 or slab.shape[1] == 0:
        raise ValueError(f"{name}: empty input {tuple(slab.shape)}, "
                         f"{n_tiles} tiles")


def composite_fwd(slab: torch.Tensor, live_count: torch.Tensor,
                  cell_of_tile: torch.Tensor, tile_xy: torch.Tensor,
                  prof: torch.Tensor = None):
    """Launch T10.  Returns (rgb, acc, dep) and T10's checkpoints (ts
    (n_tiles, n_chunks + 1, 256) f32, last (n_tiles, 256) int32, k_stop
    (n_tiles,) int32) for ``composite_bwd`` (their plain version:
    ``composite_checkpoints_plain``; ts rows past the batches of the cell's
    live rows are not written).  Two launches: the table of the cull's
    boxes (``reach_boxes``, in scratch), then FWD_SPLIT blocks a tile.
    ``prof``: None, or a zeroed int64 CUDA tensor of (n_tiles,
    FWD_PROF_SLOTS) that receives per tile the most clock64 cycles of its
    blocks (in all, in the cull, in the walk, in the final writes), and the
    (band, gaussian) pairs their culls admitted and the gaussians they
    staged, summed."""
    _check("gs_composite_fwd", slab, live_count, cell_of_tile, tile_xy)
    slab, live_count, cell_of_tile, tile_xy = (
        x.contiguous() for x in (slab, live_count, cell_of_tile, tile_xy))
    n_tiles, kc = cell_of_tile.shape[0], slab.shape[1]
    n_chunks = -(-kc // CHUNK)
    f32 = dict(dtype=torch.float32, device=slab.device)
    i32 = dict(dtype=torch.int32, device=slab.device)
    rgb = torch.empty(n_tiles, P, 3, **f32)
    acc = torch.empty(n_tiles, P, **f32)
    dep = torch.empty(n_tiles, P, **f32)
    ts = torch.empty(n_tiles, n_chunks + 1, P, **f32)
    last = torch.empty(n_tiles, P, **i32)
    k_stop = torch.empty(n_tiles, **i32)
    boxes = torch.empty(slab.shape[0], kc, 4, dtype=torch.int16, device=slab.device)
    launch("gs_composite_fwd", "v3d_gs_composite_fwd", slab.device,
           slab.data_ptr(), live_count.data_ptr(), cell_of_tile.data_ptr(),
           tile_xy.data_ptr(), slab.shape[0], n_tiles, kc, n_chunks,
           boxes.data_ptr(), rgb.data_ptr(), acc.data_ptr(), dep.data_ptr(),
           ts.data_ptr(), last.data_ptr(), k_stop.data_ptr(),
           None if prof is None else prof.data_ptr())
    return (rgb, acc, dep), (ts, last, k_stop)


def composite_bwd(slab: torch.Tensor, cell_of_tile: torch.Tensor,
                  tile_xy: torch.Tensor, saved, g_rgb: torch.Tensor,
                  g_acc: torch.Tensor, g_dep: torch.Tensor,
                  prof: torch.Tensor = None) -> torch.Tensor:
    """Launch T11: the slab gradient (n_cells, Kc, 10) of the outputs whose
    cotangents are ``g_rgb`` (n_tiles, 256, 3), ``g_acc``, ``g_dep``
    (n_tiles, 256); ``saved`` is ``composite_fwd``'s second result.
    ``prof``: None, or an int64 CUDA tensor of (n_tiles, BWD_PROF_SLOTS)
    that receives each block's clock64 cycles (in all, and its longest
    group's front-to-back sums, walks and flushes), the (tile, gaussian)
    pairs its cull admitted and the gaussians its groups' first warps
    walked."""
    _check("gs_composite_bwd", slab, None, cell_of_tile, tile_xy)
    ts, last, k_stop = saved
    n_tiles, kc = cell_of_tile.shape[0], slab.shape[1]
    n_chunks = -(-kc // CHUNK)
    for nm, x, shape in (("g_rgb", g_rgb, (n_tiles, P, 3)),
                         ("g_acc", g_acc, (n_tiles, P)),
                         ("g_dep", g_dep, (n_tiles, P)),
                         ("ts", ts, (n_tiles, n_chunks + 1, P))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"gs_composite_bwd: {nm} must be float32 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    args = [x.contiguous() for x in (slab, cell_of_tile, tile_xy, ts, last,
                                     k_stop, g_rgb, g_acc, g_dep)]
    dslab = torch.zeros_like(args[0])
    launch("gs_composite_bwd", "v3d_gs_composite_bwd", slab.device,
           args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
           n_tiles, kc, n_chunks, *(x.data_ptr() for x in args[3:]),
           dslab.data_ptr(), None if prof is None else prof.data_ptr())
    return dslab


class GSComposite(torch.autograd.Function):
    """T10 forward, T11 backward (the custom VJP of render.py:308-337)."""

    @staticmethod
    def forward(ctx, slab, live_count, cell_of_tile, tile_xy):
        out, saved = composite_fwd(slab, live_count, cell_of_tile, tile_xy)
        ctx.save_for_backward(slab, cell_of_tile, tile_xy, *saved)
        return out

    @staticmethod
    def backward(ctx, g_rgb, g_acc, g_dep):
        slab, cell_of_tile, tile_xy, *saved = ctx.saved_tensors
        dslab = composite_bwd(slab, cell_of_tile, tile_xy, saved, g_rgb,
                              g_acc, g_dep)
        return dslab, None, None, None


def composite(slab: torch.Tensor, live_count: torch.Tensor,
              cell_of_tile: torch.Tensor, tile_xy: torch.Tensor,
              depth_chunk: int = 256, tile_chunk: int = 32):
    """rgb, acc, dep of the slab over the tiles: T10 (and T11 in the
    backward) for CUDA tensors, the plain version for CPU tensors or inside
    ``reference_mode()``.  ``depth_chunk`` and ``tile_chunk`` shape only the
    plain version's work."""
    if use_plain(slab, live_count, cell_of_tile, tile_xy):
        return composite_plain(slab, live_count, cell_of_tile, tile_xy,
                               depth_chunk, tile_chunk)
    return GSComposite.apply(slab, live_count, cell_of_tile, tile_xy)
