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
- ``composite_fwd`` / ``composite_bwd``: the launch wrappers of T10 / T11
  (csrc/gs_composite_fwd.cu, csrc/gs_composite_bwd.cu).
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
                  cell_of_tile: torch.Tensor, tile_xy: torch.Tensor):
    """Launch T10.  Returns (rgb, acc, dep) and T10's checkpoints (ts
    (n_tiles, n_chunks + 1, 256) f32, last (n_tiles, 256) int32, k_stop
    (n_tiles,) int32) for ``composite_bwd``."""
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
    launch("gs_composite_fwd", "v3d_gs_composite_fwd", slab.device,
           slab.data_ptr(), live_count.data_ptr(), cell_of_tile.data_ptr(),
           tile_xy.data_ptr(), n_tiles, kc, n_chunks, rgb.data_ptr(),
           acc.data_ptr(), dep.data_ptr(), ts.data_ptr(), last.data_ptr(),
           k_stop.data_ptr())
    return (rgb, acc, dep), (ts, last, k_stop)


def composite_bwd(slab: torch.Tensor, cell_of_tile: torch.Tensor,
                  tile_xy: torch.Tensor, saved, g_rgb: torch.Tensor,
                  g_acc: torch.Tensor, g_dep: torch.Tensor) -> torch.Tensor:
    """Launch T11: the slab gradient (n_cells, Kc, 10) of the outputs whose
    cotangents are ``g_rgb`` (n_tiles, 256, 3), ``g_acc``, ``g_dep``
    (n_tiles, 256); ``saved`` is ``composite_fwd``'s second result."""
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
           dslab.data_ptr())
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
