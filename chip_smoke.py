#!/usr/bin/env python3
"""Smoke test of the v3d_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing lines before the last:

1. environment: ``nvidia-smi`` name and power limit, CUDA, nvcc, TF32 flags;
2. build of the hand-written kernels (v3d_tpu_torch/csrc, one nvcc per
   source, all started together, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with error, median CUDA-event time of both, the bound
   (the least time the card could take: bytes over HBM rate or operations
   over the peak of their type, whichever is larger) and, where one PyTorch
   call computes the same function, that call's time;
4. one full-width V3D-512 UNet forward (bf16, batch 36 at 64^2) with the
   kernels against the same forward in ``reference_mode()`` (plain versions);
5. the generation path twice: ``v3d_tpu_torch.apps.generate.sample_one`` on
   a synthetic 512^2 RGBA image, 18 frames, 25 steps, CFG 3.5, seeded random
   bf16 weights; launch counts per generation, timings, peak memory;
6. the 3DGS fit: one step's gradients with the kernels against the same step
   in ``reference_mode()``, then ``v3d_tpu_torch.apps.recon_gs
   .train_from_frames`` at the reference operating point (512^2 orbit of 18
   frames rendered from a seeded synthetic scene, 100k random points in 300k
   slots, the shipped recipe, 200 iterations with a densify event at 200);
   ms per step, the event's ms, alive counts, losses, PSNR, peak memory,
   launch counts;
7. where a fit step's time goes: CUDA events around its stages, and a
   ``torch.profiler`` trace of a few steps (device busy share, time by
   kernel class).

Each path (phases 5 and 6) is run with the launch counts set to 0 just
before it and read just after; a kernel of the path launched no time, or
another number of times than the path needs, fails the run.  Then one JSON
line with every kernel's numbers, and last the line ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero before that line.  No CUDA
device: exit 2 at once.  Nothing here imports JAX or v3d_tpu.

TF32: both ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, so float32 products and
convolutions run in full float32 (generation itself runs in bf16).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

# Tolerances (kernel vs plain version on the same inputs)
F32_MAX_REL = 1e-4    # max |kernel - plain| / max |plain|, float32
BF16_MIN_PSNR = 40.0  # dB, bf16 kernel vs the plain float32 result
UNET_MIN_PSNR = 30.0  # dB, phase 4: bf16 UNet with kernels vs plain versions
# 3DGS compositor (float32): a pair whose transmittance sits at the 1e-4
# stop may count on one side only (<= 1e-4 of a pixel); T11 divides T back
# and sums with atomics in another order
GS_RGB_ACC_MAX_ABS = 1e-4
GS_DEPTH_MAX_ABS = 1e-3
GS_GRAD_REL = 1e-3    # per attribute: max abs <= GS_GRAD_REL * max |plain|

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12    # FLOP/s, tensor cores
PEAK_FP32 = 67e12     # FLOP/s, outside the tensor cores
PEAK_HBM = 3.35e12    # bytes/s

# FLOPs per (pixel, gaussian) pair of the compositor, counted from its
# arithmetic: the alpha test (offsets, quadratic form, exp, opacity, clamp),
# a forward composite (weight, 4 FMAs, acc, transmittance), a backward
# composite (T divided back, g.b, dalpha, S, the ten partials, warp sums)
GS_FLOPS_TEST = 14
GS_FLOPS_FWD = 12
GS_FLOPS_BWD = 50

# the fit of phase 6: the reference operating point (100k random points in
# 300k slots), 200 iterations with densification from iteration 100
FIT_ITERS = 200
FIT_POINTS = 100_000
FIT_CAPACITY = 300_000
# launches each path needs (phase 5: one generation; phase 6: the fit)
GEN_LAUNCHES = {"flash_attn_fwd": 250, "temporal_block": 125,
                "temporal_core": 275, "gs_composite_fwd": 0,
                "gs_composite_bwd": 0}
KERNELS = {
    "flash_attn_fwd": dict(
        label="K1", source="v3d_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="v3d_tpu/ops/attention.py:142 (attention_bhsd, flash_jax)"),
    "temporal_block": dict(
        label="K2", source="v3d_tpu_torch/csrc/temporal_block.cu",
        replaces="v3d_tpu/ops/temporal_attention.py:312 (_pallas_block)"),
    "temporal_core": dict(
        label="K3", source="v3d_tpu_torch/csrc/temporal_core.cu",
        replaces="v3d_tpu/ops/temporal_attention.py:198 (_pallas_core)"),
    "gs_composite_fwd": dict(
        label="K4", source="v3d_tpu_torch/csrc/gs_composite_fwd.cu",
        replaces="v3d_tpu/gs/pallas_raster.py:318 (composite_tiles_fwd, T10)"),
    "gs_composite_bwd": dict(
        label="K5", source="v3d_tpu_torch/csrc/gs_composite_bwd.cu",
        replaces="v3d_tpu/gs/pallas_raster.py:267 (composite_tiles_bwd, T11)"),
}


class SmokeFailure(RuntimeError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def psnr(x, ref) -> float:
    mse = float(((x.float() - ref.float()) ** 2).mean())
    peak = float(ref.float().abs().max())
    return float("inf") if mse == 0 else 10 * math.log10(peak * peak / mse)


def phase_env() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr}")
    from v3d_tpu_torch.kernels.build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {nvcc[-1] if nvcc else '?'} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} | "
        f"devices {torch.cuda.device_count()}")
    return {"card": card}


def phase_build() -> None:
    from v3d_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(force=True)
    build.library()
    secs = time.perf_counter() - t0
    say("2 build", f"{secs:.1f} s, {build.LIB_PATH.name}; ptxas: "
        + " | ".join(ptxas_summary(build.LOG_PATH.read_text())))


def ptxas_summary(log: str) -> list:
    """'kernel<type>: registers, spill bytes' for each entry function."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"[a-z_]+_kernel", mangled.replace("_GLOBAL__N_", ""))
            name = (base.group(0).lstrip("_0123456789") if base else mangled) + (
                "<bf16>" if "bfloat16" in mangled else "<f32>" if "IfE" in mangled
                else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill or 0} B spilled")
            name, spill = None, ""
    return out


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """(least time in ms, what bounds it): operations over the peak of their
    type or bytes over the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _check(name, shape_tag, dtype, kernel_fn, plain_fn, plain_f32_fn, work,
           library_fn=None) -> dict:
    """Run kernel and plain version on the same inputs; compare and time.
    ``work`` = (flops, bytes) of the function at this shape."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    err = float((out.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        rel = err / float(ref.abs().max())
        ok = rel <= F32_MAX_REL
        metric = f"max_rel {rel:.3e} (<= {F32_MAX_REL:g})"
    else:
        quality = psnr(out, plain_f32_fn())
        ok = quality >= BF16_MIN_PSNR
        metric = f"psnr_vs_f32 {quality:.2f} dB (>= {BF16_MIN_PSNR:g})"
    if not torch.isfinite(out).all():
        ok = False
    ms = cuda_ms(kernel_fn)
    plain_ms = cuda_ms(plain_fn)
    library_ms = cuda_ms(library_fn) if library_fn else None
    bound, bound_by = bound_ms(*work, PEAK_BF16 if dtype == torch.bfloat16
                               else PEAK_FP32)
    say("3 kernels", f"{KERNELS[name]['label']} {name} {shape_tag} "
        f"{str(dtype).split('.')[-1]}: max_abs {err:.3e} {metric} | kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} | bound "
        f"{bound:.4f} ms ({bound_by}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} {shape_tag} {dtype} disagrees: {metric}")
    return {"shape": shape_tag, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.attention import flash_attn_fwd, flash_attn_fwd_plain
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
        temporal_core,
        temporal_core_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {name: [] for name in KERNELS}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    # K1: 2-sample slices of ds1 and ds2, the layout the projection gives;
    # library: scaled_dot_product_attention on the same (b, h, s, 64) tensors
    for tag, (b, h, s) in (("ds1", (2, 5, 4096)), ("ds2", (2, 10, 1024))):
        x32 = [randn(b, s, h, 64).transpose(1, 2) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t_.to(dtype) for t_ in x32)
            up = [t_.float() for t_ in (q, k, v)]
            size = 4 if dtype == torch.float32 else 2
            results["flash_attn_fwd"].append(_check(
                "flash_attn_fwd", f"{tag} {(b, h, s, 64)}", dtype,
                lambda: flash_attn_fwd(q, k, v),
                lambda: flash_attn_fwd_plain(q, k, v),
                lambda: flash_attn_fwd_plain(*up),
                (4 * b * h * s * s * 64, 4 * b * h * s * 64 * size),
                lambda: F.scaled_dot_product_attention(q, k, v)))

    # K2: the ds1 temporal layer, x (2, 18, 4096, 320), 5 heads of 64; no
    # single library call computes projections + attention + projection
    b, t, s, c, heads = 2, 18, 4096, 320, 5
    x32 = randn(b, t, s, c)
    w32 = [randn(c, c, scale=c ** -0.5) for _ in range(4)] + [randn(c, scale=0.1)]
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        ws = [w.to(dtype) for w in w32]
        up = [x.float()] + [w.float() for w in ws]
        size = 4 if dtype == torch.float32 else 2
        tokens = b * t * s
        results["temporal_block"].append(_check(
            "temporal_block", f"ds1 {(b, t, s, c)} h{heads}", dtype,
            lambda: temporal_block_attention(x, *ws, heads),
            lambda: temporal_block_attention_plain(x, *ws, heads),
            lambda: temporal_block_attention_plain(*up, heads),
            (8 * tokens * c * c + 4 * b * s * heads * t * t * 64,
             (2 * tokens * c + 4 * c * c + c) * size)))

    # K3: n = b*s*heads = 20480 (ds2), 10240 (ds4), 2560 (ds8), projection
    # output layout (b, t, s, heads*64) as strided views of one buffer;
    # library: scaled_dot_product_attention on the frames reshaped to
    # (b*s, heads, t, 64)
    for tag, (s, heads) in (("ds2", (1024, 10)), ("ds4", (256, 20)),
                            ("ds8", (64, 20))):
        hd = heads * 64
        qkv32 = randn(2, 18, s, 3 * hd)
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
            up = [t_.float() for t_ in (q, k, v)]
            lib = [t_.reshape(2, 18, s, heads, 64).permute(0, 2, 3, 1, 4)
                   .reshape(2 * s, heads, 18, 64) for t_ in (q, k, v)]
            size = 4 if dtype == torch.float32 else 2
            n = 2 * s * heads
            results["temporal_core"].append(_check(
                "temporal_core", f"{tag} n={n}", dtype,
                lambda: temporal_core(q, k, v, heads),
                lambda: temporal_core_plain(q, k, v, heads),
                lambda: temporal_core_plain(*up, heads),
                (4 * n * 18 * 18 * 64, 4 * n * 18 * 64 * size),
                lambda: F.scaled_dot_product_attention(*lib)))
    results.update(phase_gs_kernels())
    return results


def fit_scene_slabs(dev, n: int = 100_000, res: int = 512, kc: int = 2048):
    """The slab T10/T11 see at the first step of the fit: the trainer's
    seeded random init of ``n`` points projected from orbit camera 0 at
    res^2, binned into 8x8-tile coarse cells of Kc = ``kc``."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.gaussians import from_pcd, random_init_pcd
    from v3d_tpu_torch.gs.render import RasterizeConfig, build_slabs, project_gaussians

    xyz, colors = random_init_pcd(np.random.RandomState(0), n, radius=2.0)
    g = from_pcd(xyz, colors, capacity=3 * n, device=dev)
    cam = orbit_cameras(18, resolution=res)[0]
    return build_slabs(project_gaussians(g, cam), res, res,
                       RasterizeConfig(max_per_coarse=kc))


def gs_pairs(slabs, saved) -> dict:
    """The (pixel, gaussian) pairs this run's data needs.  T10: per pixel the
    gaussians up to its last composited one when its T fell below 1e-4, else
    the cell's live ones.  T11: those up to the last composited one.  Both:
    the composited ones among them."""
    import torch

    from v3d_tpu_torch.ops.gs_composite import ALPHA_MAX, ALPHA_MIN, T_EPS, tile_pixels

    ts, last, k_stop = saved
    slab, kc = slabs.slab.detach(), slabs.slab.shape[1]
    cell = slabs.cell_of_tile.long()
    t_final = ts.gather(1, k_stop.long()[:, None, None].expand(-1, 1, ts.shape[2]))[:, 0]
    n_live = slabs.live_count.long().clamp(max=kc)[cell][:, None]
    tested = torch.where(t_final < T_EPS, last.long() + 1, n_live).sum()
    composited = 0
    pix_all = tile_pixels(slabs.tile_xy)
    j = torch.arange(kc, device=slab.device)
    for t0 in range(0, pix_all.shape[0], 16):
        pix, sl = pix_all[t0:t0 + 16], slab[cell[t0:t0 + 16]]
        dx = pix[:, :, None, 0] - sl[:, None, :, 0]
        dy = pix[:, :, None, 1] - sl[:, None, :, 1]
        con = sl[:, None, :, 2:5]
        power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
                 - con[..., 1] * dx * dy)
        alpha = torch.clamp(sl[:, None, :, 8] * torch.exp(power), max=ALPHA_MAX)
        ok = (power <= 0) & (alpha >= ALPHA_MIN) & (j <= last[t0:t0 + 16, :, None])
        composited += int(ok.sum())
    return {"tested": int(tested), "tested_bwd": int((last.long() + 1).sum()),
            "composited": composited, "ts_rows": int(k_stop.sum())}


def phase_gs_kernels() -> dict:
    """K4 / K5 (T10 / T11) against the plain compositor at the fit's
    full-width shapes (512^2: 1024 tiles, 16 cells of Kc = 2048)."""
    import torch

    from v3d_tpu_torch.ops import gs_composite as gc

    dev = torch.device("cuda")
    slabs = fit_scene_slabs(dev)
    args = (slabs.slab.detach().contiguous(), slabs.live_count,
            slabs.cell_of_tile, slabs.tile_xy)
    n_cells, kc, _ = args[0].shape
    n_tiles = args[2].shape[0]
    n_pix = n_tiles * gc.P
    tag = f"slab {tuple(args[0].shape)} {n_tiles} tiles"

    out, saved = gc.composite_fwd(*args)
    torch.cuda.synchronize()
    ref = gc.composite_plain(*args)
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    ok_fwd = (all(bool(torch.isfinite(o).all()) for o in out)
              and max(errs[:2]) <= GS_RGB_ACC_MAX_ABS and errs[2] <= GS_DEPTH_MAX_ABS)

    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(o.shape, device=dev, generator=gen) for o in out]
    dslab = gc.composite_bwd(args[0], args[2], args[3], saved, *cot)
    torch.cuda.synchronize()
    slab = args[0].clone().requires_grad_(True)
    plain_out = gc.composite_plain(slab, *args[1:])
    (want,) = torch.autograd.grad(plain_out, slab, cot, retain_graph=True)
    rows = []
    for a in range(gc.ATTR):
        scale = float(want[..., a].abs().max())
        rows.append((float((dslab[..., a] - want[..., a]).abs().max()), scale))
    ok_bwd = bool(torch.isfinite(dslab).all()) and all(
        e <= GS_GRAD_REL * sc for e, sc in rows)

    pairs = gs_pairs(slabs, saved)
    fwd_ms = cuda_ms(lambda: gc.composite_fwd(*args))
    plain_fwd_ms = cuda_ms(lambda: gc.composite_plain(*args), iters=5, warmup=1)
    bwd_ms = cuda_ms(lambda: gc.composite_bwd(args[0], args[2], args[3], saved, *cot))
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out, slab, cot, retain_graph=True), iters=5, warmup=1)
    slab_bytes = n_cells * kc * gc.ATTR * 4
    fwd_bound = bound_ms(
        pairs["tested"] * GS_FLOPS_TEST + pairs["composited"] * GS_FLOPS_FWD,
        slab_bytes + n_pix * 24 + (pairs["ts_rows"] + n_tiles) * gc.P * 4
        + n_tiles * 16, PEAK_FP32)
    bwd_bound = bound_ms(
        pairs["tested_bwd"] * GS_FLOPS_TEST + pairs["composited"] * GS_FLOPS_BWD,
        2 * slab_bytes + n_pix * 24 + pairs["ts_rows"] * gc.P * 4 + n_tiles * 12,
        PEAK_FP32)
    say("3 kernels", f"K4 gs_composite_fwd (T10) {tag} f32: max_abs rgb "
        f"{errs[0]:.3e} acc {errs[1]:.3e} (<= {GS_RGB_ACC_MAX_ABS:g}) depth "
        f"{errs[2]:.3e} (<= {GS_DEPTH_MAX_ABS:g}) | kernel {fwd_ms:.4f} ms "
        f"plain {plain_fwd_ms:.4f} ms library none | bound {fwd_bound[0]:.4f} "
        f"ms ({fwd_bound[1]}) | pairs tested {pairs['tested']:,} composited "
        f"{pairs['composited']:,}, k_stop rows {pairs['ts_rows']:,} | "
        f"{'ok' if ok_fwd else 'FAIL'}")
    say("3 kernels", f"K5 gs_composite_bwd (T11) {tag} f32: per attribute "
        f"max_abs / max|plain| " + " ".join(f"{e / max(sc, 1e-30):.2e}"
                                            for e, sc in rows)
        + f" (<= {GS_GRAD_REL:g}) | kernel {bwd_ms:.4f} ms plain (autograd "
        f"backward) {plain_bwd_ms:.4f} ms library none | bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}) | pairs tested "
        f"{pairs['tested_bwd']:,} | {'ok' if ok_bwd else 'FAIL'}")
    if not (ok_fwd and ok_bwd):
        raise SmokeFailure(f"gs_composite disagrees: fwd {errs}, bwd {rows}")
    common = {"shape": tag, "dtype": "float32", "library_ms": None}
    return {
        "gs_composite_fwd": [dict(common, max_abs_err=max(errs), ms=fwd_ms,
                                  plain_ms=plain_fwd_ms, bound_ms=fwd_bound[0],
                                  bound_by=fwd_bound[1])],
        "gs_composite_bwd": [dict(common, max_abs_err=max(e for e, _ in rows),
                                  ms=bwd_ms, plain_ms=plain_bwd_ms,
                                  bound_ms=bwd_bound[0], bound_by=bwd_bound[1])]}


def build_engine(device):
    import torch

    from v3d_tpu_torch.engines.builder import build_v3d_engine

    t0 = time.perf_counter()
    engine = build_v3d_engine(device=device, dtype=torch.bfloat16, seed=0)
    n = sum(p.numel() for p in engine.unet.parameters())
    say("4 unet", f"V3D-512 engine built in {time.perf_counter() - t0:.1f} s "
        f"(seeded N(0, 1/fan_in) weights, bf16); UNet {n:,} parameters")
    return engine


def phase_unet(engine, batch: int = 36, hw: int = 64) -> float:
    """One full-width UNet forward with the kernels against the same forward
    with every kernel replaced by its plain version."""
    import torch

    from v3d_tpu_torch.ops import reference_mode

    dev = engine.device
    t = engine.num_frames
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(batch, 8, hw, hw, device=dev, generator=gen)
    c_noise = 0.25 * torch.log(torch.full((batch,), 10.0, device=dev))
    ctx = torch.randn(batch, 1, engine.unet.context_dim, device=dev,
                      generator=gen)
    y = torch.randn(batch, 768, device=dev, generator=gen)
    ind = torch.zeros(batch // t, t, device=dev)

    def fwd():
        with torch.no_grad():
            return engine.unet(x, c_noise, ctx, y, t, ind)

    out = fwd()
    with reference_mode():
        ref = fwd()
    quality = psnr(out, ref)
    ok = bool(torch.isfinite(out).all()) and quality >= UNET_MIN_PSNR
    # steady state, in turns: kernels, plain, kernels, plain
    times = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "kernels", "plain"):
        with reference_mode() if name == "plain" else contextlib.nullcontext():
            times[name].append(round(cuda_ms(fwd, iters=3, warmup=1), 3))
    say("4 unet", f"forward {tuple(x.shape)} bf16: kernels vs plain PSNR "
        f"{quality:.2f} dB (>= {UNET_MIN_PSNR:g}), max_abs "
        f"{float((out - ref).abs().max()):.3e}, |ref| max "
        f"{float(ref.abs().max()):.3e} | median ms, in turns: kernels "
        f"{times['kernels']} plain {times['plain']} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"UNet forward with kernels disagrees: {quality} dB")
    return quality


def synthetic_image(size: int = 512, seed: int = 0):
    """An RGBA object on a transparent background, made with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    img = np.zeros((size, size, 4), np.uint8)
    inside = (yy - 0.55) ** 2 / 0.09 + (xx - 0.45) ** 2 / 0.05 < 1
    img[..., :3] = (rng.random((size, size, 3)) * 80
                    + np.stack([200 * xx, 150 * yy, 120 + 0 * xx], -1))
    img[..., 3] = np.where(inside, 255, 0)
    return img


def phase_generate(engine, requests: int = 2) -> dict:
    """The main path through its user entry point, ``requests`` times on one
    engine; each run's launch counts must equal the path's."""
    import torch

    from v3d_tpu_torch.apps.generate import sample_one
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    image = synthetic_image()
    out = {}
    for r in range(requests):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        frames, _, timings = sample_one(image, engine=engine, seed=23 + r,
                                        decoding_t=engine.num_frames)
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        shape_ok = frames.shape == (engine.num_frames, 512, 512, 3)
        counts_ok = counts == GEN_LAUNCHES
        say("5 generate", f"request {r}: {wall:.3f} s (cond "
            f"{timings['cond_s']:.3f}, sample {timings['sample_s']:.3f}, "
            f"decode {timings['decode_s']:.3f}) | peak "
            f"{peak:.2f} GiB | frames {frames.shape} {frames.dtype} "
            f"[{frames.min()}, {frames.max()}] std {frames.std():.2f} | "
            f"launches {counts} (expect {GEN_LAUNCHES}) | "
            f"{'ok' if shape_ok and counts_ok else 'FAIL'}")
        if not (shape_ok and counts_ok):
            raise SmokeFailure(f"request {r}: frames {frames.shape}, "
                               f"launches {counts}")
        out = {"launches": counts, "timings": timings, "peak_gib": peak}
    return out


def scene_frames(dev, n: int = 4000, res: int = 512, seed: int = 7):
    """The 18 orbit views (res^2, radius 2, elevation 0, FOV 60) of a seeded
    synthetic object of ``n`` coloured anisotropic gaussians (a shell and a
    core), rendered by the port in ``reference_mode()``.  (18, res, res, 3)
    float32 numpy in [0, 1]."""
    import numpy as np
    import torch

    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.gaussians import Gaussians
    from v3d_tpu_torch.gs.render import RasterizeConfig, render
    from v3d_tpu_torch.gs.sh import rgb2sh
    from v3d_tpu_torch.ops import reference_mode

    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.where(rng.rand(n) < 0.7, 1.0, rng.rand(n) ** (1 / 3))
    xyz = d * r[:, None] * np.array([0.45, 0.35, 0.55])
    rgb = 0.5 + 0.4 * np.sin(4.0 * xyz + rng.rand(3) * 6.0)
    arrays = dict(xyz=xyz, f_dc=rgb2sh(rgb)[:, None, :], f_rest=np.zeros((n, 0, 3)),
                  scaling=np.log(rng.uniform(0.012, 0.04, (n, 3))),
                  rotation=rng.randn(n, 4), opacity=np.full((n, 1), 1.5))
    g = Gaussians(alive=torch.ones(n, dtype=torch.bool, device=dev),
                  **{k: torch.tensor(v, dtype=torch.float32, device=dev)
                     for k, v in arrays.items()})
    bg = torch.ones(3, device=dev)
    with reference_mode(), torch.no_grad():
        views = [render(g, cam, bg, config=RasterizeConfig(max_per_coarse=2048)).image
                 for cam in orbit_cameras(18, resolution=res)]
    return torch.stack(views).clamp(0, 1).cpu().numpy()


def phase_fit(frames, dev) -> dict:
    """One step's gradients with the kernels against reference_mode() (on
    the init made anisotropic and rotated), then
    the fit through its entry point, train_from_frames, at the reference
    operating point, with the launch counts set to 0 just before it."""
    import os
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch.apps.recon_gs import train_from_frames
    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.losses import psnr as gs_psnr
    from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
    from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts

    t = frames.shape[0]
    # gradient check: the recipe's first step on view 0, kernels vs plain
    cfg = GSTrainConfig(lambda_dssim=1.0, opacity_reset_mode="none",
                        opacity_decay=0.995)
    tr = GSTrainer(orbit_cameras(t, resolution=frames.shape[1], images=list(frames)),
                   cfg, num_pts=FIT_POINTS, capacity=FIT_CAPACITY, seed=0,
                   device=dev)
    # anisotropic, rotated gaussians: at the isotropic init the rotation
    # gradient is 0 up to rounding, and rounding is not what is compared
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        for k, scale in (("scaling", 0.3), ("rotation", 1.0)):
            p = tr.params[k]
            p.add_(scale * torch.randn(p.shape, device=dev, generator=gen))
    grads = []
    for mode in (contextlib.nullcontext, reference_mode):
        with mode():
            loss, _, screen_grad = tr.compute_grads(0)
        g = {k: p.grad.clone() for k, p in tr.params.items() if p.numel()}
        g["screen_offset"] = screen_grad
        grads.append((float(loss), g))
    (loss_k, gk), (loss_p, gp) = grads
    rows = {k: (float((gk[k] - gp[k]).abs().max()), float(gp[k].abs().max()))
            for k in gp}
    ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
          and all(bool(torch.isfinite(v).all()) for v in gk.values())
          and all(e <= GS_GRAD_REL * sc and sc > 0 for e, sc in rows.values()))
    say("6 fit", f"step-1 gradients, kernels vs reference_mode(): loss "
        f"{loss_k:.7f} vs {loss_p:.7f}; max_abs / max|plain| "
        + ", ".join(f"{k} {e / sc:.2e}" for k, (e, sc) in rows.items())
        + f" (<= {GS_GRAD_REL:g}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"fit gradients disagree: {loss_k} {loss_p} {rows}")
    del tr, gk, gp, grads
    torch.cuda.empty_cache()

    marks, losses, event = [], [], {}

    def record(stats):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(stats["loss"]))
        if "num_alive" in stats:
            event.update({k: int(v) for k, v in stats.items() if k != "loss"})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        trainer = train_from_frames(
            frames, out_dir, iterations=FIT_ITERS, num_pts=FIT_POINTS,
            capacity=FIT_CAPACITY, test_every=1, log_fn=record,
            config_overrides={"densify_from_iter": FIT_ITERS // 2}, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        orbit = np.load(os.path.join(out_dir, "orbit.npy"))
        ply_bytes = os.path.getsize(os.path.join(out_dir, "point_cloud.ply"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = {name: 0 for name in KERNELS}
    expect.update(gs_composite_fwd=FIT_ITERS + t, gs_composite_bwd=FIT_ITERS)
    steps = [b - a for a, b in zip(marks, marks[1:])]     # steps 2..200
    step_ms = 1e3 * statistics.median(steps[9:-1])        # after 10 warm-up
    event_ms = 1e3 * steps[-1] - step_ms
    view0 = float(gs_psnr(trainer.render_view(0).image, trainer.images[0]))
    ok = (counts == expect and all(map(math.isfinite, losses))
          and losses[-1] < losses[0] and event.get("iter") == FIT_ITERS
          and orbit.shape == (t,) + frames.shape[1:] and ply_bytes > 0
          and math.isfinite(view0))
    say("6 fit", f"train_from_frames {FIT_ITERS} iterations at "
        f"{frames.shape[1]}^2, {FIT_POINTS} points in {FIT_CAPACITY} slots: "
        f"{wall:.3f} s | ms "
        f"per step (median of steps 11-199, host clock, synchronised each "
        f"step) {step_ms:.3f} | densify event at iteration {event.get('iter')}"
        f" {event_ms:.3f} ms over a step: alive {event.get('alive_before')} "
        f"-> {event.get('num_alive')} (cloned {event.get('cloned')}, split "
        f"{event.get('split')}, pruned {event.get('pruned')}) | loss first "
        f"{losses[0]:.5f} last {losses[-1]:.5f} | view-0 PSNR {view0:.2f} dB "
        f"| peak {peak:.2f} GiB | orbit {orbit.shape} ply {ply_bytes} B | "
        f"launches {counts} (expect {expect}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"fit: launches {counts}, losses {losses[:1]} "
                           f"{losses[-1:]}, event {event}")
    return {"launches": counts, "trainer": trainer, "step_ms": step_ms}


KERNEL_CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("K4 T10 gs_composite_fwd", ("gs_composite_fwd",)),
    ("K5 T11 gs_composite_bwd", ("gs_composite_bwd",)),
    ("binning: top-k / sort / scan", ("topk", "sort", "radix", "scan", "bitonic")),
    ("gather / scatter (slab, densify)", ("index", "gather", "scatter")),
    ("SSIM convolution", ("conv", "cudnn", "depthwise", "implicit")),
    ("Adam", ("adam", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("copies / fills", ("memcpy", "memset", "copy", "fill")),
)


def phase_profile(trainer, step_ms: float, steps: int = 5) -> None:
    """Where a fit step's time goes: a torch.profiler trace of ``steps``
    steps (device time by kernel class; the device busy share of the traced
    span, and of ``step_ms``, phase 6's step time without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        trainer.train_iter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_iter()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans, classes = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                   "elementwise (projection, loss, their backward)")
        ms, n = classes.get(cls, (0.0, 0))
        classes[cls] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    if not spans:
        say("7 profile", "the profiler recorded no device events")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    total = sum(ms for ms, _ in classes.values())
    busy_ms = busy / 1e3 / steps
    say("7 profile", f"{steps} fit steps under the profiler: {1e3 * wall / steps:.3f} "
        f"ms per step (host clock), device busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms span, idle {100 * (1 - busy / span):.1f}% | "
        f"without the profiler: {busy_ms:.3f} ms busy of a {step_ms:.3f} ms "
        f"step, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for cls, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        say("7 profile", f"  {cls}: {ms / steps:.3f} ms per step "
            f"({100 * ms / total:.1f}%), {n // steps} kernels per step")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7",
                   help="comma-separated subset of phases to run")
    args = p.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    import torch

    import v3d_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    phase_env()
    if 2 in phases:
        phase_build()
    kernel_checks = phase_kernels() if 3 in phases else {}
    engine = build_engine(torch.device("cuda")) if phases & {4, 5} else None
    if 4 in phases:
        phase_unet(engine)
    gen = phase_generate(engine) if 5 in phases else {}
    del engine
    torch.cuda.empty_cache()
    fit = {}
    if phases & {6, 7}:
        t0 = time.perf_counter()
        frames = scene_frames(torch.device("cuda"))
        say("6 fit", f"target frames {frames.shape} rendered in reference_mode() "
            f"in {time.perf_counter() - t0:.2f} s, mean {frames.mean():.3f}")
        fit = phase_fit(frames, torch.device("cuda"))
    if 7 in phases:
        phase_profile(fit["trainer"], fit["step_ms"])

    report = []
    for name, meta in KERNELS.items():
        checks = kernel_checks.get(name, [])
        bf16 = [c for c in checks if c["dtype"] == "bfloat16"]
        head = bf16[0] if bf16 else checks[0] if checks else {}
        path = fit if name.startswith("gs_") else gen
        report.append({
            "name": f"{meta['label']} {name}", "route": "cuda",
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": path.get("launches", {}).get(name),
            "max_abs_err": head.get("max_abs_err"), "ms": head.get("ms"),
            "plain_ms": head.get("plain_ms"), "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"), "at": head.get("shape"),
            "checks": checks})
    print(json.dumps({"kernels": report}), flush=True)
    last = {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}
    if phases != {1, 2, 3, 4, 5, 6, 7}:
        last["phases"] = sorted(phases)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
