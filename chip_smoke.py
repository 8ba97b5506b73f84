#!/usr/bin/env python3
"""Smoke test of the v3d_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases 1,2,5,16   # some of them

Phases, each printing lines before the last:

1. environment: ``nvidia-smi`` name and power limit, CUDA, nvcc, TF32 flags;
2. build of the hand-written kernels (v3d_tpu_torch/csrc, one nvcc per
   source, all started together, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with error, median CUDA-event time of both, the bound
   (the least time the card could take: bytes over HBM rate or operations
   over the peak of their type, whichever is larger) and, where one PyTorch
   call computes the same function, that call's time (K2: the model's
   unfused route, as no single call computes T8); K6 at every shape of a
   UNet forward (``K6_FORWARD_SHAPES``) with the forward's summed time
   against its summed bound; each redesigned kernel's launch plan against
   the library's shared-memory figure, K1's, K7's and K9's wgmma products
   alone against torch.matmul, and K2's, K5's, K6's, K7's and K8's clock64
   phases (K5 with the (tile, gaussian) pairs its cull admitted); K4 / K5's
   bound counts the pairs of the exact 1/255 boxes (``gs_pairs``), not
   every pair a cell-wide sweep tests; K8 + K7 (the flash backward) also
   as a pair through ``flash_attn_bwd`` against SDPA's backward and the
   bounds of the pair (seven products) and of the function (five);
4. one full-width V3D-512 UNet forward (bf16, batch 36 at 64^2) with the
   kernels against the same forward in ``reference_mode()`` (plain versions),
   and a ``torch.profiler`` trace of two forwards (device time by kernel
   class, busy share);
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
   kernel class);
8. the VideoUNet fine-tune step at V3D-512's full width (f32 master
   weights, bf16 compute, gradient checkpointing, 1 video of 18 frames at
   64^2 latents): one step's gradients with the kernels against
   ``reference_mode()`` on the same batch and draws, then
   ``v3d_tpu_torch.apps.train_diffusion.train`` for a few AdamW steps
   (ms per step, peak memory, loss and gradient norm per step, launches per
   step), a step without checkpointing, and a profile of two steps;
9. the JAX package's other attention routings (run after phase 5, on its
   engine): under each of ``ROUTE_CONFIGS`` (the projection layout and the
   backend setters) one full-width UNet forward against
   ``reference_mode()``; the 18-frame VAE decode under "flash" (K9, d =
   512) and CLIP under "packed" (K9, d = 80); then the generation twice
   under ``set_default_backend("flash")``.  Phase 3 also holds the routes
   T2-T6 (``ops/flash_attention.py``, ``ops/temporal_attention.py``) on K1,
   K3 and K9 at their shapes;
10. checkpoint loading at full width (after phase 9, on its engine): the
    V3D-512 engine's bf16 weights written under the sgm prefixes with the
    port's safetensors writer, loaded into a second engine by
    ``core.checkpoint.load_v3d_params``, one UNet forward bit for bit equal,
    the load time; then a tiny ``{"state_dict": ...}`` .ckpt through
    ``apps.generate``'s ``--checkpoint``;
11. NeuS -> mesh: ``apps.recon_neus.reconstruct`` on the card's recipe at
    the shipped schedules (max_steps 3000) cut to 600 steps, on 18 orbit
    views at 512^2 of an analytic scene (a sphere united with a box,
    coloured per region, on white) sphere-traced on the card: ms per step,
    the ray count, peak memory, the losses, holdout PSNR on two views
    between orbit frames, the export (sdf_grid + isosurface at 384^3), the
    mesh's size and its vertices' mean |true SDF|; then 100 steps of the
    reference recipe (hash grid, finite differences, occupancy lookup);
12. ``apps.full_asset.run`` with the mesh stage, two assets in one process
    (25 steps, the fit cut to 200 iterations, NeuS to 300 steps at 192^3):
    each stage's seconds and each asset's launches per stage (generation
    as phase 5, fit K4 219 / K5 200, NeuS none);
13. texture refine of phase 11's 384^3 mesh against its 18 frames at
    512^2 (``meshops.refine.TextureRefiner``, the shipped RefineConfig) for
    as many iterations as fit in 60 s: ms per iteration, the forward
    render's ms, losses, PSNR of four views before and after, peak memory,
    the share of view 0's true silhouette the rasterizer covers, and a
    profile of 3 iterations;
14. ``apps.gs_to_mesh.distill`` from phase 6's gaussians written as a PLY
    (36 views at 256^2, the fit cut to 600 of 1500 steps, 192^3, 500
    refine iterations): stage seconds, launches (K4 36, K5 0), then K4
    against the plain compositor on one of those 256^2 views;
15. the DPT normal predictor at full width from seeded weights written as
    an Omnidata .ckpt: phase 11's 18 frames (inference at 384^2), ms per
    frame, peak memory, one frame against the CPU, then 100 NeuS steps of
    ``reconstruct(..., dpt_weights=...)``;
16. the generation path's other entry points, on phase 5's engine (after
    phase 10): ``img2img_latents`` at strength 0.6 (15 of 25 steps) from
    the latents of phase 5's last frames; the Heun, Euler ancestral,
    DPM++(2S) ancestral, DPM++(2M) and LMS samplers at 8 steps through
    ``sample_latents`` (UNet forwards 15, 8, 15, 8, 8) and, with Euler, on
    a closed-form denoiser, card against CPU; the U2Net matte that
    ``preprocess_image`` takes from a seeded full U2Net .pth in
    ``$V3D_U2NET_CKPT`` (ms per matte, against the CPU's alpha); the
    safety filter with a seeded ViT-L/14 and seeded heads on phase 5's 18
    frames (features against the CPU on 2) and the watermark round trip;
17. ``apps.recon_gs_iterative.train_iterative`` on phase 5's synthetic
    image as a PNG with its own full-width engine (seeded weights), cut
    to 500 iterations with resamples at 300 and 450: seconds per stage,
    ms per fit step, alive count, peak memory, the PLY.

Each path (phases 5, 6, 8, each run of 9, 11, 14, each run of 16, and 17)
is run with the launch counts set to 0 just before it and read just after
(phase 12: each stage's launches, the counters read before and after it);
phases 16 and 17 add theirs to what the JSON line reports for K1-K6.  A
kernel of the path launched
no time, or another number of times than the path needs (counted from the
modules and their routing rules, see ``unet_sites``), fails the run.
Then one JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  No CUDA device: exit 2 at once.  Nothing here imports JAX or
v3d_tpu.

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
from typing import Sequence

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
GS_TS_REL = 1e-5      # K4's checkpoints ts against the plain ones, relative
# phase 8, one fine-tune step with the kernels against reference_mode(), bf16
# compute: the two differ only by bf16 rounding inside the kernels (P and dS
# packed to bf16 by K1/K7/K8, other summation orders)
TRAIN_LOSS_REL = 1e-3     # |loss - loss_plain| <= 1e-3 |loss_plain|
TRAIN_MIN_COS = 0.999     # cosine of each parameter's gradient with the plain one
TRAIN_STEPS = 10          # AdamW steps of phase 8

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
    "group_norm": dict(
        label="K6", source="v3d_tpu_torch/csrc/group_norm.cu",
        replaces="v3d_tpu/ops/fused_groupnorm.py:90 (_pallas_group_norm, T9)"),
    "flash_attn_bwd_dkv": dict(
        label="K7", source="v3d_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                 "(_flash_attention_bwd_dkv, T1-dkv, pallas_call :1121; run "
                 "by v3d_tpu/ops/attention.py:154 under jax.grad)"),
    "flash_attn_bwd_dq": dict(
        label="K8", source="v3d_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
                 "(_flash_attention_bwd_dq, T1-dq, pallas_call :1456; run "
                 "by v3d_tpu/ops/attention.py:154 under jax.grad)"),
    "flash_attn_fwd_wide": dict(
        label="K9", source="v3d_tpu_torch/csrc/flash_attn_fwd_wide.cu",
        replaces="v3d_tpu/ops/flash_attention.py:68 (_flash_forward, T2, at "
                 "d = 80/128/512; also _flash_packed_forward :196, T4)"),
}
# the path whose launches each kernel's JSON entry reports ("routes": the
# generation under set_default_backend("flash"), phase 9)
KERNEL_PATH = {"flash_attn_fwd": "gen", "temporal_block": "gen",
               "temporal_core": "gen", "gs_composite_fwd": "fit",
               "gs_composite_bwd": "fit", "group_norm": "gen",
               "flash_attn_bwd_dkv": "train", "flash_attn_bwd_dq": "train",
               "flash_attn_fwd_wide": "routes"}


# K6's calls in one full-width V3D-512 UNet forward (bf16, the CFG-doubled
# video of 36 frames at 64^2 latents): (B, C, *spatial) of the GroupNorm
# input, fused SiLU, calls.  105 calls, 18 shapes; the list a meta-device
# forward of VideoUNet gives (tests/test_torch_k6_k2_plans.py holds it so).
K6_FORWARD_SHAPES = (
    ((36, 320, 64, 64), False, 5), ((36, 320, 64, 64), True, 8),
    ((36, 640, 32, 32), False, 5), ((36, 640, 32, 32), True, 6),
    ((36, 1280, 16, 16), False, 5), ((36, 1280, 16, 16), True, 6),
    ((36, 1280, 8, 8), False, 1), ((36, 1280, 8, 8), True, 11),
    ((36, 2560, 8, 8), True, 3), ((36, 640, 64, 64), True, 2),
    ((36, 1920, 32, 32), True, 1), ((36, 960, 32, 32), True, 1),
    ((36, 320, 32, 32), True, 1), ((36, 2560, 16, 16), True, 2),
    ((36, 960, 64, 64), True, 1), ((36, 1280, 32, 32), True, 1),
    ((36, 1920, 16, 16), True, 1), ((36, 640, 16, 16), True, 1),
    ((2, 320, 18, 64, 64), True, 10), ((2, 640, 18, 32, 32), True, 10),
    ((2, 1280, 18, 16, 16), True, 10), ((2, 1280, 18, 8, 8), True, 14),
)


class SmokeFailure(RuntimeError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, in ms: each of ``iters`` samples
    times a run of back-to-back calls between two events (enough calls for
    ~2 ms, at most 20), so a short kernel's time is the card's and not the
    host's launch path, which a lone call after a sync would include."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per = max(1, min(20, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def graph_ms(fn, iters: int = 10) -> float:
    """Median CUDA-event time of one call, in ms, replayed from a CUDA graph
    of back-to-back calls (enough for ~2 ms, at most 20): the card's time
    alone.  ``cuda_ms`` of a call whose host path (the Python wrapper, tens
    of us) outlasts its kernels times the host; in a forward the host runs
    ahead of the card, which then pays only the kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per = max(1, min(20, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    del graph
    torch.cuda.empty_cache()
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


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier in a mangled name (a length-prefixed
    source name; the digits before it may run on from the namespace's)."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group(0))):
            name = mangled[m.end():m.end() + int(m.group(0)[i:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                return name
    return mangled


def ptxas_summary(log: str) -> list:
    """'kernel<type>: registers, spill bytes' for each entry function."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            width = re.search(r"ILi(\d+)E", mangled)
            name = _kernel_name(mangled) + (
                "<bf16>" if "bfloat16" in mangled else "<f32>" if "IfE" in mangled
                else "") + (f"<d={width.group(1)}>" if width else "")
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

    results["flash_attn_fwd"] += flash_main_checks(randn)
    # K1: 2-sample slices of ds1 and ds2, the layout the projection gives,
    # both dtypes; library: scaled_dot_product_attention on the same (b, h,
    # s, 64) tensors
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

    results["temporal_block"] = temporal_block_checks(randn)

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops.temporal_attention import temporal_core_plan

    smem = library().v3d_temporal_core_smem(18, 64)
    plan = temporal_core_plan(2, 18, 1024, 10, 64)
    grid = library().v3d_temporal_core_grid(18, 64, plan["items"])
    say("3 kernels", f"K3 bf16 block: {plan['threads']} threads, {smem} B of shared "
        f"memory at t = 18, dh = 64 (plan {plan['smem']}); {grid} blocks (at most "
        f"{plan['max_blocks']}) at ds2 n={plan['items']}")
    if smem != plan["smem"]:
        raise SmokeFailure(f"K3 shared memory {smem} B, temporal_core_plan says "
                           f"{plan['smem']}")
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
    results["flash_attn_fwd_wide"] = wide_checks(randn)
    for name, checks in route_checks(randn).items():
        results[name] += checks
    results["group_norm"] = group_norm_checks(randn)
    results.update(flash_bwd_checks(randn))
    results.update(phase_gs_kernels())
    return results


def _attention_work(b, h, sq, sk, d, size):
    """(FLOPs, bytes) of softmax(q k^T) v: two products; q, k, v read once,
    o written once."""
    return 4 * b * h * sq * sk * d, (2 * b * h * sq * d + 2 * b * h * sk * d) * size


# K1 at the shapes generation launches (the UNet's ds1 / ds2 self-attention,
# b = 36 frames of the CFG-doubled video), then what the "flash" routing also
# sends to K1: one context token (sk = 1) and the ds4 / ds8 self-attention
K1_MAIN_SHAPES = (("ds1", (36, 5, 4096, 4096)), ("ds2", (36, 10, 1024, 1024)),
                  ("flash cross ds1", (36, 5, 4096, 1)),
                  ("flash self ds4", (36, 20, 256, 256)),
                  ("flash self ds8", (36, 20, 64, 64)))
LSE_MAX_ABS = 1e-3       # K1's log-sum-exp against the plain one
WGMMA_MAX_REL = 1e-3     # K1's products alone against torch.matmul in f32


def product_checks(randn, label: str, probe, cases) -> None:
    """``label``'s wgmma products alone (``probe(which, a, b)``, case
    ``which`` of ``cases``: name, a's shape, b's shape, whether b is
    transposed) against torch.matmul on the same bf16 inputs (f32 sums);
    layout faults give errors of O(1)."""
    import torch

    errs = []
    for which, (_, sa, sb, b_t) in enumerate(cases):
        a = randn(*sa).to(torch.bfloat16)
        b = randn(*sb).to(torch.bfloat16)
        got = probe(which, a, b)
        want = a.float() @ (b.float().t() if b_t else b.float())
        errs.append(float((got - want).abs().max()) / float(want.abs().max()))
    ok = max(errs) <= WGMMA_MAX_REL
    say("3 kernels", f"{label} wgmma products alone vs torch.matmul: " + ", ".join(
        f"{case[0]} max_rel {e:.2e}" for case, e in zip(cases, errs))
        + f" (<= {WGMMA_MAX_REL:g}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{label} wgmma products disagree with torch.matmul: {errs}")


def flash_main_checks(randn) -> list:
    """K1 (bf16) at K1_MAIN_SHAPES against its plain version, with its
    log-sum-exp, the bound and SDPA on the same (b, h, s, d) views of (b, s,
    h, d) buffers; before them the products alone and the block's shared
    memory against ``flash_fwd_plan``."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops.attention import (
        flash_attn_fwd,
        flash_attn_fwd_plain,
        flash_fwd_plan,
        wgmma_probe,
    )

    product_checks(randn, "K1", wgmma_probe, (
        ("Q K^T (K-major)", (64, 64), (128, 64), True),
        ("P V (MN-major V)", (64, 128), (128, 64), False)))
    smem = library().v3d_flash_attn_fwd_smem()
    plan = flash_fwd_plan(*K1_MAIN_SHAPES[0][1])
    say("3 kernels", f"K1 bf16 block: {plan['threads']} threads, {smem} B of shared "
        f"memory (plan {plan['smem']}), grid {plan['grid']} at ds1")
    if smem != plan["smem"]:
        raise SmokeFailure(f"K1 shared memory {smem} B, flash_fwd_plan says {plan['smem']}")
    out = []
    for tag, (b, h, sq, sk) in K1_MAIN_SHAPES:
        q, k, v = (randn(b, s, h, 64).to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, sk, sk))
        up = [t_.float() for t_ in (q, k, v)]
        out.append(_check(
            "flash_attn_fwd", f"{tag} {(b, h, sq, 64)} sk={sk}", torch.bfloat16,
            lambda: flash_attn_fwd(q, k, v), lambda: flash_attn_fwd_plain(q, k, v),
            lambda: flash_attn_fwd_plain(*up), _attention_work(b, h, sq, sk, 64, 2),
            lambda: F.scaled_dot_product_attention(q, k, v)))
        _, lse = flash_attn_fwd(q, k, v, with_lse=True)
        _, lse_ref = flash_attn_fwd_plain(*up, with_lse=True)
        err = float((lse - lse_ref).abs().max())
        say("3 kernels", f"K1 {tag} log-sum-exp max_abs {err:.3e} (<= {LSE_MAX_ABS:g}) "
            f"| {'ok' if err <= LSE_MAX_ABS else 'FAIL'}")
        if not err <= LSE_MAX_ABS:
            raise SmokeFailure(f"K1 {tag} log-sum-exp off by {err}")
        out[-1]["lse_max_abs"] = err
        del q, k, v, up, lse, lse_ref
        torch.cuda.empty_cache()
    return out


# K9's shapes in phase 3, (b, sq, sk, h, d): T2's VAE decode under "flash",
# CLIP ViT-H under "packed", d = 128, one key
WIDE_SHAPES = (("T2 VAE decode", (18, 4096, 4096, 1, 512)),
               ("T4 CLIP", (1, 257, 257, 16, 80)),
               ("d128", (4, 1024, 1024, 4, 128)),
               ("sk=1", (18, 4096, 1, 1, 512)))


def wide_checks(randn) -> list:
    """K9 against its plain version at WIDE_SHAPES, q/k/v as (b, h, s, d)
    views of (b, s, h, d) buffers, both dtypes; library:
    scaled_dot_product_attention on the same views.  Before them the bf16
    kernel's products alone at each width against torch.matmul (d = 80's
    128-byte and 32-byte atoms, d = 512's S of 32 k-steps and P V split over
    two warpgroups) and each plan's shared memory against the library's."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops._dispatch import DTYPE_CODES
    from v3d_tpu_torch.ops.flash_attention import (
        WIDE_BF16,
        WIDE_HEAD_DIMS,
        flash_attn_fwd_wide,
        flash_attn_fwd_wide_plain,
        flash_wide_plan,
        flash_wide_probe,
    )

    for d in WIDE_HEAD_DIMS:
        bk = WIDE_BF16[d]["block_k"]
        product_checks(randn, f"K9 d={d}", lambda which, a, b_, d=d: flash_wide_probe(
            d, which, a, b_), (
            (f"Q K^T (K-major{', 64 + 16 columns' if d == 80 else ''}"
             f"{', 32 k-steps of n32' if d == 512 else ''})", (64, d), (bk, d), True),
            (f"P V (MN-major V{', n64 + n16' if d == 80 else ''}"
             f"{', n256 a warpgroup' if d == 512 else ''})", (64, bk), (bk, d), False)))
    for d in WIDE_HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            smem = library().v3d_flash_attn_fwd_wide_smem(DTYPE_CODES[dt], d)
            b, sq, sk, h, _ = WIDE_SHAPES[{512: 0, 80: 1, 128: 2}[d]][1]
            plan = flash_wide_plan(b, h, sq, sk, d, dt)
            say("3 kernels", f"K9 d={d} {str(dt).split('.')[-1]} block: {plan['route']}, "
                f"{plan['threads']} threads, {smem} B of shared memory (plan "
                f"{plan['smem']}), grid {plan['grid']}, {plan['kv_tiles']} key tiles, "
                f"{plan['splits']} split" + (f", boxes {plan['kv_boxes']}"
                                            if dt == torch.bfloat16 else ""))
            if smem != plan["smem"]:
                raise SmokeFailure(f"K9 d={d} {dt} shared memory {smem} B, "
                                   f"flash_wide_plan says {plan['smem']}")
    out = []
    for tag, (b, sq, sk, h, d) in WIDE_SHAPES:
        x32 = [randn(b, s, h, d).transpose(1, 2) for s in (sq, sk, sk)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t_.to(dtype) for t_ in x32)
            up = [t_.float() for t_ in (q, k, v)]
            out.append(_check(
                "flash_attn_fwd_wide", f"{tag} {(b, sq, h, d)} sk={sk}", dtype,
                lambda: flash_attn_fwd_wide(q, k, v),
                lambda: flash_attn_fwd_wide_plain(q, k, v),
                lambda: flash_attn_fwd_wide_plain(*up),
                _attention_work(b, h, sq, sk, d, 4 if dtype == torch.float32 else 2),
                lambda: F.scaled_dot_product_attention(q, k, v)))
            del q, k, v, up
        del x32
        torch.cuda.empty_cache()
    return out


def route_checks(randn) -> dict:
    """The JAX package's other routes onto K1 and K3, through the port's
    public functions on (b, s, h, d) / (B, t, h, d) inputs: T2's bh route
    (``flash_attention``) at ds1, T3 (``heads_resident=True``) and T4
    (``flash_attention_packed``) at ds1 and ds2, each on K1; T5
    (``temporal_attention``) and T6 (``temporal_attention_mxu``) at ds1's
    (8192, 18, 5, 64), each on K3.  Plain: the bshd formula; library:
    scaled_dot_product_attention on the (b, h, s, d) views."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops import flash_attention as fa
    from v3d_tpu_torch.ops import temporal_attention as ta

    res = {"flash_attn_fwd": [], "temporal_core": []}
    routes = [("T2 bh", "ds1", (2, 4096, 5),
               lambda q, k, v: fa.flash_attention(q, k, v, 512, 1024))]
    for tag, shape in (("ds1", (2, 4096, 5)), ("ds2", (2, 1024, 10))):
        routes += [("T3 heads-resident", tag, shape, lambda q, k, v: fa.flash_attention(
                        q, k, v, 512, 1024, heads_resident=True)),
                   ("T4 packed", tag, shape, lambda q, k, v: fa.flash_attention_packed(
                        q, k, v, 512, 1024))]
    batched = [("T5 temporal_attention", ta.temporal_attention),
               ("T6 temporal_attention_mxu", ta.temporal_attention_mxu)]
    for route, tag, (b, s, h), fn in routes:
        x32 = [randn(b, s, h, 64) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t_.to(dtype) for t_ in x32)
            up = [t_.float() for t_ in (q, k, v)]
            res["flash_attn_fwd"].append(_check(
                "flash_attn_fwd", f"{route} {tag} {(b, s, h, 64)}", dtype,
                lambda: fn(q, k, v), lambda: fa.xla_reference_bshd(q, k, v),
                lambda: fa.xla_reference_bshd(*up),
                _attention_work(b, h, s, s, 64, 4 if dtype == torch.float32 else 2),
                lambda: F.scaled_dot_product_attention(
                    *(t_.transpose(1, 2) for t_ in (q, k, v)))))
    big_b, t, h = 8192, 18, 5
    x32 = [randn(big_b, t, h, 64) for _ in range(3)]
    for route, fn in batched:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t_.to(dtype) for t_ in x32)
            up = [t_.float() for t_ in (q, k, v)]
            res["temporal_core"].append(_check(
                "temporal_core", f"{route} {(big_b, t, h, 64)}", dtype,
                lambda: fn(q, k, v), lambda: ta.temporal_attention_packed(q, k, v),
                lambda: ta.temporal_attention_packed(*up),
                _attention_work(big_b, h, t, t, 64, 4 if dtype == torch.float32 else 2),
                lambda: F.scaled_dot_product_attention(
                    *(t_.transpose(1, 2) for t_ in (q, k, v)))))
    return res


def unfused_temporal_layer(x, wq, wk, wv, wo, bo, heads):
    """The temporal layer as the model runs it at the other levels
    (models/video_attention.py): three torch.matmul projections, K3, the
    output projection and the bias.  K2's yardstick: no single PyTorch call
    computes T8."""
    import torch

    from v3d_tpu_torch.ops.temporal_attention import temporal_core

    q, k, v = (torch.matmul(x, w.t()) for w in (wq, wk, wv))
    return torch.matmul(temporal_core(q, k, v, heads), wo.t()) + bo


def _cycle_means(prof, names) -> str:
    """Mean clock64 cycles per block of each phase (blocks that held rows)."""
    p = prof.view(-1, len(names) + 1).double()
    p = p[p[:, -1] > 0]
    means = p[:, :-1].mean(0).tolist()
    total = sum(means)
    return ", ".join(f"{n} {m:,.0f} ({100 * m / total:.1f}%)" for n, m in zip(names, means))


def temporal_block_checks(randn) -> list:
    """K2 (T8) at the ds1 layer, x (2, 18, 4096, 320), 5 heads of 64, f32
    (FMA variant) and bf16 (wgmma + TMA); library column: the unfused route
    (``unfused_temporal_layer``); the bf16 block's plan against
    ``v3d_temporal_block_smem`` and its clock64 phases."""
    import torch

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops._dispatch import DTYPE_CODES
    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
        temporal_block_fwd,
        temporal_block_plan,
    )

    b, t, s, c, heads = 2, 18, 4096, 320, 5
    for dtype in (torch.bfloat16, torch.float32):
        plan = temporal_block_plan(b, t, s, c, heads, 64, dtype)
        smem = library().v3d_temporal_block_smem(DTYPE_CODES[dtype], t, c, heads, 64)
        say("3 kernels", f"K2 {str(dtype).split('.')[-1]} plan at ds1: {plan} | "
            f"v3d_temporal_block_smem {smem} B")
        if smem != plan["smem"]:
            raise SmokeFailure(f"K2 shared memory {smem} B, temporal_block_plan says "
                               f"{plan['smem']}")
    x32 = randn(b, t, s, c)
    w32 = [randn(c, c, scale=c ** -0.5) for _ in range(4)] + [randn(c, scale=0.1)]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        ws = [w.to(dtype) for w in w32]
        up = [x.float()] + [w.float() for w in ws]
        size = 4 if dtype == torch.float32 else 2
        tokens = b * t * s
        out.append(_check(
            "temporal_block", f"ds1 {(b, t, s, c)} h{heads}", dtype,
            lambda: temporal_block_attention(x, *ws, heads),
            lambda: temporal_block_attention_plain(x, *ws, heads),
            lambda: temporal_block_attention_plain(*up, heads),
            (8 * tokens * c * c + 4 * b * s * heads * t * t * 64,
             (2 * tokens * c + 4 * c * c + c) * size),
            lambda: unfused_temporal_layer(x, *ws, heads)))
    plan = temporal_block_plan(b, t, s, c, heads, 64)
    prof = torch.zeros(plan["grid"] * 6, dtype=torch.int64, device=x.device)
    temporal_block_fwd(x, *ws, heads, prof=prof)
    torch.cuda.synchronize()
    say("3 kernels", "K2 bf16 clock64 cycles per block (mean of "
        f"{plan['grid']} blocks): " + _cycle_means(
            prof, ("x wait", "QKV products", "softmax", "out projection", "store")))
    return out


def group_norm_forward_mix(randn) -> list:
    """K6 at every shape of one UNet forward (``K6_FORWARD_SHAPES``), bf16
    with bf16 scale and bias as the model holds them, each against its plain
    version; its plan against ``v3d_group_norm_smem``; then the forward's and
    a generation's summed kernel time against the summed bound."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops.group_norm import (
        group_norm_act_plain,
        group_norm_fwd,
        group_norm_plan,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, total_ms, total_graph, total_bound, launches = [], 0.0, 0.0, 0.0, 0
    for shape, silu, calls in K6_FORWARD_SHAPES:
        B, C = shape[:2]
        L = math.prod(shape[2:])
        plan = group_norm_plan(B, L, C, 32, torch.bfloat16, sms)
        smem = library().v3d_group_norm_smem(1, C, 32, plan["gpc"], plan["rows_per_block"],
                                             plan["splits"])
        if smem != plan["smem"]:
            raise SmokeFailure(f"K6 {shape}: shared memory {smem} B, group_norm_plan "
                               f"says {plan['smem']}")
        fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
        x = (randn(*shape) + 0.3).to(torch.bfloat16).contiguous(memory_format=fmt)
        w = (1 + randn(C, scale=0.1)).to(torch.bfloat16)
        bias = randn(C, scale=0.1).to(torch.bfloat16)
        up = x.float()
        say("3 kernels", f"K6 plan {shape}: {plan['path']}, {plan['launches']} "
            f"launch(es), grid {plan['grid']}, cluster {plan['cluster']}, "
            f"{plan['gpc']} groups a slice, {plan['rows_per_block']} rows a block of "
            f"{plan['row_bytes']} B, smem {smem} B")
        res = _check(
            "group_norm", f"forward {shape}{' +SiLU' if silu else ''}",
            torch.bfloat16,
            lambda: group_norm_fwd(x, w, bias, 32, 1e-5, silu),
            lambda: group_norm_act_plain(x, w, bias, 32, 1e-5, silu),
            lambda: group_norm_act_plain(up, w, bias, 32, 1e-5, silu),
            group_norm_work(shape, silu, 2, 2),
            lambda: F.group_norm(x, 32, w, bias, 1e-5))
        res.update(path=plan["path"],
                   graph_ms=graph_ms(lambda: group_norm_fwd(x, w, bias, 32, 1e-5, silu)))
        say("3 kernels", f"K6 forward {shape}{' +SiLU' if silu else ''}: "
            f"{res['graph_ms']:.4f} ms a call replayed from a CUDA graph, {calls} "
            f"calls a forward (K6_FORWARD_SHAPES)")
        out.append(res)
        total_ms += calls * res["ms"]
        total_graph += calls * res["graph_ms"]
        total_bound += calls * res["bound_ms"]
        launches += calls
        del x, up
    say("3 kernels", f"K6 a UNet forward: {launches} launches (K6_FORWARD_SHAPES, "
        f"the meta-device forward's list; phases 5 and 9 count the path's), summed kernel time "
        f"{total_ms:.4f} ms against a summed bound of {total_bound:.4f} ms "
        f"({100 * total_bound / total_ms:.1f}% of the bound), {total_graph:.4f} ms "
        f"replayed from CUDA graphs ({100 * total_bound / total_graph:.1f}%); 25 "
        f"forwards of a generation: {25 * total_ms:.3f} ms ({25 * total_graph:.3f} "
        f"from graphs) against {25 * total_bound:.3f} ms (the VAE encode's and "
        f"decode's calls not counted)")
    shape = (36, 320, 64, 64)
    plan = group_norm_plan(36, 4096, 320, 32, torch.bfloat16, sms)
    x = (randn(*shape) + 0.3).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.ones(320, device=x.device, dtype=torch.bfloat16)
    prof = torch.zeros(plan["grid"][0] * 4, dtype=torch.int64, device=x.device)
    group_norm_fwd(x, w, w, 32, 1e-5, True, prof=prof)
    torch.cuda.synchronize()
    say("3 kernels", f"K6 one-launch clock64 cycles per block at {shape} (mean of "
        f"{plan['grid'][0]} blocks): " + _cycle_means(
            prof, ("load", "statistics + cluster combine", "normalise + store")))
    return out


def group_norm_work(shape, silu: bool, elem: int, param_elem: int):
    """(FLOPs, bytes) of one K6 call on ``shape``: the statistics and the
    affine (5 an element, 8 with SiLU); x read once, y written once, scale
    and bias read once."""
    n = math.prod(shape)
    return (8 if silu else 5) * n, 2 * n * elem + 2 * shape[1] * param_elem


def group_norm_checks(randn) -> list:
    """K6 (T9) at the UNet's ds1 map (36, 320, 64, 64), a temporal
    GroupNorm's (2, 320, 18, 64, 64) and the VAE decoder's largest (18, 128,
    512, 512), f32 and bf16, with and without SiLU; library:
    F.group_norm on the same tensor; bound: one read of x, scale and bias,
    one write of y.  Then every shape of a UNet forward
    (``group_norm_forward_mix``)."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.group_norm import group_norm_act_plain, group_norm_fwd

    out = []
    for tag, shape in (("unet ds1", (36, 320, 64, 64)),
                       ("temporal", (2, 320, 18, 64, 64)),
                       ("vae decoder", (18, 128, 512, 512))):
        fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
        x32 = (randn(*shape) + 0.3).contiguous(memory_format=fmt)
        c = shape[1]
        w32, b32 = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            up = x.float()
            for silu in (False, True):
                out.append(_check(
                    "group_norm", f"{tag} {shape}{' +SiLU' if silu else ''}", dtype,
                    lambda: group_norm_fwd(x, w32, b32, 32, 1e-5, silu),
                    lambda: group_norm_act_plain(x, w32, b32, 32, 1e-5, silu),
                    lambda: group_norm_act_plain(up, w32, b32, 32, 1e-5, silu),
                    group_norm_work(shape, silu, x.element_size(), 4),
                    lambda: F.group_norm(x, 32, w32.to(dtype), b32.to(dtype), 1e-5)))
            del x, up
        del x32
    return out + group_norm_forward_mix(randn)


# the fine-tune step's spatial self-attention, b = 18 frames
FLASH_BWD_SHAPES = (("ds1", (18, 5, 4096)), ("ds2", (18, 10, 1024)))
# products per (q, k) pair: K8 (S, dP, dQ), K7 (S^T, dP^T, dV, dK), and a
# fused backward (S, dP, dV, dK, dQ), the least the function needs
BWD_PRODUCTS = {"flash_attn_bwd_dq": 3, "flash_attn_bwd_dkv": 4, "fused": 5}


def flash_bwd_work(b, h, s, products):
    """(FLOPs, bytes) of backward work at (b, h, s, 64) self-attention:
    ``products`` 64-deep products of 2 b h s^2 64 FLOP each; six (b, h, s,
    64) bf16 tensors and two f32 row vectors moved once."""
    return products * 2 * b * h * s * s * 64, 6 * b * h * s * 64 * 2 + 2 * b * h * s * 4


def flash_bwd_checks(randn) -> dict:
    """K8 (dq, the row statistics) and K7 (dk, dv) at FLASH_BWD_SHAPES,
    bf16, q/k/v/do as (b, h, s, d) views of (b, s, h, d) buffers, o and lse
    from K1; each against the plain backward on the same inputs (PSNR vs the
    plain result in f32) and timed alone, then the pair through
    ``flash_attn_bwd``; plain: the whole plain backward; library: the
    backward of scaled_dot_product_attention alone (its forward run once
    before).  Bounds (``flash_bwd_work``): K8 three products, K7 four, the
    pair seven, the function five.  Before them K7's products alone and the
    plans against the library's shared memory; at ds1 the clock64 phases."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.kernels.build import library
    from v3d_tpu_torch.ops import attention as A

    product_checks(randn, "K7", A.flash_bwd_wgmma_probe, (
        ("A regs x B K-major", (64, 64), (64, 64), True),
        ("A regs x B MN-major (64 rows)", (64, 64), (64, 64), False)))
    plan = A.flash_bwd_plan(*FLASH_BWD_SHAPES[0][1], FLASH_BWD_SHAPES[0][1][2])
    for which, (label, key) in enumerate((("K8", "dq"), ("K7", "dkv"))):
        smem = library().v3d_flash_attn_bwd_smem(which)
        say("3 kernels", f"{label} block: {plan[key]['threads']} threads, {smem} B of "
            f"shared memory (plan {plan[key]['smem']}), a ring of "
            f"{plan[key]['stages']}, grid {plan[key]['grid']} at ds1")
        if smem != plan[key]["smem"]:
            raise SmokeFailure(f"{label} shared memory {smem} B, flash_bwd_plan says "
                               f"{plan[key]['smem']}")
    res = {"flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    for tag, (b, h, s) in FLASH_BWD_SHAPES:
        q, k, v, do = (randn(b, s, h, 64).to(torch.bfloat16).transpose(1, 2)
                       for _ in range(4))
        o, lse = A.flash_attn_fwd(q, k, v, with_lse=True)
        got = A.flash_attn_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        plain = A.flash_attn_bwd_plain(q, k, v, o, lse, do)
        ref = A.flash_attn_bwd_plain(*(t_.float() for t_ in (q, k, v, o)), lse,
                                     do.float())
        quality = [psnr(g, r) for g, r in zip(got, ref)]
        errs = [float((g.float() - p_.float()).abs().max()) for g, p_ in zip(got, plain)]
        ok = (all(bool(torch.isfinite(g).all()) for g in got)
              and min(quality) >= BF16_MIN_PSNR)
        stats = A.bwd_stats_scratch(b, h, s, q.device)
        dq, dk, dv = (A._like_projection(b, s, h, 64, q) for _ in range(3))
        ms_dq = cuda_ms(lambda: A._bwd_dq(q, k, v, o, lse, do, stats, dq))
        ms_dkv = cuda_ms(lambda: A._bwd_dkv(q, k, v, do, stats, dk, dv))
        pair_ms = cuda_ms(lambda: A.flash_attn_bwd(q, k, v, o, lse, do))
        plain_ms = cuda_ms(lambda: A.flash_attn_bwd_plain(q, k, v, o, lse, do),
                           iters=3, warmup=1)
        ql, kl, vl = (t_.detach().requires_grad_() for t_ in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True))
        bounds = {name: bound_ms(*flash_bwd_work(b, h, s, n), PEAK_BF16)
                  for name, n in BWD_PRODUCTS.items()}
        rows = {"flash_attn_bwd_dq": (ms_dq, errs[0]),
                "flash_attn_bwd_dkv": (ms_dkv, max(errs[1:]))}
        for name, (ms, err) in rows.items():
            bnd, by = bounds[name]
            say("3 kernels", f"{KERNELS[name]['label']} {name} {tag} "
                f"{(b, h, s, 64)} bfloat16: max_abs vs plain {err:.3e} | psnr_vs_f32 "
                f"dq {quality[0]:.2f} dk {quality[1]:.2f} dv {quality[2]:.2f} dB "
                f"(>= {BF16_MIN_PSNR:g}) | kernel {ms:.4f} ms plain (whole "
                f"backward) {plain_ms:.4f} ms library (SDPA backward) "
                f"{library_ms:.4f} ms | bound {bnd:.4f} ms ({by}) | "
                f"{'ok' if ok else 'FAIL'}")
            res[name].append({"shape": f"{tag} {(b, h, s, 64)}", "dtype": "bfloat16",
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bnd, "bound_by": by,
                              "library_ms": library_ms, "psnr_dq_dk_dv": quality,
                              "pair_ms": pair_ms})
        pair_bound = bounds["flash_attn_bwd_dq"][0] + bounds["flash_attn_bwd_dkv"][0]
        say("3 kernels", f"K8 + K7 {tag}: the pair through flash_attn_bwd {pair_ms:.4f} "
            f"ms (alone K8 {ms_dq:.4f} + K7 {ms_dkv:.4f} = {ms_dq + ms_dkv:.4f} ms) | "
            f"SDPA backward {library_ms:.4f} ms ({pair_ms / library_ms:.2f}x) | bound "
            f"of the pair {pair_bound:.4f} ms (7 products, {100 * pair_bound / pair_ms:.1f}%"
            f" reached), of the function {bounds['fused'][0]:.4f} ms (5 products)")
        if not ok:
            raise SmokeFailure(f"flash backward {tag} disagrees: PSNR {quality}")
        if tag == "ds1":
            p = A.flash_bwd_plan(b, h, s, s)
            for label, key, fn, names in (
                    ("K8", "dq", lambda prof: A._bwd_dq(q, k, v, o, lse, do, stats, dq,
                                                        prof=prof),
                     ("prologue (D, Q/dO wait)", "tile wait", "S + dP products, P",
                      "dS", "dQ product", "store")),
                    ("K7", "dkv", lambda prof: A._bwd_dkv(q, k, v, do, stats, dk, dv,
                                                          prof=prof),
                     ("K/V fragments", "tile wait", "S^T + dP^T products, P^T",
                      "dV issue, dS^T", "dK product", "store"))):
                blocks = p[key]["grid"][0] * p[key]["grid"][1]
                prof = torch.zeros(blocks * A.BWD_PROF_SLOTS, dtype=torch.int64,
                                   device=q.device)
                fn(prof)
                torch.cuda.synchronize()
                say("3 kernels", f"{label} clock64 cycles per block at ds1 (consumer "
                    f"warpgroup 0, mean of {blocks} blocks): " + _cycle_means(prof, names))
        del q, k, v, do, o, lse, got, plain, ref, ql, kl, vl, lib_out, stats, dq, dk, dv
        torch.cuda.empty_cache()
    return res


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
    """The (pixel, gaussian) pairs of T10 / T11 on this run's data.
    ``tested``: what a cell-wide sweep tests (T10: per pixel the gaussians
    up to its last composited one when its T fell below 1e-4, else the
    cell's live ones; ``tested_bwd``, T11: those up to the last composited
    one).  ``needed`` / ``needed_bwd``: of those, the pairs of the (tile,
    gaussian) pairs whose exact 1/255 box meets the tile
    (``tile_reach(exact=True)``, ``reach`` of them), the tests these inputs
    need.  ``composited``: the pairs that pass, up to each pixel's last."""
    import torch

    from v3d_tpu_torch.ops.gs_composite import (
        ALPHA_MAX,
        ALPHA_MIN,
        T_EPS,
        tile_pixels,
        tile_reach,
    )

    ts, last, k_stop = saved
    slab, kc = slabs.slab.detach(), slabs.slab.shape[1]
    cell = slabs.cell_of_tile.long()
    t_final = ts.gather(1, k_stop.long()[:, None, None].expand(-1, 1, ts.shape[2]))[:, 0]
    n_live = slabs.live_count.long().clamp(max=kc)[cell][:, None]
    limit = torch.where(t_final < T_EPS, last.long() + 1, n_live)
    out = {"tested": int(limit.sum()), "tested_bwd": int((last.long() + 1).sum()),
           "needed": 0, "needed_bwd": 0, "composited": 0, "reach": 0,
           "ts_rows": int(k_stop.sum())}
    pix_all = tile_pixels(slabs.tile_xy)
    j = torch.arange(kc, device=slab.device)
    for t0 in range(0, pix_all.shape[0], 16):
        pix, sl = pix_all[t0:t0 + 16], slab[cell[t0:t0 + 16]]
        reach = tile_reach(sl, slabs.tile_xy[t0:t0 + 16], exact=True)[:, None, :]
        lst = last[t0:t0 + 16, :, None]
        dx = pix[:, :, None, 0] - sl[:, None, :, 0]
        dy = pix[:, :, None, 1] - sl[:, None, :, 1]
        con = sl[:, None, :, 2:5]
        power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
                 - con[..., 1] * dx * dy)
        alpha = torch.clamp(sl[:, None, :, 8] * torch.exp(power), max=ALPHA_MAX)
        ok = (power <= 0) & (alpha >= ALPHA_MIN) & (j <= lst)
        out["composited"] += int(ok.sum())
        out["reach"] += int(reach.sum())
        out["needed"] += int(((j < limit[t0:t0 + 16, :, None]) & reach).sum())
        out["needed_bwd"] += int(((j <= lst) & reach).sum())
    return out


def gs_checkpoints_mismatch(saved, plain) -> dict:
    """K4's checkpoints (ts, last, k_stop) against
    ``composite_checkpoints_plain`` on the same inputs.  ``near``: pixels
    whose final T on either side lies within 1e-5 relative of 1e-4 (there
    one side may take one more gaussian than the other); outside them
    ``last`` and, at tiles without such a pixel, ``k_stop`` must be equal
    (``last`` / ``k_stop``: the mismatches), and ts[:k_stop] and the final
    T agree within ``ts_rel`` (max relative difference; the bound is
    GS_TS_REL)."""
    import torch

    from v3d_tpu_torch.ops.gs_composite import T_EPS

    (ts, last, k_stop), (ts_p, last_p, k_stop_p) = saved, plain
    rows = torch.arange(len(k_stop), device=ts.device)
    t_fin, t_fin_p = ts[rows, k_stop.long()], ts_p[rows, k_stop_p.long()]
    near = ((t_fin / T_EPS - 1).abs() <= 1e-5) | ((t_fin_p / T_EPS - 1).abs() <= 1e-5)
    upto = (torch.arange(ts.shape[1], device=ts.device)[None]
            < torch.minimum(k_stop, k_stop_p)[:, None])
    keep = upto[:, :, None] & ~near[:, None, :]
    rel = torch.cat([((ts - ts_p).abs() / ts_p.abs())[keep],
                     ((t_fin - t_fin_p).abs() / t_fin_p.abs())[~near]])
    return {"near": int(near.sum()),
            "last": int((last != last_p)[~near].sum()),
            "k_stop": int((k_stop != k_stop_p)[~near.any(1)].sum()),
            "ts_rel": float(rel.max()) if rel.numel() else 0.0}


def k4_forward_check(slabs, phase: str) -> tuple:
    """K4 (T10) against the plain compositor on ``slabs``: rgb / acc / depth,
    the checkpoints K5 reads, the (pixel, gaussian) pairs of this run's data
    (``gs_pairs``), kernel / plain times and the bound.  Raises on a
    disagreement; returns (the check's entry, its inputs, K4's checkpoints,
    the pairs)."""
    import torch

    from v3d_tpu_torch.ops import gs_composite as gc

    args = (slabs.slab.detach().contiguous(), slabs.live_count,
            slabs.cell_of_tile, slabs.tile_xy)
    n_cells, kc, _ = args[0].shape
    n_tiles = args[2].shape[0]
    tag = f"slab {tuple(args[0].shape)} {n_tiles} tiles"
    out, saved = gc.composite_fwd(*args)
    torch.cuda.synchronize()
    ref = gc.composite_plain(*args)
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    ok = (all(bool(torch.isfinite(o).all()) for o in out)
          and max(errs[:2]) <= GS_RGB_ACC_MAX_ABS and errs[2] <= GS_DEPTH_MAX_ABS)
    ckpt = gs_checkpoints_mismatch(saved, gc.composite_checkpoints_plain(*args))
    ok_ckpt = ckpt["last"] == ckpt["k_stop"] == 0 and ckpt["ts_rel"] <= GS_TS_REL
    say(phase, f"K4 checkpoints vs composite_checkpoints_plain: ts max rel "
        f"{ckpt['ts_rel']:.2e} (<= {GS_TS_REL:g}), last / k_stop mismatches "
        f"{ckpt['last']} / {ckpt['k_stop']} (0) outside {ckpt['near']} pixels at "
        f"the 1e-4 stop | {'ok' if ok_ckpt else 'FAIL'}")
    if not ok_ckpt:
        raise SmokeFailure(f"K4's checkpoints disagree with the plain ones: {ckpt}")
    pairs = gs_pairs(slabs, saved)
    fwd_ms = cuda_ms(lambda: gc.composite_fwd(*args))
    plain_ms = cuda_ms(lambda: gc.composite_plain(*args), iters=5, warmup=1)
    bound = bound_ms(
        pairs["needed"] * GS_FLOPS_TEST + pairs["composited"] * GS_FLOPS_FWD,
        n_cells * kc * gc.ATTR * 4 + n_tiles * gc.P * 24
        + (pairs["ts_rows"] + n_tiles) * gc.P * 4 + n_tiles * 16, PEAK_FP32)
    say(phase, f"K4 gs_composite_fwd (T10) {tag} f32: max_abs rgb "
        f"{errs[0]:.3e} acc {errs[1]:.3e} (<= {GS_RGB_ACC_MAX_ABS:g}) depth "
        f"{errs[2]:.3e} (<= {GS_DEPTH_MAX_ABS:g}) | kernel {fwd_ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library none | bound {bound[0]:.4f} "
        f"ms ({bound[1]}) | pairs a cell-wide sweep tests {pairs['tested']:,}, "
        f"needed (exact box) {pairs['needed']:,}, composited {pairs['composited']:,}, "
        f"k_stop rows {pairs['ts_rows']:,} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"gs_composite_fwd disagrees: {errs}")
    entry = {"shape": tag, "dtype": "float32", "library_ms": None, "pairs": pairs,
             "max_abs_err": max(errs), "ms": fwd_ms, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "checkpoints": ckpt}
    return entry, args, saved, pairs


def phase_gs_kernels() -> dict:
    """K4 / K5 (T10 / T11) against the plain compositor at the fit's
    full-width shapes (512^2: 1024 tiles, 16 cells of Kc = 2048)."""
    import torch

    from v3d_tpu_torch.ops import gs_composite as gc

    dev = torch.device("cuda")
    slabs = fit_scene_slabs(dev)
    k4, args, saved, pairs = k4_forward_check(slabs, "3 kernels")
    n_cells, kc, _ = args[0].shape
    n_tiles = args[2].shape[0]
    n_pix = n_tiles * gc.P
    tag = k4["shape"]

    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(shape, device=dev, generator=gen)
           for shape in ((n_tiles, gc.P, 3), (n_tiles, gc.P), (n_tiles, gc.P))]
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

    prof = torch.zeros(n_tiles, gc.FWD_PROF_SLOTS, dtype=torch.int64, device=dev)
    gc.composite_fwd(*args, prof=prof)
    torch.cuda.synchronize()
    cycles = prof[:, :4].double()
    fwd_admitted, fwd_staged = int(prof[:, 4].sum()), int(prof[:, 5].sum())
    say("3 kernels", f"K4 clock64 cycles per tile (the most of its {gc.FWD_SPLIT} "
        f"blocks; {n_tiles} tiles), mean / max: "
        + ", ".join(f"{name} {float(cycles[:, i].mean()):,.0f} / {float(cycles[:, i].max()):,.0f}"
                    for i, name in enumerate(("all", "cull", "walk", "final writes")))
        + f" | (band, gaussian) pairs admitted by the cull {fwd_admitted:,} ((tile, "
        f"gaussian) pairs of the exact 1/255 boxes {pairs['reach']:,}), gaussians staged "
        f"{fwd_staged:,}; pixel tests {fwd_staged * gc.P // gc.FWD_SPLIT:,} (a cell-wide "
        f"sweep {pairs['tested']:,}, needed {pairs['needed']:,})")
    prof = torch.zeros(n_tiles, gc.BWD_PROF_SLOTS, dtype=torch.int64, device=dev)
    gc.composite_bwd(args[0], args[2], args[3], saved, *cot, prof=prof)
    torch.cuda.synchronize()
    cycles = prof[:, :4].double()
    admitted, walked = int(prof[:, 4].sum()), int(prof[:, 5].sum())
    say("3 kernels", f"K5 clock64 cycles per block ({n_tiles} blocks; the longest of "
        f"its groups for the phases), mean / max: "
        + ", ".join(f"{name} {float(cycles[:, i].mean()):,.0f} / {float(cycles[:, i].max()):,.0f}"
                    for i, name in enumerate(("all", "front-to-back sums", "walk", "flush")))
        + f" | (tile, gaussian) pairs admitted by the cull {admitted:,} (exact 1/255 box "
        f"{pairs['reach']:,}), gaussians the groups' first warps walked {walked:,}")
    bwd_ms = cuda_ms(lambda: gc.composite_bwd(args[0], args[2], args[3], saved, *cot))
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out, slab, cot, retain_graph=True), iters=5, warmup=1)
    bwd_bound = bound_ms(
        pairs["needed_bwd"] * GS_FLOPS_TEST + pairs["composited"] * GS_FLOPS_BWD,
        2 * n_cells * kc * gc.ATTR * 4 + n_pix * 24 + pairs["ts_rows"] * gc.P * 4
        + n_tiles * 12, PEAK_FP32)
    say("3 kernels", f"K5 gs_composite_bwd (T11) {tag} f32: per attribute "
        f"max_abs / max|plain| " + " ".join(f"{e / max(sc, 1e-30):.2e}"
                                            for e, sc in rows)
        + f" (<= {GS_GRAD_REL:g}) | kernel {bwd_ms:.4f} ms plain (autograd "
        f"backward) {plain_bwd_ms:.4f} ms library none | bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}) | pairs a cell-wide sweep tests "
        f"{pairs['tested_bwd']:,}, needed (exact box) {pairs['needed_bwd']:,}, "
        f"composited {pairs['composited']:,}; (tile, gaussian) admitted by the cull "
        f"{admitted:,} | {'ok' if ok_bwd else 'FAIL'}")
    if not ok_bwd:
        raise SmokeFailure(f"gs_composite_bwd disagrees: {rows}")
    return {
        "gs_composite_fwd": [dict(k4, cull_admitted=fwd_admitted)],
        "gs_composite_bwd": [{"shape": tag, "dtype": "float32", "library_ms": None,
                              "pairs": pairs, "cull_admitted": admitted,
                              "max_abs_err": max(e for e, _ in rows),
                              "ms": bwd_ms, "plain_ms": plain_bwd_ms,
                              "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}]}


ATTENTION_KERNELS = ("flash_attn_fwd", "flash_attn_fwd_wide")


def unet_sites(unet, hw: int, context_tokens: int = 1, dtype=None) -> dict:
    """What one VideoUNet forward at hw^2 latents (activations in ``dtype``,
    default bf16) launches under the attention routing set now, counted
    from the modules and their own routing rules: each spatial self- and
    cross-attention (on ``context_tokens`` tokens) by
    ``CrossAttention.route`` (K1 or K9, or none; ``k1_grad``: the K1 sites
    whose backward is K8/K7, the "flash_jax" route), temporal
    self-attentions that take K2
    (``TemporalSelfAttention.takes_block``) or else K3, and the GroupNorms
    (K6) inside the blocks that ``use_checkpoint`` recomputes
    (VideoResBlock, SpatialVideoTransformer) and outside them."""
    import torch

    from v3d_tpu_torch.models.layers import Downsample, GroupNorm32, Upsample
    from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from v3d_tpu_torch.models.video_unet import VideoResBlock
    from v3d_tpu_torch.ops.attention import route_kernel

    sites = dict.fromkeys(ATTENTION_KERNELS + ("k1_grad", "temporal_block",
                                               "temporal_core", "gn_blocks",
                                               "gn_other"), 0)
    res = hw
    blocks = list(unet.input_blocks) + [unet.middle_block] + list(unet.output_blocks)
    for layer in [m for block in blocks for m in block] + [unet.out]:
        n_gn = sum(isinstance(m, GroupNorm32) for m in layer.modules())
        if isinstance(layer, (VideoResBlock, SpatialVideoTransformer)):
            sites["gn_blocks"] += n_gn
        else:
            sites["gn_other"] += n_gn
        if isinstance(layer, SpatialVideoTransformer):
            tokens = res * res
            for blk in layer.transformer_blocks:
                for attn, ctx in ((blk.attn1, None), (blk.attn2, context_tokens)):
                    _, route = attn.route(tokens, ctx, dtype or torch.bfloat16, True)
                    kernel = route_kernel(route, attn.dim_head)
                    if kernel:
                        sites[kernel] += 1
                    sites["k1_grad"] += kernel == "flash_attn_fwd" and route == "flash_jax"
            for tb in layer.time_stack:
                fused = tb.attn1.takes_block(tokens)
                sites["temporal_block" if fused else "temporal_core"] += 1
        elif isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
    return sites


def _attention_kernel(sq: int, d: int):
    """The kernel a bf16 ``attention`` self-attention call over sq tokens at
    head width d launches on the card under the routing set now."""
    import torch

    from v3d_tpu_torch.ops.attention import attention_route, route_kernel

    return route_kernel(attention_route(sq, sq, d, torch.bfloat16, True), d)


def vae_sites(vae, tokens: int) -> dict:
    """Attention launches of one VAE encode or decode call: its AttnBlocks
    (V3D: the mid block's, at the latent resolution, ``tokens`` tokens,
    single-head d = channels)."""
    from v3d_tpu_torch.models.vae import AttnBlock

    out = dict.fromkeys(ATTENTION_KERNELS, 0)
    for m in vae.modules():
        kernel = isinstance(m, AttnBlock) and _attention_kernel(tokens, m.q.in_channels)
        if kernel:
            out[kernel] += 1
    return out


def clip_sites(clip) -> dict:
    """Attention launches of one CLIP ViT forward: every residual block's
    self-attention over the patches and the class token."""
    out = dict.fromkeys(ATTENTION_KERNELS, 0)
    tokens = (clip.image_size // clip.conv1.kernel_size[0]) ** 2 + 1
    for blk in clip.transformer.resblocks:
        kernel = _attention_kernel(tokens, clip.conv1.out_channels // blk.attn.heads)
        if kernel:
            out[kernel] += 1
    return out


def count_group_norms(module) -> int:
    from v3d_tpu_torch.models.layers import GroupNorm32

    return sum(isinstance(m, GroupNorm32) for m in module.modules())


def gen_launches(engine, steps: int = 25, hw: int = 64) -> dict:
    """Launches of one generation under the routing set now: ``steps`` UNet
    forwards, one CLIP forward and one VAE encode of the image and one
    decode of all frames; no backward, no 3DGS."""
    u = unet_sites(engine.unet, hw)
    cond = [clip_sites(engine.clip), vae_sites(engine.vae_encoder, hw * hw),
            vae_sites(engine.vae_decoder, hw * hw)]
    out = {name: 0 for name in KERNELS}
    for name in ATTENTION_KERNELS:
        out[name] = steps * u[name] + sum(c[name] for c in cond)
    out.update(temporal_block=steps * u["temporal_block"],
               temporal_core=steps * u["temporal_core"],
               group_norm=steps * (u["gn_blocks"] + u["gn_other"])
               + count_group_norms(engine.vae_encoder)
               + count_group_norms(engine.vae_decoder))
    return out


def forward_launches(unet, hw: int = 64, dtype=None) -> dict:
    """Launches of one UNet forward under the routing set now."""
    u = unet_sites(unet, hw, dtype=dtype)
    out = {name: 0 for name in KERNELS}
    out.update({k: u[k] for k in ATTENTION_KERNELS + ("temporal_block", "temporal_core")},
               group_norm=u["gn_blocks"] + u["gn_other"])
    return out


def train_launches(unet, hw: int = 64, use_checkpoint: bool = True) -> dict:
    """Launches of one fine-tune step: the forward, the blocks' forwards
    once more when checkpointing recomputes them, K8 and K7 once per K1
    site of the "flash_jax" route; K2/K3/K6 and the other attention routes'
    backwards recompute through plain formulas."""
    u = unet_sites(unet, hw)
    r = 2 if use_checkpoint else 1
    out = {name: 0 for name in KERNELS}
    out.update(flash_attn_fwd=r * u["flash_attn_fwd"],
               flash_attn_fwd_wide=r * u["flash_attn_fwd_wide"],
               flash_attn_bwd_dq=u["k1_grad"], flash_attn_bwd_dkv=u["k1_grad"],
               temporal_block=r * u["temporal_block"],
               temporal_core=r * u["temporal_core"],
               group_norm=r * u["gn_blocks"] + u["gn_other"])
    return out


def build_engine(device):
    import torch

    from v3d_tpu_torch.engines.builder import build_v3d_engine

    t0 = time.perf_counter()
    engine = build_v3d_engine(device=device, dtype=torch.bfloat16, seed=0)
    n = sum(p.numel() for p in engine.unet.parameters())
    say("4 unet", f"V3D-512 engine built in {time.perf_counter() - t0:.1f} s "
        f"(seeded N(0, 1/fan_in) weights, bf16); UNet {n:,} parameters")
    return engine


def unet_forward_fn(engine, batch: int = 36, hw: int = 64):
    """A no-grad UNet forward on seeded inputs of the sampling loop's shape
    (a CFG-doubled video of ``batch`` frames at hw^2 latents)."""
    import torch

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

    return fwd


def phase_unet(engine) -> float:
    """One full-width UNet forward with the kernels against the same forward
    with every kernel replaced by its plain version."""
    import torch

    from v3d_tpu_torch.ops import reference_mode

    fwd = unet_forward_fn(engine)
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
    say("4 unet", f"forward {tuple(out.shape)} bf16: kernels vs plain PSNR "
        f"{quality:.2f} dB (>= {UNET_MIN_PSNR:g}), max_abs "
        f"{float((out - ref).abs().max()):.3e}, |ref| max "
        f"{float(ref.abs().max()):.3e} | median ms, in turns: kernels "
        f"{times['kernels']} plain {times['plain']} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"UNet forward with kernels disagrees: {quality} dB")
    profile_steps("4 profile", "UNet forward", fwd, 2, statistics.median(times["kernels"]),
                  TRAIN_KERNEL_CLASSES, FORWARD_OTHER)
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


def phase_generate(engine, requests: int = 2, phase: str = "5 generate") -> dict:
    """The main path through its user entry point, ``requests`` times on one
    engine, under the attention routing set now; each run's launch counts
    must equal the path's."""
    import torch

    from v3d_tpu_torch.apps.generate import sample_one
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    image = synthetic_image()
    expect = gen_launches(engine)
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
        counts_ok = counts == expect
        say(phase, f"request {r}: {wall:.3f} s (cond "
            f"{timings['cond_s']:.3f}, sample {timings['sample_s']:.3f}, "
            f"decode {timings['decode_s']:.3f}) | peak "
            f"{peak:.2f} GiB | frames {frames.shape} {frames.dtype} "
            f"[{frames.min()}, {frames.max()}] std {frames.std():.2f} | "
            f"launches {counts} (expect {expect}) | "
            f"{'ok' if shape_ok and counts_ok else 'FAIL'}")
        if not (shape_ok and counts_ok):
            raise SmokeFailure(f"request {r}: frames {frames.shape}, "
                               f"launches {counts}")
        out = {"launches": counts, "timings": timings, "peak_gib": peak,
               "seconds": wall, "frames": frames}
    return out


# phase 9's attention routings: (name, projection layout, default backend,
# spatial override), each the port's counterpart of a JAX package setting
ROUTE_CONFIGS = (
    ("default", "bhsd", "auto", None),
    ("bshd (r4)", "bshd", "auto", None),
    ("flash", "bhsd", "flash", None),
    ("flash, bshd", "bshd", "flash", None),
    ("packed", "bhsd", "packed", None),
    ("spatial override packed", "bhsd", "auto", "packed"),
)


@contextlib.contextmanager
def routing(layout: str = "bhsd", backend: str = "auto", override=None):
    """Set the three routing setters for the block; restore the defaults."""
    from v3d_tpu_torch.models.attention_blocks import set_proj_layout
    from v3d_tpu_torch.ops.attention import set_default_backend, set_spatial_override

    set_proj_layout(layout)
    set_default_backend(backend)
    set_spatial_override(override)
    try:
        yield
    finally:
        set_proj_layout("bhsd")
        set_default_backend("auto")
        set_spatial_override(None)


def _routed_run(phase: str, what: str, fn, expect: dict) -> dict:
    """``fn`` with the kernels (launches counted) against ``fn`` in
    reference_mode(): exact launches, finite, PSNR >= UNET_MIN_PSNR."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    with reference_mode():
        ref = fn()
    ms = cuda_ms(fn, iters=5, warmup=2)
    quality = psnr(out, ref)
    ok = counts == expect and bool(torch.isfinite(out).all()) and quality >= UNET_MIN_PSNR
    say(phase, f"{what}: launches { {k: v for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in expect.items() if v} }) | kernels vs reference_mode() "
        f"PSNR {quality:.2f} dB (>= {UNET_MIN_PSNR:g}) | {ms:.3f} ms (median of 5) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{what}: launches {counts} (expect {expect}), PSNR {quality}")
    return {"launches": counts, "psnr": quality, "ms": ms}


def phase_routes(engine) -> dict:
    """The JAX package's attention routings on the port: for each of
    ROUTE_CONFIGS one full-width bf16 UNet forward against reference_mode()
    with exact launches per kernel (``unet_sites``); the 18-frame VAE decode
    under "flash" (K9 at d = 512) and CLIP under "packed" (K9 at d = 80);
    then the generation under "flash", twice."""
    import torch

    from v3d_tpu_torch.models.clip_vit import clip_preprocess

    phase = "9 routes"
    t0 = time.perf_counter()
    fwd = unet_forward_fn(engine)
    for name, layout, backend, override in ROUTE_CONFIGS:
        with routing(layout, backend, override):
            _routed_run(phase, f"UNet forward (36, 8, 64, 64), {name} (layout "
                        f"{layout}, backend {backend}, override {override})", fwd,
                        forward_launches(engine.unet))
    dev, t = engine.device, engine.num_frames
    gen = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn(t, 64, 64, 4, device=dev, generator=gen)
    image = torch.rand(1, 512, 512, 3, device=dev, generator=gen) * 2 - 1
    pixels = clip_preprocess(image).permute(0, 3, 1, 2)
    with routing(backend="flash"):
        expect = {name: 0 for name in KERNELS}
        expect.update(vae_sites(engine.vae_decoder, 64 * 64),
                      group_norm=count_group_norms(engine.vae_decoder))
        _routed_run(phase, f"VAE decode of {t} frames, flash", lambda: engine.decode_latents(z, t),
                    expect)
    with routing(backend="packed"):
        expect = {name: 0 for name in KERNELS}
        expect.update(clip_sites(engine.clip))

        def clip():
            with torch.no_grad():
                return engine.clip(pixels)

        _routed_run(phase, "CLIP ViT-H (1, 3, 224, 224), packed", clip, expect)
    with routing(backend="flash"):
        out = phase_generate(engine, 2, phase)
    say(phase, f"phase 9 took {time.perf_counter() - t0:.1f} s")
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
    ("K4 T10 gs_composite_fwd", ("gs_composite_fwd", "gs_reach_table")),
    ("K5 T11 gs_composite_bwd", ("gs_composite_bwd",)),
    ("binning: top-k / sort / scan", ("topk", "sort", "radix", "scan", "bitonic")),
    ("gather / scatter (slab, densify)", ("index", "gather", "scatter")),
    ("SSIM convolution", ("conv", "cudnn", "depthwise", "implicit")),
    ("Adam", ("adam", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("copies / fills", ("memcpy", "memset", "copy", "fill")),
)


TRAIN_KERNEL_CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("K1 flash_attn_fwd", ("flash_fwd",)),
    ("K8 flash_attn_bwd_dq", ("flash_bwd_dq",)),
    ("K7 flash_attn_bwd_dkv", ("flash_bwd_dkv",)),
    ("K2 temporal_block", ("temporal_block",)),
    ("K3 temporal_core", ("temporal_core",)),
    ("K6 group_norm", ("gn_slice", "gn_stats", "gn_norm")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("AdamW + EMA (foreach)", ("adam", "multi_tensor", "foreach", "lerp")),
    ("reductions (plain GN/LN backward, norms)", ("reduce", "norm")),
    # casts are copy kernels; "cast" alone would also take every elementwise
    # kernel on ATen's unrolled path (its LoadWithoutCast / StoreWithCast)
    ("copies / casts / fills", ("memcpy", "memset", "copy", "fill")),
)
NEUS_KERNEL_CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("gathers / scatters (hash grid, samples)", ("index", "gather", "scatter")),
    ("AdamW (foreach)", ("adam", "multi_tensor", "foreach")),
    ("reductions, cumprod, sort", ("reduce", "scan", "sort", "radix", "cumprod")),
    ("copies / fills", ("memcpy", "memset", "copy", "fill")),
)
NEUS_OTHER = "elementwise (encoding, activations, the double backward, losses)"
TRAIN_OTHER = "elementwise (activations, the plain backwards' arithmetic, loss)"
FORWARD_OTHER = "elementwise (activations, norms' affine, residuals, embeddings)"


def phase_profile(trainer, step_ms: float, steps: int = 5) -> None:
    """Where a fit step's time goes: a torch.profiler trace of ``steps``
    steps (device time by kernel class; the device busy share of the traced
    span, and of ``step_ms``, phase 6's step time without the profiler)."""
    for _ in range(2):
        trainer.train_iter()
    profile_steps("7 profile", "fit", trainer.train_iter, steps, step_ms,
                  KERNEL_CLASSES, "elementwise (projection, loss, their backward)")


def _kernel_class(name: str, kernel_classes, other: str) -> str:
    name = name.lower()
    return next((c for c, keys in kernel_classes if any(k in name for k in keys)), other)


def _class_by_origin(prof, cls: str, kernel_classes, other: str) -> dict:
    """Device ms of one kernel class by where its kernels were launched:
    "<autograd node or forward> / <outermost aten op>", e.g. a backward's
    ``aten::to`` (a cast) against a forward's ``aten::contiguous`` (a
    layout copy)."""
    import torch

    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels
                 if _kernel_class(k.name, kernel_classes, other) == cls)
        if not us:
            continue
        op, node, p = e.name, "forward", e.cpu_parent
        while p is not None:
            if p.name.startswith("autograd::engine::evaluate_function:"):
                node = p.name.split("evaluate_function:", 1)[1].strip()
                break
            if p.name.startswith("aten::"):
                op = p.name
            p = p.cpu_parent
        key = f"{node} / {op}"
        out[key] = out.get(key, 0.0) + us / 1e3
    return out


def profile_steps(phase: str, what: str, step_fn, steps: int, step_ms: float,
                  kernel_classes, other: str, split: Sequence[str] = ()) -> None:
    """A torch.profiler trace of ``steps`` calls of ``step_fn``: device time
    by kernel class, the device busy share of the traced span and of
    ``step_ms``, the step time without the profiler; for the classes in
    ``split``, their time by where their kernels were launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans, classes = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        cls = _kernel_class(e.name, kernel_classes, other)
        ms, n = classes.get(cls, (0.0, 0))
        classes[cls] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    if not spans:
        say(phase, "the profiler recorded no device events")
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
    say(phase, f"{steps} {what} steps under the profiler: {1e3 * wall / steps:.3f} "
        f"ms per step (host clock), device busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms span, idle {100 * (1 - busy / span):.1f}% | "
        f"without the profiler: {busy_ms:.3f} ms busy of a {step_ms:.3f} ms "
        f"step, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for cls, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        say(phase, f"  {cls}: {ms / steps:.3f} ms per step "
            f"({100 * ms / total:.1f}%), {n // steps} kernels per step")
    for cls in split:
        origins = _class_by_origin(prof, cls, kernel_classes, other)
        say(phase, f"  {cls} by origin (autograd node / aten op), ms per step:")
        for key, ms in sorted(origins.items(), key=lambda kv: -kv[1])[:12]:
            say(phase, f"    {key}: {ms / steps:.3f}")


def train_grad_check(engine, batch, dev) -> None:
    """One fine-tune step's loss and gradients with the kernels against
    ``reference_mode()`` on the same batch and the same sigmas and noise."""
    import torch

    from v3d_tpu_torch.ops import reference_mode

    unet = engine.unet.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(5)
    latents = batch["latents"]
    sigmas = engine.loss_fn.sigma_sampler(latents.shape[0], device=dev, generator=gen)
    noise = torch.randn(latents.shape, device=dev, generator=gen)
    runs = []
    for mode in (contextlib.nullcontext, reference_mode):
        unet.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        with mode():
            loss = engine.training_loss(latents, batch["cond"], sigmas=sigmas,
                                        noise=noise)
            loss.backward()
        torch.cuda.synchronize()
        runs.append((float(loss.detach()), time.perf_counter() - t0,
                     {k: p.grad for k, p in unet.named_parameters()}))
    unet.zero_grad(set_to_none=True)
    (loss_k, sec_k, gk), (loss_p, sec_p, gp) = runs
    names = list(gp)
    stats = torch.stack([torch.stack([(gk[k].double() * gp[k].double()).sum(),
                                      gk[k].double().norm(), gp[k].double().norm()])
                         for k in names]).tolist()
    cos = {k: (dot / (na * nb) if na * nb > 0 else float(na == nb))
           for k, (dot, na, nb) in zip(names, stats)}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    norm_k = math.sqrt(sum(na * na for _, na, _ in stats))
    norm_p = math.sqrt(sum(nb * nb for _, _, nb in stats))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = (math.isfinite(loss_k) and rel <= TRAIN_LOSS_REL
          and all(c >= TRAIN_MIN_COS for c in cos.values()))
    say("8 train", f"step-1 gradients, kernels vs reference_mode() (same batch, "
        f"sigmas, noise): loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e} <= "
        f"{TRAIN_LOSS_REL:g}) | gradient norm {norm_k:.5e} vs {norm_p:.5e} | "
        f"cosine per parameter tensor: min {worst[0][1]:.6f} (>= {TRAIN_MIN_COS:g}) "
        f"over {len(cos)} tensors, lowest {[(k, round(c, 6)) for k, c in worst]} | "
        f"forward+backward {sec_k:.2f} s vs {sec_p:.2f} s | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"fine-tune gradients disagree: loss {loss_k} {loss_p}, "
                           f"lowest cosines {worst}")


def phase_train(dev) -> dict:
    """The fine-tune path at V3D-512's full width through its entry point,
    ``apps.train_diffusion.train``, after a gradient check; then one step
    without checkpointing (peak memory) and a profile of two steps."""
    import torch

    from v3d_tpu_torch.apps.train_diffusion import (
        batches,
        build_train_engine,
        make_dataset,
        train,
    )
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    t0 = time.perf_counter()
    engine = build_train_engine(device=dev)
    unet, t = engine.unet, engine.num_frames
    n = sum(p.numel() for p in unet.parameters())
    say("8 train", f"V3D-512 training engine built in {time.perf_counter() - t0:.1f} s: "
        f"UNet {n:,} parameters in float32, compute {unet.compute_dtype}, "
        f"use_checkpoint {unet.use_checkpoint}; batch 1 video x {t} frames at 64^2")
    data = batches(engine, make_dataset("synthetic", t, unet.context_dim), 1, t)
    train_grad_check(engine, next(data), dev)

    marks, stats = [], []

    def record(s):
        marks.append(time.perf_counter())
        stats.append(s)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    marks.append(time.perf_counter())
    trainer = train("synthetic", num_frames=t, max_steps=TRAIN_STEPS, engine=engine,
                    log_every=1, log_fn=record)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = train_launches(unet, 64, use_checkpoint=True)
    expect = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = statistics.median(steps_ms[2:])
    losses = [s_["loss"] for s_ in stats]
    ok = (counts == expect and len(stats) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses + [s_["grad_norm"] for s_ in stats]))
    say("8 train", f"train('synthetic') {TRAIN_STEPS} AdamW steps (lr 1e-4, "
        f"LambdaLinear, EMA 0.9999): ms per step (median of steps 3-{TRAIN_STEPS}, "
        f"host clock, each step ends in a sync) {step_ms:.1f}; all "
        f"{[round(x, 1) for x in steps_ms]} | peak {peak:.2f} GiB | loss "
        f"{[round(x, 5) for x in losses]} | grad norm "
        f"{[round(s_['grad_norm'], 4) for s_ in stats]} | launches per step "
        f"{ {k: v / TRAIN_STEPS for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in per_step.items() if v} }) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"fine-tune: launches {counts} (expect {expect}), "
                           f"losses {losses}")

    # the same step without checkpointing, where it fits
    batch = next(batches(engine, make_dataset("synthetic", t, unet.context_dim), 1, t))
    unet.use_checkpoint = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            trainer.train_step(batch["latents"], batch["cond"])
            times.append(1e3 * (time.perf_counter() - t1))
        nock = {"ms": times[-1], "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        want = {k: 2 * v for k, v in train_launches(unet, 64, False).items()}
        nock_ok = dict(LAUNCHES) == want
        say("8 train", f"without checkpointing: step {times[-1]:.1f} ms, peak "
            f"{nock['peak_gib']:.2f} GiB | launches {dict(LAUNCHES)} (expect "
            f"{want}) | {'ok' if nock_ok else 'FAIL'}")
        if not nock_ok:
            raise SmokeFailure(f"fine-tune without checkpointing: launches {dict(LAUNCHES)}")
    except torch.OutOfMemoryError:
        nock = {"ms": None, "peak_gib": None}
        say("8 train", "without checkpointing: the step does not fit on the card")
    unet.use_checkpoint = True
    torch.cuda.empty_cache()
    ab = train_ab(trainer, batch)
    profile_steps("8 profile", "fine-tune", lambda: trainer.train_step(
        batch["latents"], batch["cond"]), 2, step_ms, TRAIN_KERNEL_CLASSES,
        TRAIN_OTHER, split=("copies / casts / fills", TRAIN_OTHER))
    return {"launches": counts, "step_ms": step_ms, "peak_gib": peak,
            "no_checkpoint": nock, "losses": losses, "ab": ab}


def train_ab(trainer, batch) -> dict:
    """The checkpointed fine-tune step with the kernels against the same step
    in ``reference_mode()``, in turns (kernels, plain, kernels, plain): two
    steps a turn, the second timed (host clock; each step ends in a sync),
    and each turn's peak memory."""
    import torch

    from v3d_tpu_torch.ops import reference_mode

    out = {"kernels": [], "plain": [], "peak_kernels": [], "peak_plain": []}
    for name in ("kernels", "plain", "kernels", "plain"):
        torch.cuda.reset_peak_memory_stats()
        with reference_mode() if name == "plain" else contextlib.nullcontext():
            for _ in range(2):
                t0 = time.perf_counter()
                trainer.train_step(batch["latents"], batch["cond"])
                ms = 1e3 * (time.perf_counter() - t0)
        out[name].append(round(ms, 1))
        out[f"peak_{name}"].append(round(torch.cuda.max_memory_allocated() / 2**30, 2))
    say("8 train", f"step ms in turns (kernels, plain, kernels, plain): kernels "
        f"{out['kernels']} plain (reference_mode) {out['plain']}, ratio "
        f"{statistics.mean(out['kernels']) / statistics.mean(out['plain']):.3f} | "
        f"peak GiB kernels {out['peak_kernels']} plain {out['peak_plain']}")
    return out


# ---------------------------------------------------------------------------
# phases 10-12: checkpoint loading, NeuS -> mesh, full_asset

CKPT_MIN_FREE = 6 * 2**30   # bytes a full-width bf16 checkpoint needs, with room


def _ckpt_dir():
    """A temporary directory on a file system with room for a full-width
    checkpoint: $TMPDIR, else the checkout's gitignored build/."""
    import os
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "build")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        say("10 ckpt", f"{base}: {free / 2**30:.1f} GiB free")
        if free >= CKPT_MIN_FREE:
            return tempfile.TemporaryDirectory(dir=base)
    raise SmokeFailure("no file system with room for the checkpoint")


def phase_checkpoint(engine, dev) -> dict:
    """The V3D-512 engine's weights written with the port's safetensors
    writer, loaded into a second engine by ``load_v3d_params``: a UNet
    forward equal bit for bit; then a tiny ``{"state_dict": ...}`` .ckpt
    through ``apps.generate``'s ``--checkpoint``."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from v3d_tpu_torch.apps import generate
    from v3d_tpu_torch.core.checkpoint import load_v3d_params, save_v3d_checkpoint
    from v3d_tpu_torch.engines.builder import build_tiny_engine, build_v3d_engine

    phase = "10 ckpt"
    t0 = time.perf_counter()
    other = build_v3d_engine(device=dev, dtype=torch.bfloat16, seed=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _ckpt_dir() as d:
            path = os.path.join(d, "v3d_512.safetensors")
            t1 = time.perf_counter()
            save_v3d_checkpoint(engine, path)
            write_s, size = time.perf_counter() - t1, os.path.getsize(path)
            t1 = time.perf_counter()
            counts = load_v3d_params(path, other)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t1
            os.remove(path)
        ref, got = unet_forward_fn(engine)(), unet_forward_fn(other)()
        equal = torch.equal(ref, got)
        say(phase, f"V3D-512 bf16 to .safetensors ({size / 2**30:.2f} GiB, "
            f"{sum(counts.values()):,} parameters: "
            + ", ".join(f"{k} {v:,}" for k, v in counts.items())
            + f") written in {write_s:.2f} s, loaded into a second engine by "
            f"load_v3d_params in {load_s:.2f} s (file deleted) | UNet forward "
            f"{tuple(got.shape)} bit for bit equal: {equal} | {'ok' if equal else 'FAIL'}")
        if not equal:
            raise SmokeFailure(f"reloaded UNet differs: max abs "
                               f"{float((got - ref).abs().max())}")
        del other, ref, got
        torch.cuda.empty_cache()
        # a tiny Lightning-style checkpoint through the CLI's --checkpoint
        src = build_tiny_engine(num_frames=4, num_steps=2, device=dev, seed=5)
        with _ckpt_dir() as d:
            path = os.path.join(d, "tiny.ckpt")
            save_v3d_checkpoint(src, path)
            Image.fromarray(synthetic_image(256)).save(os.path.join(d, "in.png"))
            generate.main(["--input", os.path.join(d, "in.png"), "--checkpoint", path,
                           "--tiny", "--num-frames", "4", "--num-steps", "2",
                           "--resolution", "128", "--decoding-t", "4",
                           "--output-folder", os.path.join(d, "gen")])
            out = os.path.join(d, "gen", "000000")
            frames = np.stack([np.asarray(Image.open(os.path.join(out, n)))
                               for n in sorted(os.listdir(out))])
        want, _, _ = generate.sample_one(synthetic_image(256), engine=src,
                                         resolution=128, decoding_t=4)
        same = frames.shape == want.shape and bool((frames == want).all())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    say(phase, f"tiny .ckpt through apps.generate --checkpoint --tiny: frames "
        f"{frames.shape} equal to the source engine's: {same} | "
        f"{'ok' if same else 'FAIL'} | phase 10 took {time.perf_counter() - t0:.1f} s")
    if not same:
        raise SmokeFailure("the CLI's --checkpoint frames differ from the source engine's")
    return {"load_s": load_s, "write_s": write_s}


# phase 11: an analytic scene (a sphere united with a box) on white, its
# orbit views and two held-out views between them
NEUS_MAX_STEPS = 3000    # NeusConfig.max_steps: the shipped schedules
NEUS_STEPS = 600         # steps run
NEUS_REF_STEPS = 100     # steps of the reference recipe on the card
NEUS_MC_RES = 384
SPHERE_C, SPHERE_R = (-0.22, 0.0, 0.05), 0.42
BOX_C, BOX_H = (0.25, 0.05, -0.05), (0.3, 0.25, 0.4)


def scene_sdf(p):
    """(sdf, 0 on the sphere / 1 on the box) of the analytic scene."""
    import torch

    sphere = (p - torch.tensor(SPHERE_C, device=p.device)).norm(dim=-1) - SPHERE_R
    q = (p - torch.tensor(BOX_C, device=p.device)).abs() - torch.tensor(BOX_H, device=p.device)
    box = q.clamp(min=0).norm(dim=-1) + q.amax(-1).clamp(max=0)
    return torch.minimum(sphere, box), (box < sphere).long()


def render_scene(poses, res: int, fov: float = 60.0):
    """Sphere-trace the scene on the card through NeuS's own rays (OpenGL
    poses, pixel-centre directions): per-region colours under a fixed
    light, white background.  -> (images (N, res, res, 3), masks (N, res,
    res)) float32 numpy."""
    import numpy as np
    import torch

    from v3d_tpu_torch.data.cameras import fov2focal, get_ray_directions

    dev = torch.device("cuda")
    dirs = torch.tensor(get_ray_directions(res, res, fov2focal(np.deg2rad(fov), res)),
                        device=dev).reshape(-1, 3)
    colours = torch.tensor([[0.85, 0.35, 0.2], [0.2, 0.45, 0.8]], device=dev)
    light = torch.nn.functional.normalize(torch.tensor([0.4, -0.5, 0.75], device=dev), dim=0)
    images, masks = [], []
    for c2w in poses:
        c2w = torch.tensor(np.asarray(c2w, np.float32), device=dev)
        d = torch.nn.functional.normalize(dirs @ c2w[:3, :3].T, dim=-1)
        o = c2w[:3, 3].expand_as(d)
        t = torch.zeros(d.shape[0], device=dev)
        for _ in range(160):
            s, _ = scene_sdf(o + t[:, None] * d)
            t = t + s.clamp(min=0)
        p = o + t[:, None] * d
        s, region = scene_sdf(p)
        hit = s.abs() < 1e-3
        e = 1e-4
        n = torch.stack([scene_sdf(p + e * torch.eye(3, device=dev)[i])[0]
                         - scene_sdf(p - e * torch.eye(3, device=dev)[i])[0]
                         for i in range(3)], -1)
        n = torch.nn.functional.normalize(n, dim=-1)
        shade = 0.45 + 0.5 * (n @ light).clamp(min=0)
        rgb = torch.where(hit[:, None], colours[region] * shade[:, None], 1.0)
        images.append(rgb.reshape(res, res, 3))
        masks.append(hit.reshape(res, res).float())
    return (torch.stack(images).cpu().numpy().astype(np.float32),
            torch.stack(masks).cpu().numpy())


def _holdout_poses(n: int = 18, radius: float = 2.0):
    """Two OpenGL poses between orbit frames (azimuths 10 and 190 deg)."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import c2w_from_up_and_look_at

    return np.stack([c2w_from_up_and_look_at(
        np.array([0, 0, 1.0]), np.zeros(3),
        radius * np.array([np.cos(a), np.sin(a), 0.0]), opengl=True)
        for a in np.deg2rad([180.0 / n, 180.0 + 180.0 / n])])


def _step_recorder(marks: list, stats: list):
    """A ``log_fn`` for every step: synchronise, stamp, keep the stats."""
    import torch

    def record(s):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        stats.append({k: float(v) for k, v in s.items()})

    return record


def phase_neus() -> dict:
    """``apps.recon_neus.reconstruct`` on the card's recipe at the shipped
    schedules (max_steps 3000), cut to 600 steps, on 18 views of the
    analytic scene at 512^2; holdout PSNR, the export, the mesh against the
    true SDF; then 100 steps of the reference recipe on the card."""
    import math
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch.apps.recon_neus import foreground_masks, neus_config, reconstruct
    from v3d_tpu_torch.data.cameras import (
        fov2focal,
        get_ray_directions,
        get_uniform_poses,
    )
    from v3d_tpu_torch.nerf.system import NeusTrainer
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    phase = "11 neus"
    t_phase = time.perf_counter()
    poses = get_uniform_poses(18, 2.0, 0.0, opengl=True)
    held = _holdout_poses()
    frames, masks = render_scene(np.concatenate([poses, held]), 512)
    frames, hold_rgb, hold_mask = frames[:18], frames[18:], masks[18:]
    fg = foreground_masks(frames)
    say(phase, f"scene: 18 orbit + 2 held-out views at 512^2 rendered in "
        f"{time.perf_counter() - t_phase:.2f} s; foreground share "
        f"{fg.mean():.3f} (near-white threshold) vs true {masks[:18].mean():.3f}")

    marks, stats = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        marks.append(time.perf_counter())
        trainer, mesh, timings = reconstruct(
            frames, out, max_steps=NEUS_MAX_STEPS, train_steps=NEUS_STEPS,
            mc_resolution=NEUS_MC_RES, log_every=1,
            log_fn=_step_recorder(marks, stats), device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {k: v for k, v in LAUNCHES.items() if v}
    steps = [b - a for a, b in zip(marks, marks[1:])]
    step_ms = 1e3 * statistics.median(steps[100:NEUS_STEPS])
    rays = {i: int(stats[i - 1]["num_rays"]) for i in (1, 100, 200, 300, 400, 500, 600)}
    finite = all(math.isfinite(v) for s in stats for v in s.values())
    psnrs = []
    for c2w, rgb, m in zip(held, hold_rgb, hold_mask):
        got, _, _ = trainer.render_image(c2w)
        want = rgb * m[..., None]      # the target the trainer fits: on black
        psnrs.append(-10 * math.log10(float(np.mean((got - want) ** 2))))
    n_v, n_f = len(mesh.vertices), len(mesh.faces)
    true_sdf = (float(scene_sdf(torch.tensor(mesh.vertices, device="cuda"))[0]
                      .abs().mean()) if n_v else float("nan"))
    keys = [k for k in stats[0] if k not in ("loss", "num_rays")]
    say(phase, f"reconstruct, card recipe (frequency + exact gradient, 128x4 "
        f"MLP, 64 coarse + {trainer.cfg.num_samples_per_ray} fine samples, ray "
        f"chunks of {trainer.cfg.ray_chunk}), max_steps {NEUS_MAX_STEPS} cut to "
        f"{NEUS_STEPS}: train {timings['train_s']:.2f} s, ms per step (median of "
        f"steps 101-{NEUS_STEPS}, host clock, synchronised each step) "
        f"{step_ms:.3f} | rays at step {rays} | peak {peak:.2f} GiB | launches "
        f"{launched or 'none'}")
    for i in (1, 100, NEUS_STEPS):
        say(phase, f"  step {i}: loss {stats[i - 1]['loss']:.5f} "
            + " ".join(f"{k} {stats[i - 1][k]:.5f}" for k in keys))
    ok = finite and n_v > 0 and n_f > 0
    say(phase, f"holdout PSNR after {NEUS_STEPS} steps (render_image vs the "
        f"held-out view on black) {psnrs[0]:.2f} / {psnrs[1]:.2f} dB | export "
        f"(sdf_grid + isosurface at {NEUS_MC_RES}^3) {timings['export_s']:.2f} s, "
        f"vertex colours {timings.get('colors_s', 0):.2f} s, obj + glb "
        f"{timings.get('write_s', 0):.2f} s | mesh {n_v} vertices {n_f} faces, "
        f"mean |true SDF| at the vertices {true_sdf:.5f} | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"NeuS: finite losses {finite}, mesh {n_v} x {n_f}")
    profile_steps("11 profile", "NeuS card-recipe", trainer.train_iter, 5, step_ms,
                  NEUS_KERNEL_CLASSES, NEUS_OTHER)
    del trainer
    torch.cuda.empty_cache()

    # the reference recipe on the card: hash grid, finite differences,
    # uniform samples with the occupancy lookup
    cfg = neus_config("cpu", max_steps=NEUS_MAX_STEPS)
    dirs = get_ray_directions(512, 512, fov2focal(np.deg2rad(60.0), 512))
    ref = NeusTrainer(frames, fg, dirs, poses, config=cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    marks, stats = [], []
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ref.train(NEUS_REF_STEPS, log_every=1, log_fn=_step_recorder(marks, stats))
    steps = [b - a for a, b in zip(marks, marks[1:])]
    ref_ms = 1e3 * statistics.median(steps[10:])
    peak_ref = torch.cuda.max_memory_allocated() / 2**30
    finite = all(math.isfinite(v) for s in stats for v in s.values())
    say(phase, f"reference recipe on the card (hash grid 10 levels x 2^19, "
        f"finite differences, 64x1 MLP, {cfg.num_samples_per_ray} uniform "
        f"samples, occupancy lookup): ms per step (median of steps 11-"
        f"{NEUS_REF_STEPS}) {ref_ms:.3f}, first step {1e3 * steps[0]:.1f} | rays "
        f"at step 1 / {NEUS_REF_STEPS} {int(stats[0]['num_rays'])} / "
        f"{int(stats[-1]['num_rays'])} | loss {stats[0]['loss']:.5f} -> "
        f"{stats[-1]['loss']:.5f} | peak {peak_ref:.2f} GiB | "
        f"{'ok' if finite else 'FAIL'}")
    if not finite:
        raise SmokeFailure("NeuS reference recipe: non-finite loss")
    profile_steps("11 profile", "NeuS reference-recipe", ref.train_iter, 3, ref_ms,
                  NEUS_KERNEL_CLASSES, NEUS_OTHER)
    say(phase, f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    del ref
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "psnr": psnrs, "export_s": timings["export_s"],
            "frames": frames, "masks": masks[:18], "mesh": mesh}


FULL_GS_ITERS, FULL_NEUS_STEPS, FULL_MC_RES = 200, 300, 192


def phase_full_asset(gen_expect: dict) -> dict:
    """``apps.full_asset.run`` with the mesh stage, two assets in one
    process on the synthetic image: each asset's stage seconds and, per
    stage, the launches of the generation (``gen_expect``), of the fit
    (K4 219: a step's 200, the orbit's 18 and the default log's render of
    view 0 after the last iteration; K5 200) and of NeuS (none)."""
    import tempfile

    from v3d_tpu_torch.apps.full_asset import run

    phase = "12 full_asset"
    t0 = time.perf_counter()
    fit = {"gs_composite_fwd": FULL_GS_ITERS + 18 + 1, "gs_composite_bwd": FULL_GS_ITERS}
    expect = {"generate": {k: v for k, v in gen_expect.items() if v},
              "gs_fit": fit, "neus": {}}
    with tempfile.TemporaryDirectory() as out:
        report = run(synthetic_image(), out, gs_iters=FULL_GS_ITERS,
                     neus_steps=FULL_NEUS_STEPS, mesh=True, num_steps=25,
                     mc_resolution=FULL_MC_RES, assets=2, device="cuda")
    ok = len(report["assets"]) == 2
    for i, a in enumerate(report["assets"]):
        launches_ok = a["launches"] == expect
        ok = ok and launches_ok
        say(phase, f"asset {i}: generate {a['generate_18view_512']:.2f} s, 3DGS "
            f"fit ({FULL_GS_ITERS} iterations) {a[f'gs_fit_{FULL_GS_ITERS}']:.2f} s, "
            f"NeuS ({FULL_NEUS_STEPS} steps) + mesh at {FULL_MC_RES}^3 "
            f"{a['neus_fit_mesh']:.2f} s (mesh {a['mesh']}), total "
            f"{a['asset_total_s']:.2f} s | launches {a['launches']} (expect "
            f"{expect}) | {'ok' if launches_ok else 'FAIL'}")
    say(phase, f"per asset, amortised (asset 2): {report['per_asset_amortized_s']:.2f} s; "
        f"both {report['total_s']:.2f} s | phase 12 took {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise SmokeFailure(f"full_asset: {report['assets']}")
    return report


REFINE_ITERS = 2000        # apps/refine.py's default, cut to REFINE_BUDGET_S
REFINE_BUDGET_S = 60.0
REFINE_PSNR_VIEWS = (0, 5, 11, 17)
REFINE_KERNEL_CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("sort / scan (the candidate lists)", ("sort", "radix", "scan", "cub")),
    ("gathers / scatters (candidates, attributes)", ("index", "gather", "scatter")),
    ("reductions, argmin / argmax", ("reduce", "arg")),
    ("Adam", ("adam", "multi_tensor", "foreach")),
    ("copies / fills", ("memcpy", "memset", "copy", "fill")),
)
REFINE_OTHER = "elementwise (edge functions, barycentrics, coverage, their backward)"


def phase_refine(neus: dict, dev="cuda") -> dict:
    """``meshops.refine.TextureRefiner`` at the shipped RefineConfig (16
    views, lr 1e-3, max_per_tile 256, tile_chunk 16) on phase 11's exported
    384^3 mesh and its 18 orbit frames at 512^2: as many iterations of
    ``run`` as fit in REFINE_BUDGET_S (not apps/refine.py's 2000), each
    timed (synchronised); the forward render's time; PSNR of four views
    before and after; the share of view 0's true silhouette the
    rasterizer's ``mask`` covers; a profile of 3 iterations."""
    import numpy as np
    import torch

    from v3d_tpu_torch.meshops.rasterize import verts_to_clip
    from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner

    phase = "13 refine"
    if not neus:
        raise SmokeFailure("phase 13 refines phase 11's mesh: run phase 11 too")
    mesh, frames = neus["mesh"], neus["frames"]
    t_phase = time.perf_counter()
    cfg = RefineConfig()
    refiner = TextureRefiner(mesh, frames, cfg, device=dev)
    targets = torch.tensor(frames, device=dev)

    @torch.no_grad()
    def view_psnrs():
        return [psnr(refiner.render(refiner.logits, v)[0], targets[v])
                for v in REFINE_PSNR_VIEWS]

    with torch.no_grad():
        render_ms = cuda_ms(lambda: refiner.render(refiner.logits, 0), iters=5)
        out = refiner.raster(verts_to_clip(refiner.verts, refiner.mvps[0]),
                             refiner.faces, torch.sigmoid(refiner.logits))
        sil = torch.tensor(neus["masks"][0] > 0.5, device=dev)
        covered = float((out.mask & sil).sum()) / float(sil.sum())
        outside = float((out.mask & ~sil).sum()) / float(sil.sum())
    before = view_psnrs()

    stamps = []
    step = refiner.step

    def timed_step(slot):
        loss = step(slot)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return loss

    refiner.step = timed_step
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    refiner.run(3)                                   # warm-up
    warm = [b - a for a, b in zip(stamps, stamps[1:])]
    iters = max(10, min(REFINE_ITERS, int(REFINE_BUDGET_S / statistics.median(warm[1:]))))
    torch.cuda.reset_peak_memory_stats()
    stamps.clear()
    stamps.append(time.perf_counter())
    losses = refiner.run(iters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_ms = 1e3 * statistics.median(steps)
    after = view_psnrs()
    refiner.step = step
    ok = (all(map(math.isfinite, losses + before + after))
          and statistics.mean(after) > statistics.mean(before))
    say(phase, f"mesh {len(mesh.vertices)} vertices {len(mesh.faces)} faces, 18 "
        f"frames at {frames.shape[1]}^2, RefineConfig() (16 views, lr {cfg.lr:g}, "
        f"max_per_tile {cfg.max_per_tile}, tile_chunk {cfg.tile_chunk}) | forward "
        f"render {render_ms:.3f} ms | view 0: the rasterizer's mask covers "
        f"{100 * covered:.2f}% of the true silhouette (and {100 * outside:.2f}% of it "
        f"outside)")
    say(phase, f"run: {iters} iterations (apps/refine.py's {REFINE_ITERS} cut to "
        f"{REFINE_BUDGET_S:g} s; warm-up 3: {', '.join(f'{1e3 * w:.1f}' for w in warm)} "
        f"ms), ms per iteration (median, host clock, synchronised) {step_ms:.3f}, "
        f"total {sum(steps):.2f} s | loss {losses[0]:.6f} -> {losses[-1]:.6f} | PSNR "
        f"of views {REFINE_PSNR_VIEWS} before "
        + " / ".join(f"{p:.2f}" for p in before) + " dB, after "
        + " / ".join(f"{p:.2f}" for p in after) + f" dB | peak {peak:.2f} GiB | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"refine: losses {losses[:1]} {losses[-1:]}, PSNR {before} {after}")
    rs = np.random.RandomState(1)
    profile_steps("13 profile", "refine", lambda: refiner.step(int(rs.randint(16))), 3,
                  step_ms, REFINE_KERNEL_CLASSES, REFINE_OTHER)
    say(phase, f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "iters": iters, "covered": covered}


GS_MESH_VIEWS, GS_MESH_RES = 36, 256       # apps/gs_to_mesh.py's defaults
# the CLI's 1500 fit steps cut to 600 (1500 steps took 80 s of a 154 s
# phase on the H100), its 500 refine iterations kept
GS_MESH_FIT_STEPS, GS_MESH_REFINE_ITERS = 600, 500


def phase_gs_to_mesh(g_np, dev="cuda") -> dict:
    """``apps.gs_to_mesh.distill`` at the CLI's defaults (36 views at 256^2,
    fit steps of 4096 rays, 192^3, 500 refine iterations; the fit cut to
    GS_MESH_FIT_STEPS of 1500) from the
    gaussians of phase 6's fit written as a PLY, with the launch counts set
    to 0 just before it: K4 once per view, K5 never; then K4 against the
    plain compositor on view 0's slabs at 256^2."""
    import os
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch.apps.gs_to_mesh import distill, load_gaussians, sh_degree
    from v3d_tpu_torch.data.cameras import Camera, get_uniform_poses
    from v3d_tpu_torch.gs.ply import save_ply
    from v3d_tpu_torch.gs.render import RasterizeConfig, build_slabs, project_gaussians
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    phase = "14 gs_to_mesh"
    if g_np is None:
        raise SmokeFailure("phase 14 distils phase 6's gaussians: run phase 6 too")
    with tempfile.TemporaryDirectory() as out:
        ply = os.path.join(out, "point_cloud.ply")
        save_ply(ply, g_np)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        mesh, tm = distill(ply, os.path.join(out, "mesh"), n_views=GS_MESH_VIEWS,
                           resolution=GS_MESH_RES, fit_steps=GS_MESH_FIT_STEPS,
                           refine_iters=GS_MESH_REFINE_ITERS, device=dev)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        mesh_dir = os.path.join(out, "mesh")
        files = sorted(os.listdir(mesh_dir)) if os.path.isdir(mesh_dir) else []
        g = load_gaussians(ply, dev)
    expect = {name: 0 for name in KERNELS}
    expect["gs_composite_fwd"] = GS_MESH_VIEWS
    ok = (counts == expect and len(mesh.faces) > 0 and files == ["mesh.glb", "mesh.obj"]
          and mesh.vertex_colors is not None and bool(np.isfinite(mesh.vertex_colors).all()))
    say(phase, f"distill from {int(g_np['alive'].sum())} gaussians: {GS_MESH_VIEWS} "
        f"views at {GS_MESH_RES}^2 rendered in {tm['render_s']:.2f} s | fit "
        f"{GS_MESH_FIT_STEPS} steps of 4096 rays x 192 samples {tm['fit_s']:.2f} s, "
        f"{1e3 * tm['fit_s'] / GS_MESH_FIT_STEPS:.3f} ms per step | isosurface at "
        f"192^3 {tm['isosurface_s']:.2f} s | refine {GS_MESH_REFINE_ITERS} iterations "
        f"{tm.get('refine_s', float('nan')):.2f} s | write {tm.get('write_s', float('nan')):.2f} "
        f"s | total {tm['total_s']:.2f} s | mesh {len(mesh.vertices)} vertices "
        f"{len(mesh.faces)} faces | peak {peak:.2f} GiB | launches {counts} (expect "
        f"{expect}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"gs_to_mesh: launches {counts}, mesh {len(mesh.faces)} "
                           f"faces, files {files}")
    cam = Camera.from_c2w(get_uniform_poses(GS_MESH_VIEWS, 2.0, 0.0)[0], 60.0,
                          GS_MESH_RES, GS_MESH_RES)
    with torch.no_grad():
        slabs = build_slabs(project_gaussians(g, cam, sh_degree(g)), GS_MESH_RES,
                            GS_MESH_RES, RasterizeConfig())
    check, *_ = k4_forward_check(slabs, phase)
    check["launches_gs_to_mesh"] = counts["gs_composite_fwd"]
    return {"launches": counts, "check": check, "timings": tm}


DPT_STEPS = 100          # NeuS steps with the DPT normals
DPT_MC_RES = 128         # their export (not the shipped 384^3: phase 11 times that)
DPT_CPU_MAX_ABS = 1e-3   # one frame's normals on the card against the CPU


def phase_dpt(neus: dict, dev="cuda") -> dict:
    """The DPT normal predictor at full width (ResNetV2-(3,4,9) + ViT-B/16)
    from seeded weights written as an Omnidata-layout .ckpt, loaded by
    ``load_dpt_normal_predictor`` on the card: phase 11's 18 frames at 512^2
    (inference at 384^2, batches of 6), ms per frame, peak memory, one frame
    against the same predictor on the CPU; then ``reconstruct(...,
    dpt_weights=...)`` for DPT_STEPS steps."""
    import os
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch.apps.recon_neus import reconstruct
    from v3d_tpu_torch.models.dpt import DPT
    from v3d_tpu_torch.nerf.normals import load_dpt_normal_predictor

    phase = "15 dpt"
    if not neus:
        raise SmokeFailure("phase 15 predicts phase 11's frames: run phase 11 too")
    frames = neus["frames"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "omnidata_dpt_normal_v2.ckpt")
        sd = DPT(num_channels=3).init_(torch.Generator().manual_seed(0)).state_dict()
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, path)
        n_params = sum(v.numel() for v in sd.values())
        del sd
        t0 = time.perf_counter()
        predict = load_dpt_normal_predictor(path, device=dev)
        load_s = time.perf_counter() - t0
        predict(frames[:6])                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        normals = predict(frames)
        torch.cuda.synchronize()
        ms_frame = 1e3 * (time.perf_counter() - t0) / len(frames)
        peak = torch.cuda.max_memory_allocated() / 2**30
        cpu = load_dpt_normal_predictor(path, device="cpu")(frames[:1])
        err = float(np.abs(normals[0] - cpu[0]).max())
        del predict
        torch.cuda.empty_cache()
        ok = (normals.shape == frames.shape and bool(np.isfinite(normals).all())
              and err <= DPT_CPU_MAX_ABS)
        say(phase, f"DPT ({n_params:,} parameters, seeded) from a {os.path.getsize(path) / 2**20:.0f} "
            f"MiB .ckpt loaded in {load_s:.2f} s | {len(frames)} frames at "
            f"{frames.shape[1]}^2, inference at 384^2 in batches of 6: "
            f"{ms_frame:.3f} ms per frame (host clock, synchronised) | peak "
            f"{peak:.2f} GiB | normals mean {float(normals.mean()):.4f} | frame 0 "
            f"vs the CPU: max abs {err:.2e} (<= {DPT_CPU_MAX_ABS:g}) | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"DPT normals: shape {normals.shape}, CPU max abs {err}")
        marks, stats = [], []
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            marks.append(t0)
            trainer, mesh, timings = reconstruct(
                frames, out, max_steps=NEUS_MAX_STEPS, train_steps=DPT_STEPS,
                mc_resolution=DPT_MC_RES, dpt_weights=path, log_every=1,
                log_fn=_step_recorder(marks, stats), device=dev)
            wall = time.perf_counter() - t0
    finite = all(math.isfinite(v) for s_ in stats for v in s_.values())
    steps = [b - a for a, b in zip(marks, marks[1:])]
    lam = trainer.cfg.lambda_normal
    keys = [k for k in stats[0] if "normal" in k]
    ok = finite and lam == 1.0 and len(stats) == DPT_STEPS
    say(phase, f"reconstruct(dpt_weights=...) {DPT_STEPS} steps (max_steps "
        f"{NEUS_MAX_STEPS}), export at {DPT_MC_RES}^3: {wall:.2f} s, ms per step "
        f"(median of steps 11-{DPT_STEPS}) {1e3 * statistics.median(steps[10:]):.3f} | "
        f"lambda_normal {lam:g} | loss {stats[0]['loss']:.5f} -> {stats[-1]['loss']:.5f} "
        + " ".join(f"{k} {stats[0][k]:.5f} -> {stats[-1][k]:.5f}" for k in keys)
        + f" | mesh {len(mesh.vertices)} vertices | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"DPT NeuS: finite {finite}, lambda_normal {lam}, "
                           f"{len(stats)} steps")
    say(phase, f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return {"ms_per_frame": ms_frame}


# phases 16-17: the generation path's other entry points
IMG2IMG_STRENGTH = 0.6        # 15 of 25 steps
SAMPLER_STEPS = 8             # each of the five other samplers (cut from 25)
SAMPLER_FORWARDS = {"HeunEDMSampler": 2 * SAMPLER_STEPS - 1,
                    "EulerAncestralSampler": SAMPLER_STEPS,
                    "DPMPP2SAncestralSampler": 2 * SAMPLER_STEPS - 1,
                    "DPMPP2MSampler": SAMPLER_STEPS,
                    "LinearMultistepSampler": SAMPLER_STEPS}
SAMPLER_CPU_MAX_REL = 1e-5    # closed-form denoiser, card vs CPU, same draws
U2NET_CPU_MAX_ALPHA = 1       # of 255: the card's matte vs the CPU's
SAFETY_CPU_MAX_ABS = 1e-3     # ViT-L/14 features, card vs CPU (2 frames)
SAFETY_CPU_FRAMES = 2
# the JAX CLI's 4000 / 1000 / 500 cut to two resamples before the fit's first
# densify event (iteration 600): at 1000 / 400 / 250 the seeded engine's
# noise frames let every gaussian be pruned by then (ROADMAP C12)
ITER_ITERS, ITER_START, ITER_PERIOD = 500, 200, 150


def _scaled(launches: dict, n: int) -> dict:
    return {k: n * v for k, v in launches.items()}


def _summed(*launches: dict) -> dict:
    out = {name: 0 for name in KERNELS}
    for d in launches:
        for k, v in d.items():
            out[k] += v
    return out


def _counted(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after; (result, counts, seconds)."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES), time.perf_counter() - t0


def phase_gen_entry_points(engine, gen: dict) -> dict:
    """The generation path's other entry points on phase 5's engine:
    img2img from the latents of phase 5's last frames, the five other
    samplers (UNet forwards and launches exact; each also against the CPU on
    a closed-form denoiser), the U2Net matte inside ``preprocess_image`` from
    a seeded full U2Net .pth, and the safety filter and watermark with a
    seeded ViT-L/14 and seeded heads."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch import diffusion as D
    from v3d_tpu_torch.data import preprocess
    from v3d_tpu_torch.engines.video_diffusion import img2img_latents

    phase = "16 gen entry points"
    if "frames" not in gen:
        raise SmokeFailure("phase 16 starts from phase 5's frames: run phase 5 too")
    t_phase = time.perf_counter()
    dev, t = engine.device, engine.num_frames
    per_fwd = forward_launches(engine.unet)
    launches = {name: 0 for name in KERNELS}
    gen_rng = torch.Generator(device=dev).manual_seed(16)
    res = gen["frames"].shape[1]
    image = preprocess.preprocess_image(synthetic_image(), resolution=res, device=dev)
    clip_emb, cond = engine.encode_image(torch.from_numpy(image)[None], 0.02,
                                         generator=gen_rng)
    c, uc = engine.build_cond(clip_emb, cond, 1, 300, 0.02)
    frames = torch.from_numpy(gen["frames"]).to(dev).float() / 127.5 - 1
    z0 = engine.encode_first_stage(frames, generator=gen_rng)

    # (a) img2img at strength 0.6: round(25 * 0.6) = 15 forwards
    run_steps = round(engine.sampler.num_steps * IMG2IMG_STRENGTH)
    z, counts, secs = _counted(lambda: img2img_latents(
        engine, z0, c, uc, IMG2IMG_STRENGTH, generator=gen_rng))
    expect = _scaled(per_fwd, run_steps)
    ok = counts == expect and bool(torch.isfinite(z).all()) and not torch.equal(z, z0)
    say(phase, f"img2img_latents strength {IMG2IMG_STRENGTH} of "
        f"{engine.sampler.num_steps} steps ({run_steps} run) from phase 5's last "
        f"frames' latents {tuple(z0.shape)}: {secs:.3f} s | max |out - init| "
        f"{float((z - z0).abs().max()):.3f} | launches { {k: v for k, v in counts.items() if v} } "
        f"(expect { {k: v for k, v in expect.items() if v} }) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"img2img: launches {counts}, finite {bool(torch.isfinite(z).all())}")
    launches = _summed(launches, counts)

    # (b) the five other samplers through the engine, then each sampler and
    # Euler on a closed-form denoiser, card against CPU
    noise = torch.randn(z0.shape, device=dev, generator=gen_rng)
    for name, forwards in SAMPLER_FORWARDS.items():
        sampler = getattr(D, name)(discretization=engine.sampler.discretization,
                                   num_steps=SAMPLER_STEPS, guider=engine.sampler.guider)
        if name == "LinearMultistepSampler":  # its host table, scipy's import included
            t0 = time.perf_counter()
            sampler.coeff_table(sampler.schedule())
            say(phase, f"LMS coefficient table (scipy quad on the host, first call): "
                f"{time.perf_counter() - t0:.3f} s")
        eng = dataclasses.replace(engine, sampler=sampler)
        out, counts, secs = _counted(lambda: eng.sample_latents(
            c, uc, res, res, noise=noise, generator=gen_rng))
        expect = _scaled(per_fwd, forwards)
        ok = counts == expect and bool(torch.isfinite(out).all())
        say(phase, f"{name} {SAMPLER_STEPS} steps through sample_latents: {secs:.3f} s, "
            f"{forwards} UNet forwards | launches { {k: v for k, v in counts.items() if v} } "
            f"(expect { {k: v for k, v in expect.items() if v} }) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"{name}: launches {counts}")
        launches = _summed(launches, counts)
    cpu_gen = torch.Generator().manual_seed(17)
    x_cpu = torch.randn(z0.shape, generator=cpu_gen)
    draws = [torch.randn(z0.shape, generator=cpu_gen) for _ in range(SAMPLER_STEPS)]

    def closed_form(x, s, cond):
        return x / (1.0 + s[:, None, None, None] ** 2)

    rows = []
    for name in ["EulerEDMSampler"] + list(SAMPLER_FORWARDS):
        sampler = getattr(D, name)(discretization=engine.sampler.discretization,
                                   num_steps=SAMPLER_STEPS)
        ref = sampler(closed_form, x_cpu, {}, noises=draws)
        got = sampler(closed_form, x_cpu.to(dev), {}, noises=[d.to(dev) for d in draws])
        rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
        rows.append((name, rel))
    ok = all(r <= SAMPLER_CPU_MAX_REL for _, r in rows)
    say(phase, "closed-form denoiser x / (1 + s^2), card vs CPU, same draws, max rel: "
        + ", ".join(f"{n} {r:.2e}" for n, r in rows)
        + f" (<= {SAMPLER_CPU_MAX_REL:g}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"samplers card vs CPU: {rows}")

    # (c) U2Net: a seeded full model in U-2-Net's naming on disk
    from torch import nn

    from v3d_tpu_torch.models.u2net import U2Net, load_u2net

    torch.manual_seed(16)
    u2 = U2Net(small=False)
    with torch.no_grad():
        for m in u2.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n))
                m.bias.copy_(0.1 * torch.randn(n))
                m.running_mean.copy_(0.1 * torch.randn(n))
                m.running_var.copy_(0.5 + torch.rand(n))
    n_params = sum(p.numel() for p in u2.parameters())
    rgb = synthetic_image()[..., :3]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "u2net.pth")
        torch.save(u2.state_dict(), path)
        del u2
        os.environ["V3D_U2NET_CKPT"] = path
        preprocess._DEFAULT_MATTE.clear()
        try:
            torch.cuda.reset_peak_memory_stats()
            img = preprocess.preprocess_image(synthetic_image(), ignore_alpha=True,
                                              device=dev)
            remove_bg = preprocess.default_remove_bg(dev)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rgba = remove_bg(rgb)
                times.append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated() / 2**30
            cpu_rgba = load_u2net(path, device="cpu")(rgb)
        finally:
            del os.environ["V3D_U2NET_CKPT"]
            preprocess._DEFAULT_MATTE.clear()
    diff = int(np.abs(rgba[..., 3].astype(int) - cpu_rgba[..., 3].astype(int)).max())
    ok = (remove_bg is not None and img.shape == (512, 512, 3) and bool(np.isfinite(img).all())
          and diff <= U2NET_CPU_MAX_ALPHA)
    say(phase, f"U2Net (full, {n_params:,} parameters, seeded) from $V3D_U2NET_CKPT: "
        f"preprocess_image(ignore_alpha=True) mattes with it on the card; matte of a "
        f"512^2 image (inference at 320^2) {statistics.median(times):.3f} ms (median of "
        f"5, host clock, synchronised) | peak {peak:.2f} GiB | alpha [{rgba[..., 3].min()}, "
        f"{rgba[..., 3].max()}] vs the CPU's max diff {diff} (<= {U2NET_CPU_MAX_ALPHA}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"U2Net matte: alpha differs by {diff} from the CPU's")

    # (d) the safety filter (seeded ViT-L/14 and heads) and the watermark
    from v3d_tpu_torch.engines.builder import seeded_init_
    from v3d_tpu_torch.models.clip_vit import CLIPVisionTransformer
    from v3d_tpu_torch.utils import safety

    with torch.device("meta"):
        vit = CLIPVisionTransformer(**safety.VIT_L_CONFIG)
    vit = seeded_init_(vit.to_empty(device=dev), 16).eval().requires_grad_(False)
    vit_cpu = CLIPVisionTransformer(**safety.VIT_L_CONFIG).eval().requires_grad_(False)
    vit_cpu.load_state_dict(vit.state_dict())
    images = gen["frames"].astype(np.float32) / 255.0
    rs = np.random.RandomState(16)
    # seeded head weights; biases set between sorted logits of these frames
    # so that some frames are flagged (p: 9 of 18) and the blur runs
    logits = safety.DeepFloydDataFiltering(clip=vit).features(images)
    with tempfile.TemporaryDirectory() as d:
        for head, keep in (("p_head_v1.npz", len(images) // 2), ("w_head_v1.npz", len(images) - 1)):
            w = rs.randn(safety.VIT_L_CONFIG["output_dim"]).astype(np.float32)
            z = np.sort(logits @ w)
            np.savez(os.path.join(d, head), weights=w,
                     biases=np.float32(-(z[keep - 1] + z[keep]) / 2))
        os.environ["V3D_TPU_SAFETY_HEADS"] = d
        try:
            filt = safety.DeepFloydDataFiltering(clip=vit)
            filt_cpu = safety.DeepFloydDataFiltering(clip=vit_cpu)
        finally:
            del os.environ["V3D_TPU_SAFETY_HEADS"]
    filt(images[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = filt.features(images)
    feat_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = filt(images)
    filt_ms = 1e3 * (time.perf_counter() - t0)
    flags = filt.flags(images)
    feat_err = float(np.abs(feats[:SAFETY_CPU_FRAMES]
                            - filt_cpu.features(images[:SAFETY_CPU_FRAMES])).max())
    t0 = time.perf_counter()
    marked = safety.embed_watermark(images)
    marked8 = np.round(marked * 255).astype(np.uint8).astype(np.float32) / 255.0
    bits = safety.extract_watermark(marked8)
    wm_s = time.perf_counter() - t0
    wm_ok = list(bits.astype(int)) == safety.WATERMARK_BITS
    blurred = np.abs(out - images).max(axis=(1, 2, 3)) > 0
    ok = (feat_err <= SAFETY_CPU_MAX_ABS and wm_ok and bool(np.isfinite(out).all())
          and bool((blurred == flags).all()))
    say(phase, f"safety filter, ViT-L/14 ({sum(p.numel() for p in vit.parameters()):,} "
        f"parameters, seeded, f32) + seeded heads from $V3D_TPU_SAFETY_HEADS on phase 5's "
        f"{len(images)} frames: features {feat_ms:.3f} ms, filter {filt_ms:.3f} ms "
        f"(host clock), {int(flags.sum())} of {len(images)} flagged and blurred | features "
        f"vs the CPU on {SAFETY_CPU_FRAMES} frames max abs {feat_err:.2e} (<= "
        f"{SAFETY_CPU_MAX_ABS:g}) | watermark of {len(images)} frames through uint8: "
        f"48 bits back {wm_ok} in {wm_s:.2f} s | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"safety: features {feat_err}, watermark {wm_ok}")
    del vit, vit_cpu, filt, filt_cpu
    torch.cuda.empty_cache()
    say(phase, f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _resample_iters() -> list:
    return [i for i in range(ITER_ITERS) if i > ITER_START and i % ITER_PERIOD == 0]


def iterative_launches(engine) -> dict:
    """Launches of ``train_iterative`` at ITER_* on this engine's modules:
    three generations (each one CLIP forward, one VAE encode, 25 UNet
    forwards, one 18-frame decode), and per resample one more VAE encode
    (of the 18 renders) and two more decoder calls (decoding_t 6); the fit's
    K4 / K5 a step and K4 for the 18 orbit renders of each resample."""
    resamples = len(_resample_iters())
    enc = _summed(vae_sites(engine.vae_encoder, 64 * 64),
                  {"group_norm": count_group_norms(engine.vae_encoder)})
    dec = _summed(vae_sites(engine.vae_decoder, 64 * 64),
                  {"group_norm": count_group_norms(engine.vae_decoder)})
    out = _summed(_scaled(gen_launches(engine), 1 + resamples),
                  _scaled(enc, resamples), _scaled(dec, 2 * resamples))
    out.update(gs_composite_fwd=ITER_ITERS + engine.num_frames * resamples,
               gs_composite_bwd=ITER_ITERS)
    return out


def phase_iterative(expect: dict, dev="cuda") -> dict:
    """``apps.recon_gs_iterative.train_iterative`` on phase 5's synthetic
    image written as a PNG, seeded weights (no checkpoint), its own
    full-width engine; cut to ITER_ITERS iterations with resamples after
    ITER_START every ITER_PERIOD; launches exact (``iterative_launches``)."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from v3d_tpu_torch.apps.recon_gs_iterative import train_iterative
    from v3d_tpu_torch.gs.ply import load_ply

    phase = "17 iterative"
    say(phase, f"cut: {ITER_ITERS} iterations, resamples after {ITER_START} every "
        f"{ITER_PERIOD} (the JAX CLI's defaults: 4000 / 1000 / 500)")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        Image.fromarray(synthetic_image()).save(os.path.join(d, "in.png"))
        (trainer, timings), counts, secs = _counted(lambda: train_iterative(
            os.path.join(d, "in.png"), os.path.join(d, "out"), iterations=ITER_ITERS,
            resample_period=ITER_PERIOD, resample_start=ITER_START, device=dev))
        ply = load_ply(os.path.join(d, "out", "point_cloud.ply"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    alive = int(trainer.alive.sum())
    ply_ok = len(ply["xyz"]) == alive > 0 and all(np.isfinite(v).all() for v in ply.values())
    ok = counts == expect and len(timings["resample_s"]) == len(_resample_iters()) and ply_ok
    say(phase, f"train_iterative: {secs:.2f} s | generate {timings['generate_s']:.2f} s "
        f"(engine build included), fit {timings['fit_s']:.2f} s "
        f"({1e3 * timings['fit_s'] / ITER_ITERS:.3f} ms a step), resamples "
        f"{', '.join(f'{s:.2f}' for s in timings['resample_s'])} s | alive {alive} | "
        f"peak {peak:.2f} GiB | PLY {len(ply['xyz'])} gaussians, finite {ply_ok} | launches "
        f"{ {k: v for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in expect.items() if v} }) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"recon_gs_iterative: launches {counts}, resamples "
                           f"{timings['resample_s']}, PLY ok {ply_ok}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": counts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
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
    say("run", f"phases {sorted(phases)}")
    if 2 in phases:
        phase_build()
    kernel_checks = phase_kernels() if 3 in phases else {}
    engine = (build_engine(torch.device("cuda"))
              if phases & {4, 5, 9, 10, 12, 16, 17} else None)
    if 4 in phases:
        phase_unet(engine)
    gen = phase_generate(engine) if 5 in phases else {}
    routes = phase_routes(engine) if 9 in phases else {}
    if 10 in phases:
        phase_checkpoint(engine, torch.device("cuda"))
    entry = phase_gen_entry_points(engine, gen) if 16 in phases else {}
    gen_expect = gen_launches(engine) if 12 in phases else {}
    iter_expect = iterative_launches(engine) if 17 in phases else {}
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
    paths = {"gen": gen, "routes": routes, "fit": {"launches": fit.get("launches", {})}}
    g_np = fit["trainer"].gaussians_np() if fit and 14 in phases else None
    del fit
    torch.cuda.empty_cache()
    paths["train"] = phase_train(torch.device("cuda")) if 8 in phases else {}
    neus = phase_neus() if 11 in phases else {}
    if 12 in phases:
        phase_full_asset(gen_expect)
    if 13 in phases:
        phase_refine(neus)
    if 14 in phases:
        gs_mesh = phase_gs_to_mesh(g_np)
        kernel_checks.setdefault("gs_composite_fwd", []).append(gs_mesh["check"])
    if 15 in phases:
        phase_dpt(neus)
    iterative = phase_iterative(iter_expect) if 17 in phases else {}
    # phases 16-17 add their launches to the paths that report K1-K6
    for name, path in KERNEL_PATH.items():
        if path in ("gen", "fit") and (16 in phases or 17 in phases):
            total = sum(p.get("launches", {}).get(name, 0)
                        for p in (paths[path], entry, iterative))
            paths[path] = {**paths[path], "launches": {**paths[path].get("launches", {}),
                                                       name: total}}

    report = []
    for name, meta in KERNELS.items():
        checks = kernel_checks.get(name, [])
        bf16 = [c for c in checks if c["dtype"] == "bfloat16"]
        head = bf16[0] if bf16 else checks[0] if checks else {}
        path = paths[KERNEL_PATH[name]]
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
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
