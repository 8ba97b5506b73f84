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
   bounds of the pair (seven products) and of the function (five); K10 at
   every (rows, C) of both UNets' forwards and CLIP's
   (``K10_FORWARD_SHAPES``, ``K10_IMAGE_SHAPES``), against LayerNormF32's
   chain and, as the library call, ``F.layer_norm`` on the f32 copy, and
   affine-free (eps 1e-6) at FLUX.1-dev's (``K10_FLUX_SHAPES``); K9 also at
   FLUX.1-dev's joint attention (1, 4608, 24, 128), q scaled so that the
   softmax is peaked;
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
    as many iterations as fit in 20 s: ms per iteration, the forward
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
    ms per fit step, alive count, peak memory, the PLY;
18. fine-tuning from rendered PNG orbits on phase 8's engine (after phase
    8): 2 objects of 18 RGBA PNGs at 512^2 written from phase 6's scene
    (alpha its silhouette), the encode on the way in timed (VAE of 18 + 1
    frames, CLIP of the front view) and held against ``reference_mode()``
    (PSNR), then ``apps.train_diffusion.train`` for 4 steps with prefetch
    and a log directory: ms per step, peak memory, launches per step (K6
    209 + 44), the rows of metrics.csv;
19. the autoencoder trainer at V3D's first-stage geometry on 4 of phase
    6's views at 256^2: one generator step's loss and gradients with the
    kernels against ``reference_mode()`` under the default backend (K6 52
    a reconstruction) and under "flash" (K9 2, its backward recomputed),
    then 8 steps with the discriminator's from step 4: ms per generator
    and per discriminator step, peak memory;
20. PixelNeRF (ResUNet encoder, the JAX defaults) from view 0 at 512^2 to
    18 orbit targets at 64^2, and the forward and backward of the PixelNeRF
    diffusion loss on a closed-form denoiser: ms per render, peak memory,
    card against CPU (no kernel of csrc/ runs).

21. image diffusion at SD 2.1's width (the JAX UNetModel's defaults: 320
    channels, (1, 2, 4, 4), attention at ds 1/2/4, heads of 64, context
    1024, linear projections) with the image VAE, seeded bf16: the
    parameter count against the JAX module's, one CFG-doubled forward
    against ``reference_mode()`` (and a narrower ``use_scale_shift_norm``
    net's), then ``ImageDiffusionEngine``: a 50-step txt2img sample (Euler,
    DDPM eps, CFG 5) at 512^2 on a seeded (1, 77, 1024) context, its
    decode, the encode of a synthetic image and img2img at strength 0.6 (30
    of 50 steps), with exact K1 / K6 launches; then the V3D-512 engine of
    ``engine_from_config(configs/v3d_512.yaml)`` against
    ``build_v3d_engine``'s at the same seeds (every tensor and a UNet
    forward bit for bit);
22. LPIPS on seeded VGG16 weights the phase writes: card vs CPU on 4 pairs
    at 512^2 with cuDNN's TF32 switch on (PyTorch's default), forward and
    backward times; 100 iterations of phase 6's fit
    with lambda_dssim 1 and lambda_lpips 2 (one step's gradients against
    ``reference_mode()`` first; K4 / K5 exact); ``apps.render_cli`` on its
    PLY (spiral 54 frames, depth, orbit) and ``apps.metrics_cli`` on the
    orbit renders against the frames; refine with lambda_lpips 1 and
    without on a sphere mesh, and ``apps.refine.do_refine`` with it.
23. posed scenes through ``apps.recon_scene``: K4 / K5 against the plain
    compositor on one 1008 x 756 view (63 x 48 tiles, the last row 4
    pixels tall) and one 800^2 view of the seeded 100k-point init at Kc
    4096, and a fit step's gradients at both sizes against
    ``reference_mode()``; then, sphere-traced from phase 11's analytic
    scene, a blender scene at NeRF-synthetic's size (100 RGBA views at
    800^2, FoV 40) for 500 of 4000 iterations, a COLMAP workspace at LLFF's
    (20 views at 1008 x 756, a binary model of 2000 points) through
    ``apps.imgs2poses.gen_poses`` and 300 iterations, and a DTU scene at
    neus-dtu's downscale (49 views at 800 x 600, per-frame K, masks,
    cameras.npz) through NeuS for 300 steps and the mesh at 128^3: ms per
    step, PSNR, launches (K4 = K5 = iterations);
24. the other entry points: ``apps.full_eval.run`` on two 18-frame 512^2
    orbits written as mp4 (300 iterations each, launches exact),
    ``apps.recon_neus_ortho`` on the six Wonder3D views at 512^2 (fixed
    poses, normal maps) for 300 of 3000 steps and the coloured mesh at
    128^3, and ``validate_ckpt --all`` on seeded LPIPS and U2Net .npz files
    and on an empty directory;
25. the trainers' step chunks (a chunk on the card replays a CUDA graph of
    one step): phase 6's fit (``GSTrainer.train``, 200 iterations,
    densify events at 100 and 200) at ``chunk_size`` 1, 50 and 1 again,
    then ``NeusTrainer.train`` with recon_scene's recipe on phase 23's DTU
    scene for 100 steps at ``chunk`` 1, 50 and 1, nothing synchronised per
    step: ms per step of each run (the fit over its steps, one sync at the
    end), peak memory, launches (exact: a replay adds its step's counts);
    a replay and an eager step from one state (loss bit for bit,
    gradients within 1e-5 of the largest); the fits' losses and
    parameters, chunked against per-step, beside the per-step path's own
    run-to-run spread;
26. the multi-device path (``v3d_tpu_torch.parallel``): (a) on phase 8's
    engine, 3 fine-tune steps on a ("data", "model") mesh of world size 1
    over NCCL (the trainer's broadcast and gradient all_reduce) against 3
    steps without a mesh, run twice, on the same batch and draws: bit for
    bit, or within the two mesh-less runs' own difference; launches as
    phase 8; (b) ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m v3d_tpu_torch.apps.train_diffusion --model-axis 1``
    for 2 steps, after phase 8's engine has left the card: exit 0, two
    finite steps, the launches its JSON lines carry (exact, as phase 8's
    per step), its seconds; (c) ``python -m v3d_tpu_torch.parallel.dryrun
    --nproc 2 --backend gloo`` (two ranks on this card) at the full refpoint
    rung: the DP fine-tune step of the tiny engine (loss rel <= 1e-3, each
    gradient's cosine >= 0.999 against one process on the global batch;
    each rank's launches exact, ``train_launches`` of the tiny UNet),
    the DP 3DGS and NeuS steps, the tile-sharded 3DGS step (render within
    2e-5 of one process's, gradients within 1e-3 of their largest; K4 and
    K5 once a rank) and the ray-parallel NeuS step;
27. frame-sharded sampling and the frame-split step (``parallel/frames.py``):
    (a) on phase 5's engine (right after phase 17's count), the 25-step
    sample through ``sample_latents(mesh=)`` on a (1, 1) NCCL mesh against
    the same sample without a mesh on the same seeded c / uc / noise
    (PSNR >= 30 dB; seconds, peak memory, launches exact both ways: the
    mesh's time stacks run K6's split pair); (b) once that engine has left
    the card, 2 ranks on this card over gloo, the full-width engine each,
    2 Euler steps with 18 of the 36 CFG frames a rank against one
    process's 2 steps on the same noise (PSNR >= 30 dB, max abs; each
    rank's launches exact; seconds a forward, the bytes the exchanges
    moved); (c) the dry run's sampling stage and its fine-tune step at the
    graft's shape (one video, 2 frames a rank), each rank's launches exact
    (phase 26(c)'s run of the dry run, or one at the "small" rung).  Phase
    3 holds K6's split entries to their plain versions at the temporal
    ResBlock's shapes, whole and on a half strip, beside the one-launch K6.
28. the tensor-parallel forward over "model" (``parallel/tensor.py``): (a)
    K2 at one rank's ds1 heads (3 and 2 heads of 64: Q/K/V rows of 192 and
    128, the output projection zero-padded, no bias) against its plain
    version; on phase 5's engine, a CFG-doubled denoise step at full width
    (36 frames at 64^2, bf16) after a warm-up; then, once that engine has
    left the card, 2 ranks on this card over gloo on a (1, 2) mesh, the
    full-width UNet cut by ``tp_shard_`` on each, the same step: PSNR >= 30
    dB against the one process, each rank's launches exactly one process's,
    seconds a forward, the all-reduces and bytes a forward, parameter bytes
    and peak memory per rank; (b) ``python -m v3d_tpu_torch.parallel.dryrun
    --nproc 4 --backend gloo --rung small`` (a (2, 2) mesh on this card): the
    tensor-parallel fine-tune step (loss rel <= 1e-3, gathered gradients'
    cosines >= 0.999, updated parameters within 2 lr), sampling with the UNet
    tensor-parallel (max abs <= 1e-2), the full-size meta stage (shapes, the
    parameter count), the DP recon stages and the refpoint, each rank's
    launches exact.
29. FLUX.1-dev's transformer (``models/flux.py``) at its published widths
    and depth, seeded bf16: its parameter count, one forward at 1024^2
    (4,096 image + 512 text tokens, guidance 3.5) with the kernels against
    the same forward in ``reference_mode()`` (PSNR >= 30 dB), its launches
    exact: K9 57 and K10 115 a forward (``FLUX_LAUNCHES``, also counted
    from the modules), ms a forward, peak memory.

Each path (phases 5, 6, 8, each run of 9, 11, 14, each run of 16, 17, 18,
19, 20, 21, 22's fit and renders, 23's fits, 24's ``full_eval``, each
run of 25 and 26(a)'s, in each rank of 26(c) its steps, each run of 27(a)
and in each rank of 27(b) and (c) its sample and step, 28(a)'s denoise
steps in the one process and in each rank, and in each rank of 28(b) its
step, sample and tile-sharded render, 29's forward) is run with
the launch counts set to 0 just before it and read just after (phase 12:
each stage's launches, the counters read before and after it; 26(b): the
counts of the torchrun child, which start at 0 with its process and which
its JSON line of each step carries).  A kernel of the path launched
no time, or another number of times than the path needs (counted from the
modules and their routing rules, see ``unet_sites``), fails the run.
Then one JSON line with every kernel's numbers (``launches``: the sum over
the paths run, ``launches_by_path`` each path's), and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  No CUDA device: exit 2 at once.  Nothing here imports JAX or
v3d_tpu.

TF32: both ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, so float32 products and
convolutions run in full float32 (generation itself runs in bf16); phase
22's LPIPS check turns cuDNN's back on, since LPIPS keeps its own
convolutions in float32 whatever the switch says.
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
    "group_norm_stats": dict(
        label="K6 split statistics", source="v3d_tpu_torch/csrc/group_norm.cu",
        replaces="v3d_tpu/ops/fused_groupnorm.py:100 (_pallas_group_norm's "
                 "_stats_kernel call, T9)"),
    "group_norm_apply": dict(
        label="K6 split apply", source="v3d_tpu_torch/csrc/group_norm.cu",
        replaces="v3d_tpu/ops/fused_groupnorm.py:126 (_pallas_group_norm's "
                 "_norm_kernel call, T9)"),
    "layer_norm": dict(
        label="K10", source="v3d_tpu_torch/csrc/layer_norm.cu",
        replaces="none: v3d_tpu/models/layers.py LayerNormF32 is left to XLA's "
                 "fusion (K10 is the eager upcast + f32 F.layer_norm + downcast "
                 "as one pass)"),
}
# K10's calls in one no-grad forward of each full-width UNet (bf16): (rows,
# C) of the LayerNorm input and calls.  V3D-512 (the CFG-doubled 36 frames
# at 64^2 latents): 7 a SpatialVideoTransformer (3 in its spatial block, 4
# in its temporal one), 16 of them, 112 calls; SD 2.1's UNet2D (8 CFG rows
# at 96^2): 3 a transformer block, 16 of them, 48 calls.  The lists a
# meta-device forward gives (tests/test_torch_kernel_plans.py holds them so).
K10_FORWARD_SHAPES = (((147456, 320), 35), ((36864, 640), 35), ((9216, 1280), 35),
                      ((2304, 1280), 7))
K10_IMAGE_SHAPES = (((73728, 320), 15), ((18432, 640), 15), ((4608, 1280), 15),
                    ((1152, 1280), 3))
# FLUX.1-dev's affine-free LayerNorms (eps 1e-6) in one forward at 1024^2:
# 4 a double block (2 on the 4,096 image tokens, 2 on the 512 text ones), 1
# a single block on the joined 4,608, the final layer's on the image tokens:
# 19 x 4 + 38 + 1 = 115 calls (tests/test_torch_kernel_plans.py holds them so)
K10_FLUX_SHAPES = (((4096, 3072), 39), ((512, 3072), 38), ((4608, 3072), 38))
# phase 29: FLUX.1-dev's transformer (models/flux.py's defaults are its
# published widths), its parameter count and the kernels' launches in one
# forward: K9 once a block (19 + 38 joint attentions), K10 as above
FLUX_PARAMS = 11_901_408_320
FLUX_LAUNCHES = {"flash_attn_fwd_wide": 57, "layer_norm": 115}
FLUX_TOKENS = (512, 64)       # text tokens; the latent's side at 1024^2
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

# phase 21: the image UNet at SD 2.1's width (the JAX UNetModel's defaults),
# one CFG-doubled 512^2 image (64^2 latents); its parameter count, as
# jax.eval_shape of the JAX module gives it (tests/test_torch_unet2d.py)
IMAGE_BATCH = 2
IMAGE_LATENT = 64
UNET2D_PARAMS = 865_910_724
# K6's calls in one such forward, read off a meta-device forward
# (tests/test_torch_unet2d.py holds them so): 61 calls, 18 shapes
K6_UNET2D_SHAPES = (
    ((2, 320, 64, 64), False, 5), ((2, 320, 64, 64), True, 8),
    ((2, 640, 32, 32), False, 5), ((2, 640, 32, 32), True, 6),
    ((2, 1280, 16, 16), False, 5), ((2, 1280, 16, 16), True, 6),
    ((2, 1280, 8, 8), False, 1), ((2, 1280, 8, 8), True, 11),
    ((2, 2560, 8, 8), True, 3), ((2, 640, 64, 64), True, 2),
    ((2, 960, 64, 64), True, 1), ((2, 1920, 32, 32), True, 1),
    ((2, 1280, 32, 32), True, 1), ((2, 960, 32, 32), True, 1),
    ((2, 320, 32, 32), True, 1), ((2, 2560, 16, 16), True, 2),
    ((2, 1920, 16, 16), True, 1), ((2, 640, 16, 16), True, 1),
)
# the narrower use_scale_shift_norm net of phase 21 and its K6 calls: each
# res block's out-norm runs without SiLU (the affine comes between)
UNET2D_SS_KW = dict(model_channels=192, use_scale_shift_norm=True)
K6_UNET2D_SS_SHAPES = (
    ((2, 192, 64, 64), False, 10), ((2, 192, 64, 64), True, 3),
    ((2, 384, 32, 32), False, 10), ((2, 384, 32, 32), True, 1),
    ((2, 768, 16, 16), False, 10), ((2, 768, 16, 16), True, 1),
    ((2, 768, 8, 8), False, 8), ((2, 768, 8, 8), True, 4),
    ((2, 1536, 8, 8), True, 3), ((2, 384, 64, 64), True, 2),
    ((2, 576, 64, 64), True, 1), ((2, 1152, 32, 32), True, 1),
    ((2, 768, 32, 32), True, 1), ((2, 576, 32, 32), True, 1),
    ((2, 192, 32, 32), True, 1), ((2, 1536, 16, 16), True, 2),
    ((2, 1152, 16, 16), True, 1), ((2, 384, 16, 16), True, 1),
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
           library_fn=None, phase: str = "3 kernels") -> dict:
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
    say(phase, f"{KERNELS[name]['label']} {name} {shape_tag} "
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
    results["group_norm"] = group_norm_checks(randn) + group_norm_unet2d_checks(randn)
    results["group_norm_stats"], results["group_norm_apply"] = group_norm_split_checks(randn)
    results["layer_norm"] = layer_norm_checks(randn)
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
# CLIP ViT-H under "packed", d = 128, one key, FLUX.1-dev's joint attention
WIDE_SHAPES = (("T2 VAE decode", (18, 4096, 4096, 1, 512)),
               ("T4 CLIP", (1, 257, 257, 16, 80)),
               ("d128", (4, 1024, 1024, 4, 128)),
               ("sk=1", (18, 4096, 1, 1, 512)),
               ("FLUX.1 joint", (1, 4608, 4608, 24, 128)))
# q's scale where random unit q and k would give a near-uniform softmax over
# thousands of keys and an output near zero: scores of std 4 pick a few keys
WIDE_Q_SCALE = {"FLUX.1 joint": 4.0}


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
        scale = (WIDE_Q_SCALE.get(tag, 1.0), 1.0, 1.0)
        x32 = [(randn(b, s, h, d) * c).transpose(1, 2) for s, c in zip((sq, sk, sk), scale)]
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


def layer_norm_work(rows: int, C: int, elem: int, param_elem: int):
    """(FLOPs, bytes) of one K10 call on ``rows`` rows of C: the two
    statistics and the normalise-and-affine (8 an element); x read once, y
    written once, weight and bias read once (``param_elem`` 0: none)."""
    n = rows * C
    return 8 * n, 2 * n * elem + 2 * C * param_elem


def layer_norm_checks(randn) -> list:
    """K10 at every (rows, C) of the two UNets' forwards
    (``K10_FORWARD_SHAPES``, ``K10_IMAGE_SHAPES``) and CLIP ViT-H's (257,
    1280), bf16 x with bf16 weight and bias (as the engines hold them),
    eps 1e-5; V3D's ds1 also in f32 x and f32 parameters; FLUX.1-dev's
    (``K10_FLUX_SHAPES``) affine-free with eps 1e-6, through the generic
    path at C = 3072.  Plain: LayerNormF32's chain (upcast, f32
    ``F.layer_norm``, downcast); library: ``F.layer_norm`` on the f32 copy
    alone; bound: one read of x, one write of y."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_f32_plain

    out = []
    sites = ([("v3d", s, torch.bfloat16, True) for s, _ in K10_FORWARD_SHAPES]
             + [("sd", s, torch.bfloat16, True) for s, _ in K10_IMAGE_SHAPES]
             + [("clip", (257, 1280), torch.bfloat16, True),
                ("v3d", K10_FORWARD_SHAPES[0][0], torch.float32, True)]
             + [("flux", s, torch.bfloat16, False) for s, _ in K10_FLUX_SHAPES])
    for tag, (rows, C), dtype, affine in sites:
        x = (randn(rows, C) + 0.3).to(dtype)
        w = b = wf = bf = None
        if affine:
            w, b = (1 + randn(C, scale=0.1)).to(dtype), randn(C, scale=0.1).to(dtype)
            wf, bf = w.float(), b.float()
        eps = 1e-5 if affine else 1e-6
        up = x.float()

        def library():
            return F.layer_norm(up, (C,), wf, bf, eps)

        # the library call is also the f32 result the bf16 kernel is held to
        out.append(_check(
            "layer_norm", f"{tag} {(rows, C)}{'' if affine else ' no affine'}", dtype,
            lambda: layer_norm_f32(x, w, b, eps),
            lambda: layer_norm_f32_plain(x, w, b, eps), library,
            layer_norm_work(rows, C, x.element_size(), w.element_size() if affine else 0),
            library))
        del x, up
    return out


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


# the time stack's GroupNorm inputs of a full-width forward, (b, C, t, s, 1)
# as the frame-parallel VideoResBlock holds them: whole (one rank) and a
# half strip of pixels (two)
K6_SPLIT_SHAPES = tuple((tag, (2, c, 18, s, 1)) for c, hw in
                        ((320, 64), (640, 32), (1280, 16), (1280, 8))
                        for tag, s in (("whole", hw * hw), ("half strip", hw * hw // 2)))


def group_norm_split_checks(randn) -> tuple:
    """K6's split entries at the temporal ResBlock's shapes (whole and half
    strips), f32 and bf16 (with SiLU, as the time stack runs them), each
    against its plain version: the statistics entry (library: one
    ``torch.var_mean`` over each sample's groups; bound: one read of x) and
    the apply entry with the sums of this call (library none: no single
    call takes given statistics; bound: one read of x, one write of y);
    then the pair against the one-launch K6 and F.group_norm."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.group_norm import (
        group_norm_apply_fwd,
        group_norm_apply_plain,
        group_norm_fwd,
        group_norm_stats_fwd,
        group_norm_stats_plain,
    )

    stats, apply = [], []
    for tag, shape in K6_SPLIT_SHAPES:
        B, C = shape[:2]
        n = math.prod(shape[2:])
        count = n * (C // 32)
        x32 = (randn(*shape) + 0.3).contiguous(memory_format=torch.channels_last_3d)
        w32, b32 = 1 + randn(C, scale=0.1), randn(C, scale=0.1)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            up = x.float()
            elem = x.element_size()
            sums = group_norm_stats_plain(x, 32)
            stats.append(_check(
                "group_norm_stats", f"{tag} {shape}", dtype,
                lambda: group_norm_stats_fwd(x, 32), lambda: group_norm_stats_plain(x, 32),
                lambda: group_norm_stats_plain(up, 32),
                (3 * n * C, n * C * elem + B * 32 * 2 * 4),
                lambda: torch.var_mean(x.unflatten(1, (32, C // 32)),
                                       dim=tuple(range(2, x.dim() + 1)))))
            apply.append(_check(
                "group_norm_apply", f"{tag} {shape} +SiLU", dtype,
                lambda: group_norm_apply_fwd(x, sums, w32, b32, 32, count, 1e-5, True),
                lambda: group_norm_apply_plain(x, sums, w32, b32, 32, count, 1e-5, True),
                lambda: group_norm_apply_plain(up, sums, w32, b32, 32, count, 1e-5, True),
                group_norm_work(shape, True, elem, 4)))
            if tag == "whole":
                pair = cuda_ms(lambda: group_norm_apply_fwd(
                    x, group_norm_stats_fwd(x, 32), w32, b32, 32, count, 1e-5, True))
                one = cuda_ms(lambda: group_norm_fwd(x, w32, b32, 32, 1e-5, True))
                lib = cuda_ms(lambda: F.group_norm(x, 32, w32.to(dtype), b32.to(dtype), 1e-5))
                bound, _ = bound_ms(*group_norm_work(shape, True, elem, 4),
                                    PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
                say("3 kernels", f"K6 split pair {shape} +SiLU {str(dtype).split('.')[-1]}: "
                    f"statistics + apply {pair:.4f} ms, the one-launch K6 {one:.4f} ms, "
                    f"F.group_norm {lib:.4f} ms, bound {bound:.4f} ms (bytes)")
            del x, up
        del x32
    return stats, apply


def group_norm_unet2d_checks(randn) -> list:
    """K6 at every GroupNorm shape of the image UNet's CFG-doubled forward
    (phase 21): the SD-2.1-width net's (``K6_UNET2D_SHAPES``) and the
    narrower ``use_scale_shift_norm`` net's (``K6_UNET2D_SS_SHAPES``, whose
    res-block out-norms run without SiLU), bf16 with bf16 scale and bias,
    each against its plain version; the summed time per forward against
    the summed bound."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.group_norm import group_norm_act_plain, group_norm_fwd

    out = []
    for net, shapes in (("SD 2.1", K6_UNET2D_SHAPES),
                        ("scale-shift", K6_UNET2D_SS_SHAPES)):
        total_ms = total_bound = 0.0
        for shape, silu, calls in shapes:
            C = shape[1]
            x = (randn(*shape) + 0.3).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            w = (1 + randn(C, scale=0.1)).to(torch.bfloat16)
            bias = randn(C, scale=0.1).to(torch.bfloat16)
            up = x.float()
            res = _check(
                "group_norm", f"unet2d {net} {shape}{' +SiLU' if silu else ''}",
                torch.bfloat16,
                lambda: group_norm_fwd(x, w, bias, 32, 1e-5, silu),
                lambda: group_norm_act_plain(x, w, bias, 32, 1e-5, silu),
                lambda: group_norm_act_plain(up, w, bias, 32, 1e-5, silu),
                group_norm_work(shape, silu, 2, 2),
                lambda: F.group_norm(x, 32, w, bias, 1e-5))
            out.append(res)
            total_ms += calls * res["ms"]
            total_bound += calls * res["bound_ms"]
        say("3 kernels", f"K6 an image-UNet forward ({net}, batch 2 at 64^2 latents): "
            f"{sum(c for _, _, c in shapes)} launches, summed kernel time "
            f"{total_ms:.4f} ms against a summed bound of {total_bound:.4f} ms "
            f"({100 * total_bound / total_ms:.1f}% of the bound)")
    return out


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


def fit_scene_slabs(dev, n: int = 100_000, res: int = 512, kc: int = 2048,
                    width: int = None, height: int = None, fov: float = 60.0,
                    radius: float = 2.0):
    """The slab T10/T11 see at the first step of the fit: the trainer's
    seeded random init of ``n`` points (in a ball of ``radius``) projected
    from orbit camera 0 (horizontal FoV ``fov``) at res^2, or at ``width`` x
    ``height``, binned into 8x8-tile coarse cells of Kc = ``kc``."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import Camera, get_uniform_poses
    from v3d_tpu_torch.gs.gaussians import from_pcd, random_init_pcd
    from v3d_tpu_torch.gs.render import RasterizeConfig, build_slabs, project_gaussians

    width, height = width or res, height or res
    xyz, colors = random_init_pcd(np.random.RandomState(0), n, radius=radius)
    g = from_pcd(xyz, colors, capacity=3 * n, device=dev)
    cam = Camera.from_c2w(get_uniform_poses(18, 2.0, 0.0)[0], fov, width, height)
    return build_slabs(project_gaussians(g, cam), height, width,
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


def k4_forward_check(slabs, phase: str, plain_iters: int = 5) -> tuple:
    """K4 (T10) against the plain compositor on ``slabs``: rgb / acc / depth,
    the checkpoints K5 reads, the (pixel, gaussian) pairs of this run's data
    (``gs_pairs``), kernel / plain times (the plain one the median of
    ``plain_iters`` samples) and the bound.  Raises on a disagreement;
    returns (the check's entry, its inputs, K4's checkpoints, the pairs)."""
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
    plain_ms = cuda_ms(lambda: gc.composite_plain(*args), iters=plain_iters,
                       warmup=int(plain_iters > 2))
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
    n_tiles = args[2].shape[0]
    k5, cot = k5_backward_check(args, saved, pairs, k4["shape"], "3 kernels")

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
    walked = int(prof[:, 5].sum())
    say("3 kernels", f"K5 clock64 cycles per block ({n_tiles} blocks; the longest of "
        f"its groups for the phases), mean / max: "
        + ", ".join(f"{name} {float(cycles[:, i].mean()):,.0f} / {float(cycles[:, i].max()):,.0f}"
                    for i, name in enumerate(("all", "front-to-back sums", "walk", "flush")))
        + f" | (tile, gaussian) pairs admitted by the cull {k5['cull_admitted']:,} (exact "
        f"1/255 box {pairs['reach']:,}), gaussians the groups' first warps walked {walked:,}")
    return {"gs_composite_fwd": [dict(k4, cull_admitted=fwd_admitted)],
            "gs_composite_bwd": [k5]}


def k5_backward_check(args, saved, pairs, tag: str, phase: str,
                      plain_iters: int = 5) -> tuple:
    """K5 (T11) against the autograd backward of the plain compositor on
    K4's inputs and checkpoints (``k4_forward_check``'s), for seeded random
    cotangents: each attribute's max abs <= GS_GRAD_REL x max |plain|; the
    times of both, the bound.  Raises on a disagreement; returns (the
    check's entry, the cotangents)."""
    import torch

    from v3d_tpu_torch.ops import gs_composite as gc

    dev = args[0].device
    n_cells, kc, _ = args[0].shape
    n_tiles = args[2].shape[0]
    n_pix = n_tiles * gc.P
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
    prof = torch.zeros(n_tiles, gc.BWD_PROF_SLOTS, dtype=torch.int64, device=dev)
    gc.composite_bwd(args[0], args[2], args[3], saved, *cot, prof=prof)
    admitted = int(prof[:, 4].sum())
    bwd_ms = cuda_ms(lambda: gc.composite_bwd(args[0], args[2], args[3], saved, *cot))
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out, slab, cot, retain_graph=True), iters=plain_iters,
        warmup=int(plain_iters > 2))
    bwd_bound = bound_ms(
        pairs["needed_bwd"] * GS_FLOPS_TEST + pairs["composited"] * GS_FLOPS_BWD,
        2 * n_cells * kc * gc.ATTR * 4 + n_pix * 24 + pairs["ts_rows"] * gc.P * 4
        + n_tiles * 12, PEAK_FP32)
    say(phase, f"K5 gs_composite_bwd (T11) {tag} f32: per attribute "
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
    entry = {"shape": tag, "dtype": "float32", "library_ms": None,
             "pairs": pairs, "cull_admitted": admitted,
             "max_abs_err": max(e for e, _ in rows),
             "ms": bwd_ms, "plain_ms": plain_bwd_ms,
             "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}
    del plain_out, slab, want, dslab
    return entry, cot


ATTENTION_KERNELS = ("flash_attn_fwd", "flash_attn_fwd_wide")


def unet_sites(unet, hw: int, context_tokens: int = 1, dtype=None,
               ranks=None, rank: int = 0) -> dict:
    """What one VideoUNet forward at hw^2 latents (activations in ``dtype``,
    default bf16) launches under the attention routing set now, counted
    from the modules and their own routing rules: each spatial self- and
    cross-attention (on ``context_tokens`` tokens) by
    ``CrossAttention.route`` (K1 or K9, or none; ``k1_grad``: the K1 sites
    whose backward is K8/K7, the "flash_jax" route), temporal
    self-attentions that take K2
    (``TemporalSelfAttention.takes_block``) or else K3, and the GroupNorms
    (K6) inside the blocks that ``use_checkpoint`` recomputes
    (VideoResBlock, SpatialVideoTransformer) and outside them.  With
    ``ranks``: rank ``rank``'s share of a frame-parallel forward over that
    many ranks (``parallel/frames.py``): the temporal attentions on its
    strip of pixels (``pixel_strips``), and the time stacks' GroupNorms as
    K6's split pair (``gn_split``, each a statistics and an apply launch)."""
    import torch

    from v3d_tpu_torch.models.layers import Downsample, GroupNorm32, Upsample
    from v3d_tpu_torch.models.video_attention import SpatialVideoTransformer
    from v3d_tpu_torch.models.video_unet import VideoResBlock
    from v3d_tpu_torch.ops.attention import route_kernel
    from v3d_tpu_torch.parallel.mesh import pixel_strips

    sites = dict.fromkeys(ATTENTION_KERNELS + ("k1_grad", "temporal_block",
                                               "temporal_core", "gn_blocks",
                                               "gn_other", "gn_split"), 0)
    res = hw
    blocks = list(unet.input_blocks) + [unet.middle_block] + list(unet.output_blocks)
    for layer in [m for block in blocks for m in block] + [unet.out]:
        n_gn = sum(isinstance(m, GroupNorm32) for m in layer.modules())
        if isinstance(layer, (VideoResBlock, SpatialVideoTransformer)):
            if ranks and isinstance(layer, VideoResBlock):
                split = count_group_norms(layer.time_stack)
                sites["gn_split"] += split
                n_gn -= split
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
            a, b = pixel_strips(tokens, ranks)[rank] if ranks else (0, tokens)
            for tb in layer.time_stack:
                fused = tb.attn1.takes_block(b - a)
                sites["temporal_block" if fused else "temporal_core"] += 1
        elif isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
    return sites


def unet2d_sites(unet, hw: int, context_tokens: int, dtype=None) -> dict:
    """What one image-UNet forward at hw^2 latents (activations in
    ``dtype``, default bf16) launches under the routing set now, counted
    from its modules as ``unet_sites`` counts the VideoUNet's: each
    self- and cross-attention by ``CrossAttention.route``, every GroupNorm
    once (K6)."""
    import torch

    from v3d_tpu_torch.models.attention_blocks import SpatialTransformer
    from v3d_tpu_torch.models.layers import Downsample, GroupNorm32, Upsample
    from v3d_tpu_torch.ops.attention import route_kernel

    sites = dict.fromkeys(ATTENTION_KERNELS + ("group_norm",), 0)
    sites["group_norm"] = sum(isinstance(m, GroupNorm32) for m in unet.modules())
    res = hw
    blocks = list(unet.input_blocks) + [unet.middle_block] + list(unet.output_blocks)
    for layer in (m for block in blocks for m in block):
        if isinstance(layer, SpatialTransformer):
            for blk in layer.transformer_blocks:
                for attn, ctx in ((blk.attn1, context_tokens if blk.disable_self_attn
                                   else None), (blk.attn2, context_tokens)):
                    _, route = attn.route(res * res, ctx, dtype or torch.bfloat16, True)
                    kernel = route_kernel(route, attn.dim_head)
                    if kernel:
                        sites[kernel] += 1
        elif isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
    return sites


def _attention_kernel(sq: int, d: int, dtype=None):
    """The kernel an ``attention`` self-attention call over sq tokens at
    head width d (activations in ``dtype``, default bf16) launches on the
    card under the routing set now."""
    import torch

    from v3d_tpu_torch.ops.attention import attention_route, route_kernel

    return route_kernel(attention_route(sq, sq, d, dtype or torch.bfloat16, True), d)


def vae_sites(vae, tokens: int, dtype=None) -> dict:
    """Attention launches of one VAE encode or decode call: its AttnBlocks
    (V3D: the mid block's, at the latent resolution, ``tokens`` tokens,
    single-head d = channels; activations in ``dtype``, default bf16)."""
    from v3d_tpu_torch.models.vae import AttnBlock

    out = dict.fromkeys(ATTENTION_KERNELS, 0)
    for m in vae.modules():
        kernel = isinstance(m, AttnBlock) and _attention_kernel(tokens, m.q.in_channels,
                                                                dtype)
        if kernel:
            out[kernel] += 1
    return out


def clip_sites(clip) -> dict:
    """Launches of one no-grad CLIP ViT forward: every residual block's
    self-attention over the patches and the class token, and K10 at each
    LayerNorm (two a block, ``ln_pre``, ``ln_post``)."""
    out = dict.fromkeys(ATTENTION_KERNELS, 0)
    out["layer_norm"] = count_layer_norms(clip)
    tokens = (clip.image_size // clip.conv1.kernel_size[0]) ** 2 + 1
    for blk in clip.transformer.resblocks:
        kernel = _attention_kernel(tokens, clip.conv1.out_channels // blk.attn.heads)
        if kernel:
            out[kernel] += 1
    return out


def count_group_norms(module) -> int:
    from v3d_tpu_torch.models.layers import GroupNorm32

    return sum(isinstance(m, GroupNorm32) for m in module.modules())


def count_layer_norms(module) -> int:
    """K10's launches in one no-grad forward of ``module``: each
    LayerNormF32 runs once (none under a gradient: training's take the
    plain formula)."""
    from v3d_tpu_torch.models.layers import LayerNormF32

    return sum(isinstance(m, LayerNormF32) for m in module.modules())


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
    out["layer_norm"] = steps * count_layer_norms(engine.unet) + cond[0]["layer_norm"]
    out.update(temporal_block=steps * u["temporal_block"],
               temporal_core=steps * u["temporal_core"],
               group_norm=steps * (u["gn_blocks"] + u["gn_other"])
               + count_group_norms(engine.vae_encoder)
               + count_group_norms(engine.vae_decoder))
    return out


def forward_launches(unet, hw: int = 64, dtype=None, ranks=None, rank: int = 0) -> dict:
    """Launches of one no-grad UNet forward under the routing set now, K10
    at every LayerNorm (with ``ranks``: rank ``rank``'s share of a
    frame-parallel forward)."""
    u = unet_sites(unet, hw, dtype=dtype, ranks=ranks, rank=rank)
    out = {name: 0 for name in KERNELS}
    out.update({k: u[k] for k in ATTENTION_KERNELS + ("temporal_block", "temporal_core")},
               group_norm=u["gn_blocks"] + u["gn_other"],
               group_norm_stats=u["gn_split"], group_norm_apply=u["gn_split"],
               layer_norm=count_layer_norms(unet))
    return out


def train_launches(unet, hw: int = 64, use_checkpoint: bool = True, ranks=None,
                   rank: int = 0, dtype=None) -> dict:
    """Launches of one fine-tune step: the forward, the blocks' forwards
    once more when checkpointing recomputes them, K8 and K7 once per K1
    site of the "flash_jax" route; K2/K3/K6 and the other attention routes'
    backwards recompute through plain formulas; the LayerNorms want a
    gradient, so none takes K10.  With ``ranks``: rank
    ``rank``'s share of a frame-split step (``unet_sites``)."""
    u = unet_sites(unet, hw, dtype=dtype, ranks=ranks, rank=rank)
    r = 2 if use_checkpoint else 1
    out = {name: 0 for name in KERNELS}
    out.update(flash_attn_fwd=r * u["flash_attn_fwd"],
               flash_attn_fwd_wide=r * u["flash_attn_fwd_wide"],
               flash_attn_bwd_dq=u["k1_grad"], flash_attn_bwd_dkv=u["k1_grad"],
               temporal_block=r * u["temporal_block"],
               temporal_core=r * u["temporal_core"],
               group_norm=r * u["gn_blocks"] + u["gn_other"],
               group_norm_stats=r * u["gn_split"], group_norm_apply=r * u["gn_split"])
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
    core), rendered by the port in ``reference_mode()``.  (18, res, res, 4)
    float32 numpy in [0, 1]: rgb on white, then the rendered silhouette
    (accumulated opacity)."""
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
        outs = [render(g, cam, bg, config=RasterizeConfig(max_per_coarse=2048))
                for cam in orbit_cameras(18, resolution=res)]
    views = [torch.cat([o.image, o.alpha[..., None]], -1) for o in outs]
    return torch.stack(views).clamp(0, 1).cpu().numpy()


def gs_fit_launches(iters: int, renders: int) -> dict:
    """Launches of a fit of ``iters`` steps (one K4 call and one K5 a step)
    followed by ``renders`` renders (one K4 call each)."""
    out = {name: 0 for name in KERNELS}
    out.update(gs_composite_fwd=iters + renders, gs_composite_bwd=iters)
    return out


def fit_grad_check(frames, dev, phase: str, lpips_fn=None, cams=None,
                   radius: float = 2.0, **config) -> None:
    """The fit recipe's first step on view 0 (the init made anisotropic and
    rotated), its loss and every gradient with the kernels against
    ``reference_mode()``: loss rel 1e-5, each field's max abs <=
    GS_GRAD_REL x max |plain|.  The views: ``cams`` (3DGS cameras with
    their images), else the orbit on ``frames``; the init in a ball of
    ``radius``.  ``config`` overrides GSTrainConfig fields."""
    import torch

    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
    from v3d_tpu_torch.ops import reference_mode

    cfg = GSTrainConfig(**{**dict(lambda_dssim=1.0, opacity_reset_mode="none",
                                  opacity_decay=0.995), **config})
    if cams is None:
        cams = orbit_cameras(frames.shape[0], resolution=frames.shape[1],
                             images=list(frames))
    tr = GSTrainer(cams, cfg, num_pts=FIT_POINTS, capacity=FIT_CAPACITY, seed=0,
                   radius=radius, lpips_fn=lpips_fn, device=dev)
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
    say(phase, f"step-1 gradients at {cams[0].width}x{cams[0].height} (lambda_dssim "
        f"{cfg.lambda_dssim:g}, lambda_lpips {cfg.lambda_lpips:g}), kernels vs "
        f"reference_mode(): loss "
        f"{loss_k:.7f} vs {loss_p:.7f}; max_abs / max|plain| "
        + ", ".join(f"{k} {e / sc:.2e}" for k, (e, sc) in rows.items())
        + f" (<= {GS_GRAD_REL:g}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"fit gradients disagree: {loss_k} {loss_p} {rows}")
    del tr, gk, gp, grads
    torch.cuda.empty_cache()


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
    from v3d_tpu_torch.gs.losses import psnr as gs_psnr
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    t = frames.shape[0]
    fit_grad_check(frames, dev, "6 fit")

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
    expect = gs_fit_launches(FIT_ITERS, t)
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


def grad_cosines(gk: dict, gp: dict):
    """The cosine of each tensor's gradient with the kernels (``gk``) with
    the plain one (``gp``), the three lowest, and both global norms."""
    import torch

    names = list(gp)
    stats = torch.stack([torch.stack([(gk[k].double() * gp[k].double()).sum(),
                                      gk[k].double().norm(), gp[k].double().norm()])
                         for k in names]).tolist()
    cos = {k: (dot / (na * nb) if na * nb > 0 else float(na == nb))
           for k, (dot, na, nb) in zip(names, stats)}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    return (cos, worst, math.sqrt(sum(na * na for _, na, _ in stats)),
            math.sqrt(sum(nb * nb for _, _, nb in stats)))


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
    cos, worst, norm_k, norm_p = grad_cosines(gk, gp)
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
    without checkpointing (peak memory) and a profile of two steps.  The
    engine goes on to phase 18."""
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
    data.close()

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
            "no_checkpoint": nock, "losses": losses, "ab": ab, "engine": engine}


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


SCENE_COLOURS = ((0.85, 0.35, 0.2), (0.2, 0.45, 0.8))   # sphere, box


def render_scene(poses, res: int, fov: float = 60.0, dirs=None, origins=None,
                 colours=SCENE_COLOURS, with_normals: bool = False, device="cuda"):
    """Sphere-trace the scene on the card through NeuS's own rays (OpenGL
    poses, pixel-centre directions): per-region colours under a fixed
    light, white background.  ``dirs``: camera-space directions (H, W, 3),
    or (N, H, W, 3) one set a pose (default: res^2 at ``fov``);
    ``origins`` (H, W, 3): camera-space ray origins of an orthographic
    camera (default: the pose's centre).  -> (images (N, H, W, 3), masks
    (N, H, W)[, world normals (N, H, W, 3), 0 off the surface]) float32
    numpy."""
    import numpy as np
    import torch

    from v3d_tpu_torch.data.cameras import fov2focal, get_ray_directions

    dev = torch.device(device)
    if dirs is None:
        dirs = get_ray_directions(res, res, fov2focal(np.deg2rad(fov), res))
    h, w = dirs.shape[-3:-1]
    dirs = torch.tensor(dirs, device=dev).reshape(-1, h * w, 3)
    if origins is not None:
        origins = torch.tensor(origins, device=dev).reshape(-1, 3)
    colours = torch.tensor(colours, device=dev)
    light = torch.nn.functional.normalize(torch.tensor([0.4, -0.5, 0.75], device=dev), dim=0)
    images, masks, normals = [], [], []
    for i, c2w in enumerate(poses):
        c2w = torch.tensor(np.asarray(c2w, np.float32), device=dev)
        d = torch.nn.functional.normalize(dirs[i % dirs.shape[0]] @ c2w[:3, :3].T, dim=-1)
        o = (c2w[:3, 3].expand_as(d) if origins is None
             else origins @ c2w[:3, :3].T + c2w[:3, 3])
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
        images.append(rgb.reshape(h, w, 3))
        masks.append(hit.reshape(h, w).float())
        normals.append(torch.where(hit[:, None], n, 0.0).reshape(h, w, 3))
    out = (torch.stack(images).cpu().numpy().astype(np.float32),
           torch.stack(masks).cpu().numpy())
    if with_normals:
        out += (torch.stack(normals).cpu().numpy(),)
    return out


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
REFINE_BUDGET_S = 20.0    # cut from 60 s (30 s in PR 13) to keep the script in half its limit
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

# ---------------------------------------------------------------------------
# phases 18-20: the training stack's remaining paths
PNG_OBJECTS = 2               # objects of 18 RGBA PNGs at 512^2 (phase 18)
PNG_STEPS = 4                 # train() steps on them
LATENT_MIN_PSNR = 40.0        # dB: one batch's encode, kernels vs reference_mode()
AE_BATCH, AE_SIZE = 4, 256    # the JAX AutoencoderTrainer's default image_size
AE_STEPS, AE_DISC_START = 8, 4
AE_LOSS_REL = 1e-4            # generator step, kernels vs reference_mode(), f32
AE_MIN_COS = 0.9999           # cosine of each parameter tensor's gradient
AE_ZERO_GRAD_REL = 1e-6       # the key biases' gradients (0 exactly) against the whole
NERF_HW = 64                  # PixelNeRF targets at the latent grid (phase 20)
NERF_CPU_MAX_ABS = 1e-4       # rgb and features, card vs CPU
NERF_LOSS_REL = 1e-5          # the PixelNeRF diffusion loss, card vs CPU


def png_train_launches(engine, hw: int = 64) -> dict:
    """Launches of one fine-tune step on PNG orbits (batch 1): the step
    (``train_launches``), two VAE encodes under no_grad (the frames, the
    noised front view) and one CLIP forward of the front view."""
    import torch

    enc = _summed(vae_sites(engine.vae_encoder, hw * hw, torch.float32),
                  {"group_norm": count_group_norms(engine.vae_encoder)})
    return _summed(train_launches(engine.unet, hw), _scaled(enc, 2), clip_sites(engine.clip))


def write_png_orbits(root: str, rgba) -> str:
    """PNG_OBJECTS directories of the orbit ``rgba`` (t, H, W, 4) in [0, 1] as
    8-bit RGBA PNGs; object i starts its orbit at view 9 i (another front
    view).  Returns the data root."""
    import os

    import numpy as np
    from PIL import Image

    data = os.path.join(root, "orbits")
    u8 = np.round(np.clip(rgba, 0, 1) * 255).astype(np.uint8)
    for i in range(PNG_OBJECTS):
        d = os.path.join(data, f"obj{i}")
        os.makedirs(d)
        for v, frame in enumerate(np.roll(u8, -9 * i, axis=0)):
            Image.fromarray(frame, "RGBA").save(os.path.join(d, f"{v:03d}.png"))
    return data


def phase_png_train(engine, rgba, dev) -> dict:
    """Fine-tuning from rendered PNG orbits through ``apps.train_diffusion.train``
    on phase 8's engine (built here when phase 8 did not run): the encode on the way in (VAE of 18 frames and of
    the noised front view, CLIP of the front view), timed; one batch's
    encode with the kernels against ``reference_mode()`` on the same draws;
    PNG_STEPS steps with prefetch and a log directory, launches exact
    (``png_train_launches``), the rows of metrics.csv."""
    import os
    import shutil
    import tempfile

    import torch

    from v3d_tpu_torch.apps.train_diffusion import build_train_engine, prepare_batch, train
    from v3d_tpu_torch.data.objaverse import OrbitItemConfig, OrbitRenderDataset
    from v3d_tpu_torch.models.clip_vit import clip_preprocess
    from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts

    phase = "18 png train"
    t_phase = time.perf_counter()
    engine = engine or build_train_engine(device=dev)
    t = engine.num_frames
    root = tempfile.mkdtemp(prefix="v3d_png_")
    try:
        t0 = time.perf_counter()
        data = write_png_orbits(root, rgba)
        say(phase, f"{PNG_OBJECTS} objects x {t} RGBA PNGs at {rgba.shape[1]}^2 (phase 6's "
            f"scene, alpha its silhouette: mean {rgba[..., 3].mean():.3f}) written in "
            f"{time.perf_counter() - t0:.2f} s")
        batch = next(OrbitRenderDataset(data, OrbitItemConfig(num_frames=t)).iter_batches(1))
        frames = torch.as_tensor(batch["frames"], device=dev)
        cond = torch.as_tensor(batch["cond_frames"], device=dev)
        front = torch.as_tensor(batch["cond_frames_without_noise"], device=dev)
        gen = torch.Generator(device=dev).manual_seed(18)

        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t1)

        for _ in range(2):   # the second, warm, is reported
            enc_ms = {"vae_frames": timed(lambda: engine.encode_first_stage(frames, generator=gen)),
                      "vae_cond": timed(lambda: engine.encode_first_stage(cond, generator=gen)),
                      "clip": timed(lambda: engine.clip(clip_preprocess(front).permute(0, 3, 1, 2)))}
        got = prepare_batch(engine, batch, t, torch.Generator(device=dev).manual_seed(5))
        with reference_mode():
            ref = prepare_batch(engine, batch, t, torch.Generator(device=dev).manual_seed(5))
        p_lat = psnr(got["latents"], ref["latents"])
        p_cond = psnr(got["cond"]["concat"], ref["cond"]["concat"])
        p_clip = psnr(got["cond"]["crossattn"], ref["cond"]["crossattn"])
        clip_abs = float((got["cond"]["crossattn"] - ref["cond"]["crossattn"]).abs().max())
        ok = min(p_lat, p_cond, p_clip) >= LATENT_MIN_PSNR
        say(phase, f"encode on the way in (f32, warm, host clock, synchronised): VAE of "
            f"{t} frames {enc_ms['vae_frames']:.1f} ms, of the cond frame "
            f"{enc_ms['vae_cond']:.1f} ms, CLIP of the front view {enc_ms['clip']:.1f} ms | "
            f"kernels vs reference_mode(), same draws: latents {tuple(got['latents'].shape)} "
            f"PSNR {p_lat:.1f} dB, cond latent {p_cond:.1f} dB (>= {LATENT_MIN_PSNR:g}), "
            f"CLIP embedding {p_clip:.1f} dB (max abs {clip_abs:.2e}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"PNG encode: PSNR {p_lat}, {p_cond}, CLIP {p_clip}")
        del got, ref, frames, cond, front

        marks, stats = [], []

        def record(s_):
            marks.append(time.perf_counter())
            stats.append(s_)

        log_dir = os.path.join(root, "logs")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        marks.append(time.perf_counter())
        train(data, num_frames=t, max_steps=PNG_STEPS, engine=engine, log_every=1,
              log_fn=record, log_dir=log_dir)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = png_train_launches(engine)
        expect = _scaled(per_step, PNG_STEPS)
        with open(os.path.join(log_dir, "metrics.csv")) as f:
            rows = f.read().splitlines()
        steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        losses = [s_["loss"] for s_ in stats]
        ok = (counts == expect and len(stats) == PNG_STEPS and len(rows) == PNG_STEPS + 1
              and all(math.isfinite(x) for x in losses + [s_["grad_norm"] for s_ in stats]))
        say(phase, f"train(data=<{PNG_OBJECTS} PNG orbits>, prefetch, log_dir) {PNG_STEPS} "
            f"steps: ms per step (host clock, the encode included) "
            f"{[round(x, 1) for x in steps_ms]}, median of steps 2-{PNG_STEPS} "
            f"{statistics.median(steps_ms[1:]):.1f} | peak {peak:.2f} GiB | loss "
            f"{[round(x, 5) for x in losses]} | launches per step "
            f"{ {k: v / PNG_STEPS for k, v in counts.items() if v} } (expect "
            f"{ {k: v for k, v in per_step.items() if v} }) | {'ok' if ok else 'FAIL'}")
        say(phase, "metrics.csv: " + " / ".join(rows))
        if not ok:
            raise SmokeFailure(f"PNG fine-tune: launches {counts} (expect {expect}), "
                               f"losses {losses}, csv rows {len(rows)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(phase, f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": counts, "step_ms": statistics.median(steps_ms[1:]),
            "encode_ms": enc_ms, "peak_gib": peak}


def ae_launches(trainer) -> dict:
    """Launches of one reconstruction (an encode and a decode, f32) under
    the routing set now: the GroupNorms of both and the attention of their
    AttnBlocks (V3D's geometry: the two mid blocks, at the latent grid)."""
    import torch

    tokens = (AE_SIZE // 2 ** (len(trainer.encoder.down) - 1)) ** 2
    return _summed(vae_sites(trainer.encoder, tokens, torch.float32),
                   vae_sites(trainer.decoder, tokens, torch.float32),
                   {"group_norm": count_group_norms(trainer.encoder)
                    + count_group_norms(trainer.decoder)})


def ae_grad_check(trainer, x, backend: str) -> dict:
    """One generator step's objective and its gradients (every encoder and
    decoder tensor), with the kernels and in ``reference_mode()``, on the
    same images and draw, under ``set_default_backend(backend)``; the kernel
    run's launches must be one reconstruction's."""
    import torch

    from v3d_tpu_torch.ops import reference_mode

    phase = "19 ae"
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(19)
    with torch.no_grad():
        z = trainer.encoder(x)
    noise = torch.randn((x.shape[0], z.shape[2], z.shape[3], z.shape[1] // 2),
                        device=dev, generator=gen)
    names = [n for n, _ in trainer.encoder.named_parameters(prefix="encoder")] + \
        [n for n, _ in trainer.decoder.named_parameters(prefix="decoder")]
    runs = []
    with routing(backend=backend):
        expect = ae_launches(trainer)
        for mode in (contextlib.nullcontext, reference_mode):
            def step():
                with mode():
                    total, _ = trainer.generator_loss(x, noise)
                    grads = torch.autograd.grad(total, trainer.ae_params)
                return float(total.detach()), dict(zip(names, grads))
            (loss, grads), counts, secs = _counted(step)
            runs.append((loss, grads, counts, secs))
    (loss_k, gk, counts, sec_k), (loss_p, gp, counts_p, sec_p) = runs
    # the AttnBlocks' key biases: softmax(q . (k + b)) = softmax(q . k) for
    # every query, so their gradient is 0 in exact arithmetic and its cosine
    # is rounding's; they are held to a norm below AE_ZERO_GRAD_REL of the
    # whole gradient's on both sides instead
    zero = {k: (float(gk[k].norm()), float(gp[k].norm())) for k in gp if k.endswith(".k.bias")}
    cos, worst, norm_k, norm_p = grad_cosines({k: gk[k] for k in gp if k not in zero},
                                              {k: gp[k] for k in gp if k not in zero})
    rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = (counts == expect and not any(counts_p.values()) and rel <= AE_LOSS_REL
          and all(c >= AE_MIN_COS for c in cos.values())
          and all(max(v) <= AE_ZERO_GRAD_REL * norm_p for v in zero.values()))
    say(phase, f"generator step under \"{backend}\", kernels vs reference_mode() (same "
        f"images, draw): loss {loss_k:.7f} vs {loss_p:.7f} (rel {rel:.2e} <= {AE_LOSS_REL:g}) | "
        f"gradient norm {norm_k:.6e} vs {norm_p:.6e} | cosine per tensor: min "
        f"{worst[0][1]:.7f} (>= {AE_MIN_COS:g}) over {len(cos)} tensors, lowest "
        f"{[(k, round(c, 7)) for k, c in worst]}; key biases' gradient norms (kernels, "
        f"plain) { {k: (f'{a:.2e}', f'{b:.2e}') for k, (a, b) in zero.items()} } (<= "
        f"{AE_ZERO_GRAD_REL:g} x {norm_p:.3e}) | {sec_k:.2f} s vs {sec_p:.2f} s | launches "
        f"{ {k: v for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in expect.items() if v} }) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"AE gradients under {backend}: loss {loss_k} {loss_p}, "
                           f"lowest cosines {worst}, launches {counts}")
    return counts


def phase_ae(rgb, dev) -> dict:
    """The autoencoder trainer at V3D's first-stage geometry (ch 128,
    ch_mult (1, 2, 4, 4), 2 res blocks, z 4, double_z, no down-path
    attention), seeded, on AE_BATCH views of phase 6's scene at AE_SIZE^2
    with ``NLayerDiscriminator()``: one generator step's gradients with the
    kernels against ``reference_mode()`` under the default backend and
    under "flash" (K9, d = 512, f32, its backward recomputed), then
    AE_STEPS steps (the discriminator's from AE_DISC_START), launches exact
    (``ae_launches`` per reconstruction)."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.engines.ae_trainer import AETrainConfig, AutoencoderTrainer
    from v3d_tpu_torch.engines.builder import seeded_init_
    from v3d_tpu_torch.models.vae import Decoder, Encoder

    phase = "19 ae"
    t_phase = time.perf_counter()
    kw = dict(ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4,
              attn_resolutions=(), resolution=AE_SIZE)
    trainer = AutoencoderTrainer(
        seeded_init_(Encoder(double_z=True, **kw).to(dev), 190),
        seeded_init_(Decoder(out_ch=3, **kw).to(dev), 191),
        AETrainConfig(disc_start=AE_DISC_START), seed=19, device=dev)
    views = torch.as_tensor(rgb[[0, 4, 9, 13]], device=dev).permute(0, 3, 1, 2)
    images = F.interpolate(views, size=(AE_SIZE, AE_SIZE), mode="area").permute(0, 2, 3, 1)
    images = images * 2 - 1
    n = [sum(p.numel() for p in m.parameters())
         for m in (trainer.encoder, trainer.decoder, trainer.disc)]
    say(phase, f"AutoencoderTrainer: encoder {n[0]:,}, decoder {n[1]:,}, discriminator "
        f"{n[2]:,} parameters (seeded, f32); {AE_BATCH} images at {AE_SIZE}^2; Adam "
        f"(lr {trainer.cfg.lr:g}, betas 0.5 / 0.9) x 2, disc_start {AE_DISC_START}")
    x = trainer.images(images)
    flash = ae_grad_check(trainer, x, "flash")
    ae_grad_check(trainer, x, "auto")
    per_recon = ae_launches(trainer)
    expect = _scaled(per_recon, AE_STEPS + AE_STEPS - AE_DISC_START)
    times, logs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        for _ in range(AE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs.append(trainer.train_step(images))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))

    _, counts, secs = _counted(run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen_ms = statistics.median(times[1:AE_DISC_START])
    both_ms = statistics.median(times[AE_DISC_START + 1:])
    finite = all(math.isfinite(v) for lg in logs for v in lg.values())
    ok = (counts == expect and finite and all("g" in lg for lg in logs)
          and ["d_loss" in lg for lg in logs] == [i >= AE_DISC_START for i in range(AE_STEPS)])
    say(phase, f"{AE_STEPS} train_steps (default routing, host clock, synchronised): ms "
        f"{[round(v, 1) for v in times]} | generator step {gen_ms:.1f} ms (median of steps "
        f"2-{AE_DISC_START}), discriminator step {both_ms - gen_ms:.1f} ms (steps "
        f"{AE_DISC_START + 2}-{AE_STEPS} less the generator's) | peak {peak:.2f} GiB | loss "
        f"{[round(lg['loss'], 5) for lg in logs]} | g {[round(lg['g'], 4) for lg in logs]} | "
        f"d_loss {[round(lg['d_loss'], 4) for lg in logs if 'd_loss' in lg]} | launches "
        f"{ {k: v for k, v in counts.items() if v} } (expect "
        f"{ {k: v for k, v in expect.items() if v} }: {AE_STEPS + AE_STEPS - AE_DISC_START} "
        f"reconstructions) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"AE trainer: launches {counts} (expect {expect}), logs {logs}")
    say(phase, f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": _summed(counts, flash), "gen_ms": gen_ms,
            "disc_ms": both_ms - gen_ms, "peak_gib": peak}


def phase_pixelnerf(rgb, dev) -> dict:
    """PixelNeRF at the JAX defaults (32 samples, feat_dim 64,
    out_feature_dim 4) with the ResUNet encoder, seeded, on view 0 of phase
    6's scene at 512^2: 18 targets at NERF_HW^2 on the orbit cameras of
    ``data/cameras.py``, the stratified jitter drawn once; then the forward
    and backward of ``StandardDiffusionLossWithPixelNeRFLoss`` on a
    closed-form denoiser whose network adds the rendered features (V3D's
    concat channels), the rendered rgb against the 18 views at NERF_HW^2.
    The card against the CPU on the same inputs; no kernel of csrc/ runs."""
    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.data.cameras import fov2focal, get_uniform_poses
    from v3d_tpu_torch.diffusion import (
        Denoiser,
        EDMSampling,
        EDMWeighting,
        VScalingWithEDMcNoise,
    )
    from v3d_tpu_torch.diffusion.loss import StandardDiffusionLossWithPixelNeRFLoss
    from v3d_tpu_torch.engines.builder import seeded_init_
    from v3d_tpu_torch.models.pixelnerf import PixelNeRF

    phase = "20 pixelnerf"
    t_phase = time.perf_counter()
    t, res = rgb.shape[0], rgb.shape[1]
    model = seeded_init_(PixelNeRF(encoder_type="resunet").to(dev), 20)
    c2ws = torch.tensor(get_uniform_poses(t, 2.0, 0.0))
    f = fov2focal(math.radians(60.0), res)
    K = torch.tensor([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    views = torch.as_tensor(rgb)
    src = views[0] * 2 - 1
    target = F.interpolate(views.permute(0, 3, 1, 2), size=(NERF_HW, NERF_HW),
                           mode="area").permute(0, 2, 3, 1) * 2 - 1
    cpu_gen = torch.Generator().manual_seed(20)
    jitter = torch.rand(model.num_samples, generator=cpu_gen)
    latents = torch.randn(t, NERF_HW, NERF_HW, 4, generator=cpu_gen)
    sigmas = EDMSampling()(t, generator=cpu_gen)
    noise = torch.randn(latents.shape, generator=cpu_gen)
    loss_fn = StandardDiffusionLossWithPixelNeRFLoss(sigma_sampler=EDMSampling(),
                                                     loss_weighting=EDMWeighting(1.0))

    def network(x, c_noise, cond, **kw):
        return x / (1 + c_noise.reshape(-1, 1, 1, 1) ** 2) + cond["concat"]

    def inputs(d):
        return [a.to(d) for a in (src, torch.linalg.inv(c2ws[0]), K, c2ws,
                                  K.expand(t, 3, 3))]

    def render(m, d):
        return m(*inputs(d), (NERF_HW, NERF_HW), jitter=jitter.to(d))

    def loss_and_grads(m, d):
        m.zero_grad(set_to_none=True)
        rgb_, feats = render(m, d)
        loss = loss_fn(network, Denoiser(VScalingWithEDMcNoise()),
                       {"concat": feats, "rgb": rgb_}, latents.to(d), sigmas=sigmas.to(d),
                       noise=noise.to(d), rgb_target=target.to(d)).mean()
        loss.backward()
        return rgb_.detach(), feats.detach(), float(loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (rgb_k, feats_k, loss_k), counts, secs = _counted(lambda: loss_and_grads(model, dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        render_ms = cuda_ms(lambda: render(model, dev), iters=5, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        loss_and_grads(model, dev)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 3
    grads_k = {k: p.grad.cpu() for k, p in model.named_parameters()}
    cpu = PixelNeRF(encoder_type="resunet")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    rgb_c, feats_c, loss_c = loss_and_grads(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    _, _, norm_k, norm_c = grad_cosines(grads_k, {k: p.grad for k, p in cpu.named_parameters()})
    err_rgb = float((rgb_k.cpu() - rgb_c).abs().max())
    err_feats = float((feats_k.cpu() - feats_c).abs().max())
    rel = abs(loss_k - loss_c) / abs(loss_c)
    ok = (not any(counts.values()) and max(err_rgb, err_feats) <= NERF_CPU_MAX_ABS
          and rel <= NERF_LOSS_REL and math.isfinite(loss_k)
          and tuple(rgb_k.shape) == (t, NERF_HW, NERF_HW, 3)
          and tuple(feats_k.shape) == (t, NERF_HW, NERF_HW, 4))
    n = sum(p.numel() for p in model.parameters())
    say(phase, f"PixelNeRF (ResUNet encoder, {n:,} parameters, seeded, f32; {model.num_samples} "
        f"samples) from a {res}^2 source, {t} targets at {NERF_HW}^2: render "
        f"{render_ms:.2f} ms (CUDA events, no grad), loss forward + backward {step_ms:.1f} ms "
        f"(host clock, synchronised) | peak {peak:.2f} GiB | card vs CPU ({cpu_s:.1f} s on "
        f"the CPU): rgb max abs {err_rgb:.2e}, features {err_feats:.2e} (<= "
        f"{NERF_CPU_MAX_ABS:g}), loss {loss_k:.7f} vs {loss_c:.7f} (rel {rel:.2e} <= "
        f"{NERF_LOSS_REL:g}), gradient norm {norm_k:.6e} vs {norm_c:.6e} | rgb mean "
        f"{float(rgb_k.mean()):.4f} | launches { {k: v for k, v in counts.items() if v} } "
        f"(expect none) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"PixelNeRF: rgb {err_rgb}, features {err_feats}, loss "
                           f"{loss_k} {loss_c}, launches {counts}")
    say(phase, f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()
    return {"launches": counts, "render_ms": render_ms, "step_ms": step_ms,
            "peak_gib": peak}


# phase 21: image diffusion at SD 2.1's width

IMAGE_STEPS = 50          # EulerEDMSampler steps of a txt2img sample
IMAGE_CFG = 5.0           # VanillaCFG scale
IMAGE_STRENGTH = 0.6      # img2img: the last 30 of 50 steps
IMAGE_RES = 512           # pixels (64^2 latents)


def build_image_engine(dev, seed: int = 0, **unet_kw):
    """SD 2.1's image pipeline with seeded bf16 weights on ``dev``: the
    UNet2D at the JAX UNetModel's defaults (``unet_kw`` overrides), the
    image VAE at V3D's first-stage geometry (ch 128, (1, 2, 4, 4), z 4),
    ``DiscreteDenoiser(EpsScaling, LegacyDDPMDiscretization)``, Euler with
    ``VanillaCFG``."""
    import torch

    from v3d_tpu_torch import diffusion as D
    from v3d_tpu_torch.engines.builder import materialise
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine
    from v3d_tpu_torch.models.unet2d import UNetModel
    from v3d_tpu_torch.models.vae import Decoder, Encoder

    with torch.device("meta"):
        mods = (UNetModel(**unet_kw), Encoder(double_z=True), Decoder(out_ch=3))
    unet, enc, dec = (materialise(m, dev, torch.bfloat16, seed + i)
                      for i, m in enumerate(mods))
    return ImageDiffusionEngine(
        unet=unet,
        denoiser=D.DiscreteDenoiser(scaling=D.EpsScaling(),
                                    discretization=D.LegacyDDPMDiscretization()),
        sampler=D.EulerEDMSampler(discretization=D.LegacyDDPMDiscretization(),
                                  num_steps=IMAGE_STEPS, guider=D.VanillaCFG(IMAGE_CFG)),
        vae_encoder=enc, vae_decoder=dec)


def image_forward_launches(unet) -> dict:
    """Launches of one CFG-doubled image-UNet forward at 64^2 latents on
    77 context tokens, under the routing set now."""
    u = unet2d_sites(unet, IMAGE_LATENT, 77)
    out = {name: 0 for name in KERNELS}
    out.update({k: u[k] for k in ATTENTION_KERNELS}, group_norm=u["group_norm"],
               layer_norm=count_layer_norms(unet))
    return out


def vae_launches(vae, tokens: int) -> dict:
    out = {name: 0 for name in KERNELS}
    out.update(vae_sites(vae, tokens), group_norm=count_group_norms(vae))
    return out


def _image_forward_check(engine, what: str) -> tuple:
    """One CFG-doubled UNet forward with the kernels against
    ``reference_mode()`` (PSNR >= UNET_MIN_PSNR, as phase 4), its launches
    exact; returns (PSNR, ms per forward)."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts

    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(IMAGE_BATCH, 4, IMAGE_LATENT, IMAGE_LATENT, device=dev, generator=gen)
    ts = torch.tensor([999.0, 250.0], device=dev)
    ctx = torch.randn(IMAGE_BATCH, 77, 1024, device=dev, generator=gen)

    def fwd():
        with torch.no_grad():
            return engine.unet(x, ts, ctx)

    reset_launch_counts()
    out = fwd()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    with reference_mode():
        ref = fwd()
    quality = psnr(out, ref)
    expect = image_forward_launches(engine.unet)
    ms = cuda_ms(fwd, iters=5, warmup=1)
    ok = (bool(torch.isfinite(out).all()) and out.dtype == torch.float32
          and quality >= UNET_MIN_PSNR and counts == expect)
    say("21 image", f"{what} UNet2D forward {tuple(out.shape)} bf16: kernels vs plain "
        f"PSNR {quality:.2f} dB (>= {UNET_MIN_PSNR:g}) | {ms:.3f} ms a forward "
        f"(CUDA events) | launches {_nonzero(counts)} (expect {_nonzero(expect)}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{what} UNet2D forward: {quality} dB, launches {counts}")
    return quality, ms


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def flux_launches(net) -> dict:
    """Launches of one no-grad FLUX.1 forward, counted from its modules: K9
    once a double or single block (the joint attention), K10 once an
    affine-free LayerNorm."""
    from v3d_tpu_torch.models.flux import DoubleStreamBlock, LayerNormNoAffine, SingleStreamBlock

    out = {name: 0 for name in KERNELS}
    out.update(
        flash_attn_fwd_wide=sum(isinstance(m, (DoubleStreamBlock, SingleStreamBlock))
                                for m in net.modules()),
        layer_norm=sum(isinstance(m, LayerNormNoAffine) for m in net.modules()))
    return out


def phase_flux(dev) -> dict:
    """FLUX.1-dev's transformer at its published widths and depth, seeded
    bf16 weights: the parameter count, one forward at 1024^2 with the
    kernels against the same forward in ``reference_mode()``, its launches
    (set to 0 just before it) against ``FLUX_LAUNCHES`` and the count from
    the modules; ms a forward (CUDA events), peak memory."""
    import torch

    from v3d_tpu_torch.engines.builder import materialise
    from v3d_tpu_torch.models.flux import Flux
    from v3d_tpu_torch.ops import LAUNCHES, reference_mode, reset_launch_counts

    phase = "29 flux"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        net = Flux().to(torch.bfloat16)
    net = materialise(net, dev, torch.bfloat16, 29)
    n = sum(p.numel() for p in net.parameters())
    say(phase, f"FLUX.1-dev transformer (19 + 38 blocks, hidden 3072, 24 heads of 128), "
        f"seeded bf16, built in {time.perf_counter() - t0:.1f} s | {n:,} parameters "
        f"(expect {FLUX_PARAMS:,}) | {'ok' if n == FLUX_PARAMS else 'FAIL'}")
    if n != FLUX_PARAMS:
        raise SmokeFailure(f"Flux has {n} parameters, FLUX.1-dev {FLUX_PARAMS}")
    tokens, hw = FLUX_TOKENS
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(1, 16, 2 * hw, 2 * hw, device=dev, generator=gen)
    t = torch.full((1,), 0.75, device=dev)
    ctx = torch.randn(1, tokens, 4096, device=dev, generator=gen)
    y = torch.randn(1, 768, device=dev, generator=gen)
    g = torch.full((1,), 3.5, device=dev)

    def fwd():
        with torch.no_grad():
            return net(x, t, ctx, y, g)

    reset_launch_counts()
    out = fwd()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    with reference_mode():
        ref = fwd()
    quality = psnr(out, ref)
    del ref
    expect = flux_launches(net)
    ms = cuda_ms(fwd, iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = (bool(torch.isfinite(out).all()) and out.shape == x.shape
          and out.dtype == torch.float32 and quality >= UNET_MIN_PSNR and counts == expect
          and all(expect[k] == v for k, v in FLUX_LAUNCHES.items()))
    say(phase, f"forward {tuple(out.shape)} at 1024^2 ({hw * hw} image + {tokens} text "
        f"tokens): kernels vs plain PSNR {quality:.2f} dB (>= {UNET_MIN_PSNR:g}) | "
        f"{ms:.3f} ms a forward (CUDA events) | launches {_nonzero(counts)} (expect "
        f"{_nonzero(expect)}, FLUX.1-dev {FLUX_LAUNCHES}) | peak {peak:.2f} GiB | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"FLUX.1 forward: {quality} dB, launches {counts}")
    del net, out
    torch.cuda.empty_cache()
    return {"launches": counts, "psnr": quality, "ms": ms, "peak_gib": peak}


def phase_image(dev) -> dict:
    """The image-diffusion path at SD 2.1's width: the parameter count
    against the JAX UNetModel's, one forward against ``reference_mode()``
    (and the narrower ``use_scale_shift_norm`` net's), then on one engine a
    50-step txt2img sample, its decode, the encode of a synthetic 512^2
    image and img2img at strength 0.6, the launch counts set to 0 before
    the four and read after; then the V3D-512 engine of
    configs/v3d_512.yaml against ``build_v3d_engine``'s."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    phase = "21 image"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    engine = build_image_engine(dev)
    n = sum(p.numel() for p in engine.unet.parameters())
    say(phase, f"SD-2.1-width UNet2D (320, (1, 2, 4, 4), attention at ds 1/2/4, heads "
        f"of 64, context 1024, linear projections) + image VAE, seeded bf16, built "
        f"in {time.perf_counter() - t0:.1f} s | UNet {n:,} parameters (the JAX "
        f"UNetModel's, by jax.eval_shape: {UNET2D_PARAMS:,}) | "
        f"{'ok' if n == UNET2D_PARAMS else 'FAIL'}")
    if n != UNET2D_PARAMS:
        raise SmokeFailure(f"UNet2D has {n} parameters, the JAX module {UNET2D_PARAMS}")
    quality, forward_ms = _image_forward_check(engine, "SD 2.1")

    gen = torch.Generator(device=dev).manual_seed(21)
    ctx = torch.randn(1, 77, 1024, device=dev, generator=gen)
    c, uc = {"crossattn": ctx}, {"crossattn": torch.zeros_like(ctx)}
    image = torch.tensor(synthetic_image(IMAGE_RES)[..., :3] / 127.5 - 1.0,
                         dtype=torch.float32, device=dev)[None]
    fwd = image_forward_launches(engine.unet)
    runs = max(1, int(round(IMAGE_STEPS * IMAGE_STRENGTH)))
    stages, times, counts = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for name, fn in (
            ("sample", lambda: engine.sample(c, uc, 1, IMAGE_RES, IMAGE_RES, generator=gen)),
            ("decode", lambda: engine.decode(stages["sample"])),
            ("encode", lambda: engine.encode(image, generator=gen)),
            ("img2img", lambda: engine.img2img(stages["encode"], c, uc, IMAGE_STRENGTH,
                                               generator=gen))):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        stages[name] = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    total = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = {"sample": _scaled(fwd, IMAGE_STEPS),
              "decode": vae_launches(engine.vae_decoder, IMAGE_LATENT ** 2),
              "encode": vae_launches(engine.vae_encoder, IMAGE_LATENT ** 2),
              "img2img": _scaled(fwd, runs)}
    shapes = {"sample": (1, IMAGE_LATENT, IMAGE_LATENT, 4),
              "decode": (1, IMAGE_RES, IMAGE_RES, 3),
              "encode": (1, IMAGE_LATENT, IMAGE_LATENT, 4),
              "img2img": (1, IMAGE_LATENT, IMAGE_LATENT, 4)}
    ok = (all(counts[k] == expect[k] for k in expect)
          and total == _summed(*expect.values())
          and all(tuple(stages[k].shape) == shapes[k]
                  and bool(torch.isfinite(stages[k]).all()) for k in shapes)
          and 0.0 <= float(stages["decode"].min()) <= float(stages["decode"].max()) <= 1.0)
    say(phase, f"txt2img {IMAGE_STEPS} steps (Euler, DDPM eps, CFG {IMAGE_CFG:g}) at "
        f"{IMAGE_RES}^2: {times['sample']:.3f} s ({1e3 * times['sample'] / IMAGE_STEPS:.2f} "
        f"ms a step; {forward_ms:.3f} ms a UNet forward alone) | decode "
        f"{times['decode']:.3f} s | encode {times['encode']:.3f} s | img2img strength "
        f"{IMAGE_STRENGTH:g} ({runs} of {IMAGE_STEPS} steps) {times['img2img']:.3f} s | "
        f"peak {peak:.2f} GiB | latents std {float(stages['sample'].std()):.3f}, image "
        f"mean {float(stages['decode'].mean()):.3f}")
    say(phase, "launches (counts set to 0 before the four stages, read after each): "
        + "; ".join(f"{k} {_nonzero(counts[k])} (expect {_nonzero(expect[k])})"
                    for k in expect) + f" | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"image path: launches {counts}, expected {expect}")
    del engine, stages
    torch.cuda.empty_cache()

    narrow = build_image_engine(dev, seed=7, **UNET2D_SS_KW)
    ss_quality, ss_ms = _image_forward_check(
        narrow, f"use_scale_shift_norm ({UNET2D_SS_KW['model_channels']} channels)")
    del narrow
    torch.cuda.empty_cache()
    config = phase_config_engine(dev)
    say(phase, f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "psnr": quality, "forward_ms": forward_ms,
            "ss_psnr": ss_quality, "ss_forward_ms": ss_ms, "seconds": times,
            "peak_gib": peak, "config": config}


def phase_config_engine(dev) -> dict:
    """``engine_from_config(load_config("configs/v3d_512.yaml"))`` on the card
    against ``build_v3d_engine``, both at their default seeds: the same
    state-dict keys, shapes and dtypes in each module and every tensor bit
    for bit (the seeded init is the builder's), the config's 30-step
    sampler; one UNet forward of each bit for bit (cuDNN deterministic)."""
    import os

    import torch

    from v3d_tpu_torch.core.config import load_config
    from v3d_tpu_torch.engines.builder import build_v3d_engine
    from v3d_tpu_torch.engines.from_config import engine_from_config

    t0 = time.perf_counter()
    yaml_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                             "v3d_512.yaml")
    cfg_engine = engine_from_config(load_config(yaml_path), dtype=torch.bfloat16,
                                    device=dev)
    built_s = time.perf_counter() - t0
    ref = build_v3d_engine(device=dev, dtype=torch.bfloat16)
    same = weights_equal = True
    for name in ("unet", "vae_encoder", "vae_decoder", "clip"):
        a, b = getattr(cfg_engine, name).state_dict(), getattr(ref, name).state_dict()
        same &= list(a) == list(b) and all(
            a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
        weights_equal &= same and all(torch.equal(a[k], b[k]) for k in a)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [unet_forward_fn(e)() for e in (ref, cfg_engine)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    equal = torch.equal(*outs)
    n = sum(p.numel() for p in cfg_engine.unet.parameters())
    ok = (same and weights_equal and equal and cfg_engine.sampler.num_steps == 30
          and cfg_engine.unet.use_checkpoint and cfg_engine.num_frames == 18)
    say("21 config", f"engine_from_config(configs/v3d_512.yaml) on the card in "
        f"{built_s:.1f} s: UNet {n:,} parameters, sampler {cfg_engine.sampler.num_steps} "
        f"steps; keys / shapes / dtypes equal build_v3d_engine's: {same}; every "
        f"tensor bit for bit at the default seeds: {weights_equal}; a UNet forward "
        f"{tuple(outs[0].shape)} bit for bit equal: {equal} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"config engine: same {same}, weights {weights_equal}, "
                           f"equal {equal}")
    del cfg_engine, ref, outs
    torch.cuda.empty_cache()
    return {"same": same, "weights_equal": weights_equal, "equal": equal}


# phase 22: LPIPS and the scene CLIs

def write_seeded_lpips(path: str, seed: int = 0, dead_tap: bool = False) -> str:
    """A VGG16 + LPIPS-heads .npz in the JAX package's layout (no real
    weights ship with the repository): He-scaled conv kernels (HWIO), small
    biases, non-negative heads, from one numpy seed.  ``dead_tap`` sets the
    last tap's biases (relu5_3) to -100, so that tap is 0 for any image."""
    import numpy as np

    from v3d_tpu_torch.metrics.lpips import VGG_PLAN

    rs = np.random.RandomState(seed)
    out, cin, i = {}, 3, 0
    for spec in VGG_PLAN:
        if spec == "M":
            continue
        out[f"conv{i}_w"] = (rs.randn(3, 3, cin, spec) * math.sqrt(2.0 / (9 * cin))
                             ).astype(np.float32)
        out[f"conv{i}_b"] = (0.01 * rs.randn(spec)).astype(np.float32)
        cin, i = spec, i + 1
    if dead_tap:
        out["conv12_b"] = np.full_like(out["conv12_b"], -100.0)
    for li, c in enumerate((64, 128, 256, 512, 512)):
        out[f"lin{li}"] = (0.1 * np.abs(rs.randn(c))).astype(np.float32)
    np.savez(path, **out)
    return path


LPIPS_PAIRS = 4               # image pairs of the card-vs-CPU check, at 512^2
LPIPS_CPU_REL = 1e-5          # distances card vs CPU; input gradients TF32 on vs off
LPIPS_FIT_ITERS = 100         # the readme step-4 recipe's 4000 iterations, cut
LPIPS_FIT = dict(lambda_dssim=1.0, lambda_lpips=2.0)
REFINE_LPIPS_ITERS = 10       # refine iterations with lambda_lpips 1.0 (and without)


def _lpips_weights():
    """Seeded LPIPS weights written to a temporary .npz, pointed at by
    ``$V3D_TPU_LPIPS_WEIGHTS`` for the entry points; the directory and the
    variable's old value, to restore."""
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="v3d_lpips_")
    path = write_seeded_lpips(os.path.join(tmp, "lpips_vgg.npz"), seed=22)
    old = os.environ.get("V3D_TPU_LPIPS_WEIGHTS")
    os.environ["V3D_TPU_LPIPS_WEIGHTS"] = path
    return path, tmp, old


def phase_lpips(rgba, dev, fit_step_ms=None) -> dict:
    """LPIPS and its users at 512^2: the distance card vs CPU, its forward
    and forward + backward times; 100 iterations of phase 6's fit with the
    readme step-4 recipe (lambda_dssim 1, lambda_lpips 2) through
    ``train_from_frames`` (one step's gradients first against
    ``reference_mode()``); ``render_cli`` on its PLY (spiral: 54 frames,
    depth and orbit: 18) and ``metrics_cli`` on the orbit renders against
    the frames; refine iterations with lambda_lpips 1.0 and without on a
    sphere mesh the phase makes, and ``apps.refine.do_refine`` with it."""
    import os
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from v3d_tpu_torch.apps import metrics_cli, refine, render_cli
    from v3d_tpu_torch.apps.recon_gs import train_from_frames
    from v3d_tpu_torch.meshops.mcubes import isosurface
    from v3d_tpu_torch.meshops.mesh import Mesh
    from v3d_tpu_torch.meshops.refine import RefineConfig, TextureRefiner
    from v3d_tpu_torch.metrics.lpips import load_lpips, lpips_distance, lpips_params
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    phase = "22 lpips"
    t_phase = time.perf_counter()
    path, tmp, old_env = _lpips_weights()
    paths = {}
    try:
        frames = rgba[..., :3]
        t, res = frames.shape[:2]
        # the distance on the card against the CPU
        with np.load(path) as data:
            arrays = dict(data)
        params, params_cpu = lpips_params(arrays, dev), lpips_params(arrays, "cpu")
        x_np = frames[:LPIPS_PAIRS]
        y_np = frames[LPIPS_PAIRS:2 * LPIPS_PAIRS][:, ::-1].copy()
        x, y = torch.tensor(x_np, device=dev), torch.tensor(y_np, device=dev)
        xg = x.clone().requires_grad_()

        def input_grad():
            (g,) = torch.autograd.grad(lpips_distance(params, xg, y).sum(), xg)
            return g

        # with cuDNN's TF32 switch at PyTorch's default (on), as the entry
        # points run: LPIPS keeps its convolutions and their gradients in f32
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                d = lpips_distance(params, x, y).cpu()
            grad_on = input_grad()
            fwd_ms = cuda_ms(lambda: lpips_distance(params, x, y), iters=5)

            def fwd_bwd():
                lpips_distance(params, xg, y).sum().backward()

            bwd_ms = cuda_ms(fwd_bwd, iters=5)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        # the input gradient with the switch off: the same float32 math
        grad_off = input_grad()
        grad_rel = float((grad_on - grad_off).abs().max() / grad_off.abs().max())
        d_cpu = lpips_distance(params_cpu, torch.tensor(x_np), torch.tensor(y_np))
        rel = float((d - d_cpu).abs().max() / d_cpu.abs().max())
        ok = (rel <= LPIPS_CPU_REL and grad_rel <= LPIPS_CPU_REL
              and bool(torch.isfinite(d).all()))
        say(phase, f"LPIPS (VGG16, seeded weights) of {LPIPS_PAIRS} pairs at {res}^2, "
            f"f32 (process cuDNN TF32 on): distances {[round(float(v), 5) for v in d]}, "
            f"card vs CPU max rel {rel:.2e} (<= {LPIPS_CPU_REL:g}); input gradient "
            f"against the TF32-off process's max rel {grad_rel:.2e} (<= "
            f"{LPIPS_CPU_REL:g}) | forward {fwd_ms:.3f} ms, forward + backward "
            f"{bwd_ms:.3f} ms ({LPIPS_PAIRS} pairs, CUDA events) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"LPIPS card vs CPU: rel {rel}, gradient {grad_rel}")
        del x, y, xg, params, grad_on, grad_off

        # the fit with the readme step-4 recipe
        fit_grad_check(frames, dev, phase, lpips_fn=load_lpips(path, device=dev),
                       **LPIPS_FIT)
        marks = []

        def record(stats):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        out_dir = os.path.join(tmp, "fit")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_from_frames(
            frames, out_dir, iterations=LPIPS_FIT_ITERS, num_pts=FIT_POINTS,
            capacity=FIT_CAPACITY, test_every=1, log_fn=record, device=dev, **LPIPS_FIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect = gs_fit_launches(LPIPS_FIT_ITERS, t)
        steps = [b - a for a, b in zip(marks, marks[1:])]
        step_ms = 1e3 * statistics.median(steps[9:])
        ok = counts == expect and trainer.lpips_fn is not None
        say(phase, f"train_from_frames {LPIPS_FIT_ITERS} iterations (lambda_dssim 1, "
            f"lambda_lpips 2; the readme's 4000 cut) at {res}^2: {wall:.3f} s | ms per "
            f"step (median of steps 11-{LPIPS_FIT_ITERS}, host clock, synchronised) "
            f"{step_ms:.3f}, phase 6's without LPIPS "
            f"{'not run' if fit_step_ms is None else f'{fit_step_ms:.3f}'} | peak "
            f"{peak:.2f} GiB | launches {_nonzero(counts)} (expect {_nonzero(expect)}) "
            f"| {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"LPIPS fit: launches {counts}, expected {expect}")
        paths["lpips_fit"] = {"launches": counts}
        del trainer
        torch.cuda.empty_cache()

        # render_cli on the fit's PLY, metrics_cli on the orbit renders
        ply = os.path.join(out_dir, "point_cloud.ply")
        renders = os.path.join(tmp, "renders")
        reset_launch_counts()
        render_ms = {}
        for mode, num in (("spiral", 60), ("depth", t), ("orbit", t)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb, depth = render_cli.render_scene(ply, renders, mode, num, res, device=dev)
            torch.cuda.synchronize()
            render_ms[mode] = (len(rgb), 1e3 * (time.perf_counter() - t0) / len(rgb))
            if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
                raise SmokeFailure(f"render_cli {mode}: non-finite renders")
        counts = dict(LAUNCHES)
        expect = gs_fit_launches(0, sum(n for n, _ in render_ms.values()))
        gt = os.path.join(tmp, "gt")
        os.makedirs(gt)
        for i, f in enumerate(frames):
            Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(gt, f"{i:04d}.png"))
        t0 = time.perf_counter()
        scores = metrics_cli.evaluate(os.path.join(renders, "orbit"), gt, device=dev)
        metrics_s = time.perf_counter() - t0
        ok = (counts == expect and render_ms["spiral"][0] == 54
              and scores["n_images"] == t and "lpips" in scores
              and all(math.isfinite(scores[k]) for k in ("psnr", "ssim", "lpips")))
        say(phase, "render_cli at " f"{res}^2 (ms per frame, host clock, synchronised, PNG "
            "writes included): " + ", ".join(f"{m} {n} frames {ms:.2f}"
                                             for m, (n, ms) in render_ms.items())
            + f" | launches {_nonzero(counts)} (expect {_nonzero(expect)}) | metrics_cli "
            f"on the orbit renders vs the {t} frames: PSNR {scores['psnr']:.3f} dB, SSIM "
            f"{scores['ssim']:.4f}, LPIPS {scores['lpips']:.4f} in {metrics_s:.2f} s | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"render_cli / metrics_cli: {counts} {render_ms} {scores}")
        paths["render_cli"] = {"launches": counts}

        # refine with LPIPS on a sphere mesh made here
        verts, faces = isosurface(lambda p: np.linalg.norm(p, axis=-1) - 0.45, radius=1.0,
                                  resolution=128, coarse_resolution=32)
        mesh = Mesh(verts, faces)
        cfg = dict(iters=REFINE_LPIPS_ITERS, lambda_lpips=1.0)
        refine_ms = {}
        for name, lpips_fn in (("mse", None), ("mse + lpips", load_lpips(path, device=dev))):
            refiner = TextureRefiner(mesh, frames, RefineConfig(**cfg), lpips_fn=lpips_fn,
                                     device=dev)
            refiner.run(2)                        # warm-up
            stamps = []
            step = refiner.step

            def timed(slot, step=step, stamps=stamps):
                loss = step(slot)
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                return loss

            refiner.step = timed
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses = refiner.run(REFINE_LPIPS_ITERS)
            refine_ms[name] = (1e3 * statistics.median(
                [b - a for a, b in zip(stamps, stamps[1:])]), losses[0], losses[-1])
            del refiner
        np.save(os.path.join(tmp, "frames.npy"), (frames * 255).astype(np.uint8))
        mesh.write_obj(os.path.join(tmp, "sphere.obj"))
        t0 = time.perf_counter()
        refine.do_refine(os.path.join(tmp, "sphere.obj"), os.path.join(tmp, "frames.npy"),
                         os.path.join(tmp, "refined"), iters=REFINE_LPIPS_ITERS,
                         lambda_lpips=1.0, device=dev)
        app_s = time.perf_counter() - t0
        ok = (all(math.isfinite(v) for r in refine_ms.values() for v in r)
              and refine_ms["mse + lpips"][1] > refine_ms["mse"][1]
              and os.path.getsize(os.path.join(tmp, "refined", "refined.obj")) > 0)
        say(phase, f"refine of a {len(verts)}-vertex sphere against the {t} frames at "
            f"{res}^2, {REFINE_LPIPS_ITERS} iterations, ms per iteration (median, "
            f"synchronised): " + ", ".join(f"{k} {ms:.3f} (loss {a:.5f} -> {b:.5f})"
                                           for k, (ms, a, b) in refine_ms.items())
            + f" | apps.refine.do_refine --lambda-lpips 1.0, {REFINE_LPIPS_ITERS} "
            f"iterations and the writes: {app_s:.2f} s | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"refine with LPIPS: {refine_ms}")
    finally:
        if old_env is None:
            os.environ.pop("V3D_TPU_LPIPS_WEIGHTS", None)
        else:
            os.environ["V3D_TPU_LPIPS_WEIGHTS"] = old_env
        shutil.rmtree(tmp, ignore_errors=True)
    say(phase, f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# phases 23-24: posed scenes through recon_scene, and the other entry points

SCENE_KC = 4096               # recon_scene's --kc (the JAX CLI's default)
BLENDER_VIEWS, BLENDER_RES = 100, 800          # NeRF-synthetic's train split
BLENDER_FOV, BLENDER_RADIUS = 40.0, 4.0        # camera_angle_x, camera distance
BLENDER_ITERS = 500           # of recon_scene's 4000
LLFF_W, LLFF_H, LLFF_FOCAL = 1008, 756, 815.0  # LLFF's 4x-downsampled frames
LLFF_VIEWS, LLFF_POINTS = 20, 2000
LLFF_ITERS = 300
DTU_W, DTU_H, DTU_FOCAL = 800, 600, 1446.0     # img_downscale 2 of 1600 x 1200
DTU_VIEWS, DTU_RADIUS = 49, 3.0
DTU_STEPS, DTU_MC = 300, 128
EVAL_ITERS = 300              # full_eval's fit of each of its two orbits, of 4000
EVAL_RES = 512
ORTHO_RES, ORTHO_STEPS, ORTHO_MC = 512, 300, 128
SCENE_COLOURS_B = ((0.3, 0.7, 0.35), (0.75, 0.7, 0.2))  # the second orbit's


def _hemisphere_poses(n: int, radius: float, seed: int = 0):
    """``n`` seeded OpenGL poses on the upper hemisphere (elevation 5-80
    deg) looking at the origin, NeRF-synthetic's layout."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import c2w_from_up_and_look_at

    rs = np.random.RandomState(seed)
    az, el = rs.uniform(0, 2 * np.pi, n), np.deg2rad(rs.uniform(5, 80, n))
    pos = radius * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                             np.sin(el)], -1)
    return np.stack([c2w_from_up_and_look_at(np.array([0, 0, 1.0]), np.zeros(3), p,
                                             opengl=True) for p in pos])


def _save_png(path: str, arr) -> None:
    import numpy as np
    from PIL import Image

    Image.fromarray(np.round(np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def write_blender(root: str, frames, masks, c2ws, fov_deg: float) -> None:
    """NeRF-synthetic's layout: transforms_train.json (camera_angle_x,
    OpenGL transform_matrix) and RGBA PNGs, alpha the silhouette."""
    import json
    import os

    import numpy as np

    os.makedirs(root, exist_ok=True)
    entries = []
    for i, (img, m, c2w) in enumerate(zip(frames, masks, c2ws)):
        _save_png(os.path.join(root, f"r_{i}.png"), np.concatenate([img, m[..., None]], -1))
        entries.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": math.radians(fov_deg), "frames": entries}, f)


def write_colmap(root: str, frames, c2ws_gl, focal: float, n_points: int) -> None:
    """A COLMAP workspace: images/NNN.png and a binary sparse/0 model (one
    PINHOLE camera, OpenCV w2c poses, ``n_points`` seeded points on the
    scene's sphere)."""
    import os

    import numpy as np

    from v3d_tpu_torch.data.cam_paths import quat_from_matrix
    from v3d_tpu_torch.data.colmap import ColmapCamera, ColmapImage, write_model

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    h, w = frames.shape[1:3]
    images = {}
    for i, (img, c2w) in enumerate(zip(frames, c2ws_gl)):
        name = f"{i:03d}.png"
        _save_png(os.path.join(root, "images", name), img)
        cv = c2w.astype(np.float64).copy()
        cv[:, 1:3] *= -1
        w2c = np.linalg.inv(cv)
        images[i + 1] = ColmapImage(i + 1, quat_from_matrix(w2c[:3, :3]), w2c[:3, 3], 1, name)
    cams = {1: ColmapCamera(1, "PINHOLE", w, h, np.array([focal, focal, w / 2, h / 2]))}
    rs = np.random.RandomState(23)
    d = rs.randn(n_points, 3)
    xyz = np.array(SPHERE_C) + SPHERE_R * d / np.linalg.norm(d, axis=1, keepdims=True)
    rgb = np.tile((np.array(SCENE_COLOURS[0]) * 255).astype(np.uint8), (n_points, 1))
    write_model(os.path.join(root, "sparse", "0"), cams, images, (xyz, rgb))


def write_dtu(root: str, frames, masks, c2ws_gl, Ks) -> None:
    """DTU's layout: cameras.npz (world_mat_i = K [R | t] in a world that
    scale_mat_i maps the unit sphere into), image/NNNNNN.png, mask/NNN.png."""
    import os

    import numpy as np

    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    os.makedirs(os.path.join(root, "mask"), exist_ok=True)
    scale, shift = 2.5, np.array([10.0, -4.0, 30.0])
    S = np.eye(4)
    S[:3, :3] *= scale
    S[:3, 3] = shift
    mats = {}
    for i, (img, m, c2w, K) in enumerate(zip(frames, masks, c2ws_gl, Ks)):
        _save_png(os.path.join(root, "image", f"{i:06d}.png"), img)
        _save_png(os.path.join(root, "mask", f"{i:03d}.png"), m)
        cv = c2w.astype(np.float64).copy()
        cv[:, 1:3] *= -1
        cv[:3, 3] = scale * cv[:3, 3] + shift           # the centre in DTU's world
        w2c = np.linalg.inv(cv)
        P = np.eye(4)
        P[:3] = K @ w2c[:3]
        mats[f"world_mat_{i}"] = P
        mats[f"scale_mat_{i}"] = S
    np.savez(os.path.join(root, "cameras.npz"), **mats)


def _scene_run(phase: str, what: str, argv, expect: dict, steps: int, dev="cuda") -> tuple:
    """``apps.recon_scene.main(argv)`` with the launch counts set to 0 just
    before and read just after; per-step stamps through its ``log_fn``.
    Returns (result, launches, ms per step (median after 10), stats, wall s)."""
    import torch

    from v3d_tpu_torch.apps import recon_scene
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    marks, stats = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = recon_scene.main(argv + ["--log-every", "1", "--device", str(dev)],
                           log_fn=_step_recorder(marks, stats))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    steps_s = [b - a for a, b in zip(marks, marks[1:])]
    step_ms = 1e3 * statistics.median(steps_s[9:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = len(stats) == steps and all(math.isfinite(v) for st in stats for v in st.values())
    ok = counts == expect and finite
    say(phase, f"{what}: {wall:.2f} s (the load included) | ms per step (median of steps "
        f"11-{steps}, host clock, synchronised) {step_ms:.3f} | loss {stats[0]['loss']:.5f} "
        f"-> {stats[-1]['loss']:.5f} | peak {peak:.2f} GiB | launches {_nonzero(counts)} "
        f"(expect {_nonzero(expect)}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{what}: launches {counts} (expect {expect}), finite {finite}")
    return out, counts, step_ms, stats, wall


def dtu_views(dev="cuda") -> tuple:
    """The DTU scene at neus-dtu's downscale: 7 x 7 views in front of phase
    11's analytic scene, per-frame K, sphere-traced.  Returns (frames,
    masks, OpenGL c2ws, Ks, per-frame directions)."""
    import numpy as np

    from v3d_tpu_torch.data.cameras import c2w_from_up_and_look_at, get_ray_directions

    az, el = np.meshgrid(np.deg2rad(np.linspace(-60, 60, 7)),
                         np.deg2rad(np.linspace(5, 50, 7)))
    pos = DTU_RADIUS * np.stack([np.cos(el) * np.sin(az), -np.cos(el) * np.cos(az),
                                 np.sin(el)], -1).reshape(-1, 3)
    poses = np.stack([c2w_from_up_and_look_at(np.array([0, 0, 1.0]), np.zeros(3), p,
                                              opengl=True) for p in pos])
    focal = DTU_FOCAL + 2.0 * (np.arange(DTU_VIEWS) % 5 - 2)
    Ks = np.stack([np.array([[f, 0, DTU_W / 2 + 3.5], [0, f, DTU_H / 2 - 2.5],
                             [0, 0, 1.0]]) for f in focal])
    dirs = np.stack([get_ray_directions(DTU_H, DTU_W, K[0, 0], (K[0, 2], K[1, 2]))
                     for K in Ks])
    frames, masks = render_scene(poses, 0, dirs=dirs, device=dev)
    return frames, masks, poses, Ks, dirs


def phase_scenes(dev="cuda") -> dict:
    """Posed scenes through ``apps.recon_scene``: K4 / K5 against the plain
    compositor on one 1008 x 756 view (63 x 48 tiles, the last row 4 pixels
    tall) and one 800^2 view (50 x 50 tiles) of the seeded 100k-point init at
    Kc 4096, and a fit step's gradients there against ``reference_mode()``;
    then a blender scene at NeRF-synthetic's size (100 views at 800^2) for
    500 iterations, a COLMAP workspace at LLFF's (20 views at 1008 x 756,
    2000 points) through ``imgs2poses.gen_poses`` and 300 iterations, and a
    DTU scene at instant-nsr-pl's neus-dtu downscale (49 views at 800 x 600,
    per-frame K) through NeuS for 300 steps; every scene sphere-traced from
    phase 11's analytic scene."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from v3d_tpu_torch.apps import imgs2poses
    from v3d_tpu_torch.apps.recon_scene import scene_cameras
    from v3d_tpu_torch.data import scene_datasets as sd
    from v3d_tpu_torch.data.cameras import c2w_from_up_and_look_at, get_ray_directions
    from v3d_tpu_torch.gs.losses import psnr as gs_psnr

    phase = "23 scenes"
    t_phase = time.perf_counter()
    llff_fov = math.degrees(2 * math.atan(LLFF_W / (2 * LLFF_FOCAL)))
    checks = {"gs_composite_fwd": [], "gs_composite_bwd": []}
    for w, h, fov in ((LLFF_W, LLFF_H, llff_fov), (BLENDER_RES, BLENDER_RES, BLENDER_FOV)):
        slabs = fit_scene_slabs(dev, n=FIT_POINTS, kc=SCENE_KC, width=w, height=h,
                                fov=fov, radius=1.5)
        say(phase, f"{w}x{h}: {slabs.n_tx} x {slabs.n_ty} tiles, the last column "
            f"{w - 16 * (slabs.n_tx - 1)} and row {h - 16 * (slabs.n_ty - 1)} pixels; "
            f"{slabs.slab.shape[0]} coarse cells of Kc {slabs.slab.shape[1]}")
        # the plain versions take 0.6 s / 3-4 s a call here: two samples each
        k4, args, saved, pairs = k4_forward_check(slabs, phase, plain_iters=2)
        k5, _ = k5_backward_check(args, saved, pairs, k4["shape"], phase, plain_iters=2)
        checks["gs_composite_fwd"].append(k4)
        checks["gs_composite_bwd"].append(k5)
        del slabs, args, saved
        torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="v3d_scenes_")
    paths = {}
    try:
        # NeRF-synthetic's layout at its size
        poses = _hemisphere_poses(BLENDER_VIEWS, BLENDER_RADIUS)
        t0 = time.perf_counter()
        frames, masks = render_scene(poses, BLENDER_RES, fov=BLENDER_FOV, device=dev)
        root = os.path.join(tmp, "blender")
        write_blender(root, frames, masks, poses, BLENDER_FOV)
        say(phase, f"blender: {BLENDER_VIEWS} views at {BLENDER_RES}^2 (FoV "
            f"{BLENDER_FOV:g}, radius {BLENDER_RADIUS:g}, RGBA) rendered and written in "
            f"{time.perf_counter() - t0:.2f} s; foreground {masks.mean():.3f}")
        scene = sd.load_blender_scene(root)
        fit_grad_check(None, dev, phase, cams=scene_cameras(scene)[:2], radius=1.5,
                       lambda_dssim=0.2, max_per_coarse=SCENE_KC)
        del scene
        trainer, counts, step_ms, stats, _ = _scene_run(
            phase, f"recon_scene --format blender --method gs, defaults (100k points, "
            f"radius 1.5, Kc {SCENE_KC}), {BLENDER_ITERS} of 4000 iterations",
            ["--scene", root, "--output", os.path.join(tmp, "blender_out"),
             "--format", "blender", "--method", "gs", "--iterations", str(BLENDER_ITERS)],
            gs_fit_launches(BLENDER_ITERS, 0), BLENDER_ITERS, dev)
        view0 = float(gs_psnr(trainer.render_view(0).image, trainer.images[0]))
        say(phase, f"blender fit: view-0 PSNR {view0:.2f} dB, ms per step {step_ms:.3f}")
        paths["scene_blender"] = {"launches": counts}
        del trainer, frames, masks
        torch.cuda.empty_cache()

        # LLFF's size as a COLMAP workspace: forward-facing, 5 x 4 positions
        pos = [np.array([x, y, -3.0]) for y in np.linspace(-0.3, 0.3, 4)
               for x in np.linspace(-0.5, 0.5, 5)]
        poses = np.stack([c2w_from_up_and_look_at(np.array([0, 1.0, 0]), np.zeros(3), p,
                                                  opengl=True) for p in pos])
        dirs = get_ray_directions(LLFF_H, LLFF_W, LLFF_FOCAL)
        t0 = time.perf_counter()
        frames, _ = render_scene(poses, 0, dirs=dirs, device=dev)
        root = os.path.join(tmp, "llff")
        write_colmap(root, frames, poses, LLFF_FOCAL, LLFF_POINTS)
        summary = imgs2poses.gen_poses(root)
        ok = summary == {"cameras": 1, "images": LLFF_VIEWS, "points3d": LLFF_POINTS}
        say(phase, f"colmap: {LLFF_VIEWS} views at {LLFF_W}x{LLFF_H} (focal "
            f"{LLFF_FOCAL:g}) and a binary model of {LLFF_POINTS} points written in "
            f"{time.perf_counter() - t0:.2f} s; imgs2poses.gen_poses: {summary} | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"imgs2poses summary {summary}")
        scene = sd.load_colmap_scene(root)
        fit_grad_check(None, dev, phase, cams=scene_cameras(scene)[:2], radius=1.5,
                       lambda_dssim=0.2, max_per_coarse=SCENE_KC)
        del scene
        trainer, counts, step_ms, _, _ = _scene_run(
            phase, f"recon_scene --format colmap --method gs at {LLFF_W}x{LLFF_H}, "
            f"{LLFF_ITERS} iterations",
            ["--scene", root, "--output", os.path.join(tmp, "llff_out"),
             "--format", "colmap", "--method", "gs", "--iterations", str(LLFF_ITERS)],
            gs_fit_launches(LLFF_ITERS, 0), LLFF_ITERS, dev)
        img = trainer.render_view(0).image
        view0 = float(gs_psnr(img, trainer.images[0]))
        ok = tuple(img.shape) == (LLFF_H, LLFF_W, 3) and math.isfinite(view0)
        say(phase, f"colmap fit: render {tuple(img.shape)}, view-0 PSNR {view0:.2f} dB | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"colmap fit render {tuple(img.shape)} PSNR {view0}")
        paths["scene_colmap"] = {"launches": counts}
        del trainer, frames, img
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        frames, masks, poses, Ks, dirs = dtu_views(dev)
        root = os.path.join(tmp, "dtu")
        write_dtu(root, frames, masks, poses, Ks)
        say(phase, f"dtu: {DTU_VIEWS} views at {DTU_W}x{DTU_H} (per-frame K, focal "
            f"{DTU_FOCAL:g} +- 4) with masks and cameras.npz written in "
            f"{time.perf_counter() - t0:.2f} s; foreground {masks.mean():.3f}")
        (trainer, mesh), counts, step_ms, stats, wall = _scene_run(
            phase, f"recon_scene --format dtu --method neus, {DTU_STEPS} steps, "
            f"--mc-resolution {DTU_MC}",
            ["--scene", root, "--output", os.path.join(tmp, "dtu_out"), "--format", "dtu",
             "--method", "neus", "--iterations", str(DTU_STEPS),
             "--mc-resolution", str(DTU_MC)], gs_fit_launches(0, 0), DTU_STEPS, dev)
        ok = (trainer.directions.ndim == 4 and len(mesh.vertices) > 0
              and os.path.getsize(os.path.join(tmp, "dtu_out", "mesh.obj")) > 0)
        say(phase, f"dtu NeuS ({trainer.cfg.coarse_to_fine_samples} coarse + "
            f"{trainer.cfg.num_samples_per_ray} fine samples, {trainer.cfg.train_num_rays} "
            f"rays, per-frame directions {tuple(trainer.directions.shape)}): mesh "
            f"{len(mesh.vertices)} vertices {len(mesh.faces)} faces | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"dtu NeuS: mesh {len(mesh.vertices)}")
        del trainer, mesh, frames, masks, dirs
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(phase, f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return {"checks": checks, "paths": paths}


def write_wonder3d(root: str, name: str, res: int, device="cuda") -> None:
    """Wonder3D's output layout for the six fixed ortho views of phase 11's
    scene: normals_000_<view>.png (RGBA, normals in the front camera's
    OpenGL frame), rgb_000_<view>.png and masked_colors/rgb_000_<view>.png
    (RGBA, alpha the silhouette)."""
    import os

    import numpy as np

    from v3d_tpu_torch.data.cameras import get_ortho_ray_directions
    from v3d_tpu_torch.data.wonder3d import VIEW_TYPES, make_fixed_pose, rt_opengl2opencv
    from v3d_tpu_torch.nerf.normals import inv_RT

    obj = os.path.join(root, name)
    os.makedirs(os.path.join(obj, "masked_colors"), exist_ok=True)
    poses = []
    for view in VIEW_TYPES:
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = inv_RT(rt_opengl2opencv(make_fixed_pose(view)))
        c2w[:, 1:3] *= -1                       # OpenCV -> OpenGL
        poses.append(c2w)
    origins, dirs = get_ortho_ray_directions(res, res)
    frames, masks, normals = render_scene(poses, res, dirs=dirs, origins=origins,
                                          with_normals=True, device=device)
    front = inv_RT(rt_opengl2opencv(make_fixed_pose("front")))[:3, :3]
    for view, img, m, n in zip(VIEW_TYPES, frames, masks, normals):
        n_gl = (n @ front) * np.array([1.0, -1.0, -1.0])
        _save_png(os.path.join(obj, f"normals_000_{view}.png"),
                  np.concatenate([(n_gl + 1) / 2, m[..., None]], -1))
        _save_png(os.path.join(obj, f"rgb_000_{view}.png"), img)
        _save_png(os.path.join(obj, "masked_colors", f"rgb_000_{view}.png"),
                  np.concatenate([img, m[..., None]], -1))


def phase_entry_points(dev="cuda") -> dict:
    """The remaining entry points: ``apps.full_eval.run`` on two 18-frame
    512^2 orbits of phase 11's scene written as mp4 by ``write_video`` (300
    iterations each, launches exact); ``apps.recon_neus_ortho`` on the six
    Wonder3D views at 512^2 (fixed poses, normal maps) for 300 steps and
    the mesh at 128^3 with vertex colours; ``validate_ckpt --all`` on a
    directory of seeded LPIPS and U2Net .npz files, then on an empty one."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch import nn

    import cv2

    from v3d_tpu_torch.apps import full_eval, validate_ckpt
    from v3d_tpu_torch.apps.recon_neus_ortho import reconstruct_ortho
    from v3d_tpu_torch.data.cameras import get_uniform_poses
    from v3d_tpu_torch.data.video_io import read_video, write_video
    from v3d_tpu_torch.models.u2net import U2Net
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    phase = "24 entry points"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="v3d_entry_")
    paths = {}
    try:
        # full_eval on two mp4 orbits
        poses = get_uniform_poses(18, 2.0, 0.0, opengl=True)
        videos = []
        for name, colours in (("orbit_a", SCENE_COLOURS), ("orbit_b", SCENE_COLOURS_B)):
            frames, _ = render_scene(poses, EVAL_RES, colours=colours, device=dev)
            videos.append(os.path.join(tmp, f"{name}.mp4"))
            write_video(videos[-1], frames, fps=3)
        back = read_video(videos[0])
        say(phase, f"cv2 {cv2.__version__}: two orbits of 18 frames at 512^2 written as "
            f"mp4v ({os.path.getsize(videos[0]) / 2**10:.0f} KiB), read back "
            f"{back.shape} {back.dtype}")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = full_eval.run(videos, os.path.join(tmp, "eval"), EVAL_ITERS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        # per video: the fit, view 0 at its last log, the orbit.npy renders,
        # then the scored renders
        expect = gs_fit_launches(2 * EVAL_ITERS, 2 * (1 + 18 + 18))
        with open(os.path.join(tmp, "eval", "results.json")) as f:
            saved = json.load(f)
        ok = (counts == expect and saved == results and sorted(saved) == ["orbit_a", "orbit_b"]
              and all(math.isfinite(v[k]) for v in saved.values() for k in ("psnr", "ssim"))
              and os.path.getsize(os.path.join(tmp, "eval", "orbit_a", "spiral.mp4")) > 0)
        say(phase, f"full_eval.run: 2 videos x {EVAL_ITERS} iterations (of 4000) at 512^2: "
            f"{wall:.2f} s | results.json {json.dumps(saved)} | launches {_nonzero(counts)} "
            f"(expect {_nonzero(expect)}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"full_eval: {counts} (expect {expect}), {saved}")
        paths["full_eval"] = {"launches": counts}

        # Wonder3D ortho NeuS
        t0 = time.perf_counter()
        write_wonder3d(os.path.join(tmp, "w3d"), "scene", ORTHO_RES, dev)
        say(phase, f"Wonder3D layout: 6 ortho views at {ORTHO_RES}^2 with normal maps "
            f"written in {time.perf_counter() - t0:.2f} s")
        marks, stats = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer, mesh = reconstruct_ortho(
            os.path.join(tmp, "w3d"), "scene", os.path.join(tmp, "ortho"),
            im_size=ORTHO_RES, mc_resolution=ORTHO_MC, train_steps=ORTHO_STEPS,
            log_every=1, log_fn=_step_recorder(marks, stats), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in LAUNCHES.items() if v}
        step_ms = 1e3 * statistics.median([b - a for a, b in zip(marks, marks[1:])][9:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        colours = mesh.vertex_colors
        ok = (len(stats) == ORTHO_STEPS and len(mesh.vertices) > 0
              and all(math.isfinite(v) for st in stats for v in st.values())
              and colours is not None and colours.shape == mesh.vertices.shape
              and bool(np.isfinite(colours).all()))
        say(phase, f"recon_neus_ortho (card recipe: frequency + exact gradient, 128x4 MLP, "
            f"{trainer.cfg.num_samples_per_ray} samples), {ORTHO_STEPS} of 3000 steps at "
            f"{ORTHO_RES}^2: {wall:.2f} s with the export | ms per step (median of steps "
            f"11-{ORTHO_STEPS}) {step_ms:.3f} | loss {stats[0]['loss']:.5f} -> "
            f"{stats[-1]['loss']:.5f} (normal {stats[-1].get('normal', float('nan')):.5f}) | "
            f"mesh {len(mesh.vertices)} vertices {len(mesh.faces)} faces with colours | peak "
            f"{peak:.2f} GiB | launches {counts or 'none'} | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"recon_neus_ortho: mesh {len(mesh.vertices)}")
        del trainer, mesh
        torch.cuda.empty_cache()

        # validate_ckpt --all
        weights = os.path.join(tmp, "weights")
        os.makedirs(weights)
        write_seeded_lpips(os.path.join(weights, "lpips_vgg.npz"), seed=24)
        torch.manual_seed(24)
        u2 = U2Net(small=False)
        with torch.no_grad():
            for m in u2.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.weight.copy_(1 + 0.1 * torch.randn(m.num_features))
        np.savez(os.path.join(weights, "u2net.npz"),
                 **{k: v.numpy() for k, v in u2.state_dict().items()})
        codes = {}
        for name, d in (("weights", weights), ("empty", os.path.join(tmp, "none"))):
            os.makedirs(d, exist_ok=True)
            report_path = os.path.join(tmp, f"{name}.json")
            try:
                validate_ckpt.main(["--all", d, "--report", report_path, "--device", dev])
            except SystemExit as e:
                codes[name] = e.code
            with open(report_path) as f:
                codes[name + "_report"] = json.load(f)
        rep, empty = codes["weights_report"], codes["empty_report"]
        ok = (codes["weights"] == 0 and rep["ok"]
              and sorted(rep["stages"]) == ["lpips_ingest", "u2net_ingest"]
              and len(rep["plan"]) == 3 and codes["empty"] == 0 and empty["ok"]
              and not empty["stages"] and len(empty["plan"]) == 5)
        say(phase, "validate_ckpt --all: " + ", ".join(
            f"{k} {v['ok']} ({v.get('detail', v.get('error'))}, {v['s']} s)"
            for k, v in rep["stages"].items())
            + f", plan {len(rep['plan'])}, exit {codes['weights']} | empty directory: "
            f"plan {len(empty['plan'])}, exit {codes['empty']} | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"validate_ckpt --all: {codes}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(phase, f"phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 25: the trainers' step chunks (CUDA-graph replays) against their
# per-step paths, from one seed
CHUNK_GS_ITERS = 200        # phase 6's fit, densify events at 100 and 200
CHUNK_GS_DENSIFY_FROM = 50
CHUNK_NEUS_STEPS = 100      # on phase 23's DTU scene, recon_scene's recipe
CHUNK_STEPS = 50            # steps a chunk (GSTrainConfig.chunk_size's default)
CHUNK_GRAD_REL = 1e-5       # lockstep: a replay's gradients against an eager
#                             step's from the same state, max abs / max abs
CHUNK_STATE_REL = 1e-5      # lockstep: the state after each side (parameters,
#                             Adam moments, 3DGS statistics), max abs / max abs
CHUNK_UPDATE_REL = 1e-2     # lockstep: each parameter's update, max abs / max
#                             abs (a stale learning rate moves it by ~1)
CHUNK_ALIVE_REL = 1e-2      # 3DGS fits: the alive count's least bound, of the
#                             per-step fit's (one pair's spread is no estimate)
CHUNK_LOSS_REL = 1e-6       # fits: each compared loss, chunked vs per step
CHUNK_PARAM_REL = 1e-5      # fits: each tensor's max abs difference / its max abs
CHUNK_GS_EARLY = 10         # 3DGS fits: steps whose losses are held ...
CHUNK_GS_EARLY_REL = 1e-4   # ... at test_torch_gs_trainer.py's step tolerance


def _loss_recorder(trainer) -> list:
    """Wrap the trainer's ``train_iter`` / ``train_chunk`` so that each
    step's (GS) or each call's last (NeuS) loss tensor is kept without a
    sync; returns the list they fill."""
    kept = []
    for name in ("train_iter", "train_chunk"):
        fn = getattr(trainer, name)

        def wrapped(*a, _fn=fn, **k):
            stats = _fn(*a, **k)
            kept.append(stats.get("losses", stats["loss"]).reshape(-1))
            return stats

        setattr(trainer, name, wrapped)
    return kept


CHUNK_RUNS = (("per step", False), ("chunked (CUDA graph)", True), ("per step again", False))


def _chunk_runs(phase: str, what: str, make, run, iters: int) -> list:
    """For each of CHUNK_RUNS: ``make(chunked)`` a trainer and ``run(trainer,
    chunked)`` it, with the launch counts set to 0 just before and one sync
    at the end.  Returns per run (trainer, losses (numpy), launches, ms per
    step, peak GiB above the memory held before the trainer was made)."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts

    runs = []
    for label, chunked in CHUNK_RUNS:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = make(chunked)
        kept = _loss_recorder(trainer)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        run(trainer, chunked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        losses = torch.cat(kept).cpu().numpy()
        capture = ""
        if trainer._graph is not None:
            cap = trainer._graph.capture_s
            capture = (f" | the capture {1e3 * cap:.1f} ms (host, instantiation included), "
                       f"{1e3 * (wall - cap) / iters:.3f} ms per step without it")
        say(phase, f"{what}, {label}: {wall:.3f} s, {1e3 * wall / iters:.3f} ms per step "
            f"(the whole fit over {iters} steps, one sync at the end){capture} | peak "
            f"{peak:.2f} GiB | launches {_nonzero(counts)}")
        runs.append((trainer, losses, counts, 1e3 * wall / iters, peak))
        torch.cuda.empty_cache()
    return runs


def _max_rel(named_a: dict, named_b: dict) -> tuple:
    """Largest |a - b| / max |a| over the tensors, and the worst tensor."""
    worst, where = 0.0, None
    for k, a in named_a.items():
        a, b = a.float(), named_b[k]
        if not a.numel():
            continue
        scale = float(a.abs().max())
        err = float((a.float() - b.float()).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if rel >= worst:
            worst, where = rel, k
    return worst, where


def _loss_windows(a, b, ends) -> str:
    """Max relative loss difference over the first n of each ``ends``."""
    import numpy as np

    rel = np.abs(b - a) / np.abs(a)
    return ", ".join(f"1-{n} {rel[:n].max():.2e}" for n in ends)


def _lockstep(params: dict, opt, extra: dict, replay, eager) -> dict:
    """From one state, one replay of the step's CUDA graph and one eager
    step, the state put back in place (the graph reads these tensors)
    between the two.  ``params`` {name: parameter}, ``extra`` {name: tensor}
    more state the step changes in place.  Returns the loss bit for bit
    ("loss"), then (max |diff| / max |a|, worst tensor) of the gradients
    ("grads"), of the state after the step (parameters, optimizer moments,
    ``extra``: "state") and of each parameter's update ("updates"), and
    whether the optimizer step counts are equal ("steps")."""
    import torch

    state = {k: p.detach() for k, p in params.items()}
    for k, p in params.items():
        state.update({f"{k}.{m}": v for m, v in opt.state[p].items()})
    state.update(extra)
    before = {k: v.clone() for k, v in state.items()}

    def side(run):
        loss = run().clone()
        grads = {k: p.grad.clone() for k, p in params.items() if p.grad is not None}
        return loss, grads, {k: v.clone() for k, v in state.items()}

    loss_r, grads_r, after_r = side(replay)
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(before[k])
    loss_e, grads_e, after_e = side(eager)
    steps = [k for k in state if k.endswith(".step")]
    return {"loss": bool(torch.equal(loss_r, loss_e)),
            "grads": _max_rel(grads_e, grads_r),
            "state": _max_rel({k: v for k, v in after_e.items() if k not in steps}, after_r),
            "updates": _max_rel({k: after_e[k] - before[k] for k in params},
                                {k: after_r[k] - before[k] for k in params}),
            "steps": all(torch.equal(after_r[k], after_e[k]) for k in steps)}


def _lockstep_ok(lock: dict) -> bool:
    return (lock["loss"] and lock["steps"] and lock["grads"][0] <= CHUNK_GRAD_REL
            and lock["state"][0] <= CHUNK_STATE_REL
            and lock["updates"][0] <= CHUNK_UPDATE_REL)


def _lockstep_line(lock: dict) -> str:
    return (f"loss {'equal' if lock['loss'] else 'DIFFERS'}, optimizer steps "
            f"{'equal' if lock['steps'] else 'DIFFER'}; max |diff| / max |tensor|: gradients "
            f"{lock['grads'][0]:.3e} ({lock['grads'][1]}; <= {CHUNK_GRAD_REL:g}), state after "
            f"{lock['state'][0]:.3e} ({lock['state'][1]}; <= {CHUNK_STATE_REL:g}), updates "
            f"{lock['updates'][0]:.3e} ({lock['updates'][1]}; <= {CHUNK_UPDATE_REL:g})")


def phase_chunks(frames, dev="cuda") -> dict:
    """The trainers' step chunks against their per-step paths, from one
    seed, ``log_every`` 0 (nothing syncs per step): phase 6's fit
    (``GSTrainer.train``) at ``chunk_size`` 1, 50 and 1 again for 200
    iterations across densify events at 100 and 200; then
    ``NeusTrainer.train`` on phase 23's DTU scene with recon_scene's recipe
    at ``chunk`` 1, 50 and 1 for 100 steps.  Each run: ms per step (the
    whole fit over its steps, one sync at the end), peak memory, launches
    (exact).  Held: the chunked run replayed a graph; a lockstep step (one
    replay and one eager step from the same state, at learning rates far
    from the captured step's) with the same loss bit for bit, gradients
    within CHUNK_GRAD_REL, the state after the step (parameters, Adam
    moments, 3DGS statistics) within CHUNK_STATE_REL, each parameter's
    update within CHUNK_UPDATE_REL and equal Adam step counts; the first
    step's loss bit
    for bit in the three runs; NeuS (deterministic on the card): the fits'
    losses within CHUNK_LOSS_REL and parameters within CHUNK_PARAM_REL of
    the per-step run's.  3DGS: K5 adds each tile's gradients into the slab
    with float atomics, so two per-step fits part by rounding from step 2
    on and the densify events amplify it; the first CHUNK_GS_EARLY steps'
    losses are held within CHUNK_GS_EARLY_REL, the alive count within the
    per-step runs' spread or CHUNK_ALIVE_REL, whichever is larger, the rest
    of the fits' numbers printed beside the second per-step run's own
    spread, and the lockstep step holds the graph to the eager step."""
    import dataclasses

    import numpy as np
    import torch

    from v3d_tpu_torch.apps.recon_scene import neus_scene_config
    from v3d_tpu_torch.data.cameras import orbit_cameras
    from v3d_tpu_torch.gs.trainer import GSTrainConfig, GSTrainer
    from v3d_tpu_torch.nerf.system import NeusTrainer

    phase = "25 chunks"
    t_phase = time.perf_counter()
    paths = {}
    cams = orbit_cameras(frames.shape[0], resolution=frames.shape[1], images=list(frames))
    # train_from_frames's recipe (lambda_dssim 1, no resets, decay 0.995)
    base = GSTrainConfig(lambda_dssim=1.0, opacity_reset_mode="none", opacity_decay=0.995,
                         densify_from_iter=CHUNK_GS_DENSIFY_FROM)

    def make_gs(chunked):
        cfg = dataclasses.replace(base, chunk_size=CHUNK_STEPS if chunked else 1)
        return GSTrainer(cams, cfg, num_pts=FIT_POINTS, capacity=FIT_CAPACITY, seed=0,
                         radius=2.0, device=dev)

    runs = _chunk_runs(
        phase, f"3DGS {CHUNK_GS_ITERS} iterations at {frames.shape[1]}^2, {FIT_POINTS} "
        f"points in {FIT_CAPACITY} slots", make_gs, lambda t, _: t.train(CHUNK_GS_ITERS),
        CHUNK_GS_ITERS)
    (ta, la, ca, ms_a, pk_a), (tb, lb, cb, ms_b, pk_b), (tc, lc, cc, ms_c, pk_c) = runs
    expect = gs_fit_launches(CHUNK_GS_ITERS, 0)

    # the lockstep step: view 1 at the end of the xyz schedule, whose lr is
    # 1/100 of the captured step's
    lock_step = base.position_lr_max_steps

    def gs_replay():
        tb._set_inputs(lock_step, 1, None)
        tb._graph.graph.replay()
        return tb._graph.out

    fields = [{k: p.detach() for k, p in t.params.items()} for t in (ta, tb, tc)]
    loss_rel = float(np.max(np.abs(lb - la) / np.abs(la)))
    spread_rel = float(np.max(np.abs(lc - la) / np.abs(la)))
    prel, pwhere = _max_rel(fields[0], fields[1])
    srel, swhere = _max_rel(fields[0], fields[2])
    alive = [int(t.alive.sum()) for t in (ta, tb, tc)]
    early = slice(0, CHUNK_GS_EARLY)
    early_rel = float(np.max(np.abs(lb[early] - la[early]) / np.abs(la[early])))
    # the graph's gradients are the parameters' .grad: no eager step ran
    # after the capture (four chunks of 50 make the fit)
    lock = _lockstep(tb.params, tb.opt, {**tb.stats, "alive": tb.alive}, gs_replay, tb._step)
    alive_bound = max(abs(alive[2] - alive[0]), CHUNK_ALIVE_REL * alive[0])
    ends = sorted({min(n, CHUNK_GS_ITERS) for n in (1, 10, 50, 100, CHUNK_GS_ITERS)})
    ok = (ca == cb == cc == expect and la.shape == lb.shape == (CHUNK_GS_ITERS,)
          and np.all(np.isfinite(lb)) and tb._graph.graph is not None and ta._graph is None
          and la[0] == lb[0] == lc[0] and _lockstep_ok(lock)
          and early_rel <= CHUNK_GS_EARLY_REL and abs(alive[1] - alive[0]) <= alive_bound)
    say(phase, f"3DGS lockstep (a replay and an eager step from one state, view 1, xyz lr at "
        f"step {lock_step}): {_lockstep_line(lock)}")
    say(phase, f"3DGS fits, chunked vs per step (per step again vs per step): losses max rel "
        f"over steps {_loss_windows(la, lb, ends)} ({_loss_windows(la, lc, ends)}); "
        f"parameters max |diff| / max |field| {prel:.3e} {pwhere} ({srel:.3e} {swhere}); "
        f"alive {alive[1]} vs {alive[0]} ({alive[2]}; held within {alive_bound:g}); bit for bit "
        f"{'yes' if loss_rel == 0 and prel == 0 else 'no'} ("
        f"{'yes' if spread_rel == 0 and srel == 0 else 'no'}); held: step 1 bit for bit, "
        f"steps 1-{CHUNK_GS_EARLY} <= {CHUNK_GS_EARLY_REL:g} | ms per step {ms_a:.3f} -> "
        f"{ms_b:.3f} ({ms_c:.3f}), peak {pk_a:.2f} -> {pk_b:.2f} GiB | launches "
        f"{_nonzero(cb)} (expect {_nonzero(expect)}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"3DGS chunks: launches {ca} {cb} {cc}, first losses {la[:1]} "
                           f"{lb[:1]} {lc[:1]}, steps 1-{CHUNK_GS_EARLY} {early_rel}, "
                           f"alive {alive}, lockstep {lock}")
    paths["chunks_gs"] = {"launches": _summed(ca, cb, cc)}
    del ta, tb, tc, runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dframes, masks, poses, _, dirs = dtu_views(dev)
    say(phase, f"DTU scene ({DTU_VIEWS} views at {DTU_W}x{DTU_H}, per-frame K) rendered "
        f"in {time.perf_counter() - t0:.2f} s")
    cfg = neus_scene_config(dev, CHUNK_NEUS_STEPS, 256, masked=True)

    def run_neus(trainer, chunked):
        trainer.train(CHUNK_NEUS_STEPS, chunk=CHUNK_STEPS if chunked else 1)

    runs = _chunk_runs(
        phase, f"NeuS {CHUNK_NEUS_STEPS} steps ({cfg.train_num_rays} rays, "
        f"{cfg.coarse_to_fine_samples} + {cfg.num_samples_per_ray} samples)",
        lambda _: NeusTrainer(dframes, masks, dirs, poses, config=cfg, seed=0, device=dev),
        run_neus, CHUNK_NEUS_STEPS)
    (na, nla, nca, nms_a, npk_a), (nb, nlb, ncb, nms_b, npk_b), (nc, nlc, ncc, nms_c, _) = runs

    named = {f"{g}.{k}": p for g, m in nb.modules.items() for k, p in m.named_parameters()}

    # the lockstep step: new draws at step 10 x max_steps, whose learning
    # rates are far below the captured step's
    inp, nlock_step = nb._inputs, 10 * cfg.max_steps

    def neus_replay():
        inp.load(nb.make_draws(cfg.train_num_rays),
                 nb._schedule_table([nlock_step])[0], nb.occ.binary)
        nb._set_lr(nlock_step)
        nb._graph.graph.replay()
        return nb._graph.out[0]

    # the per-step runs kept every step's loss, the chunked run each chunk's last
    ends = np.arange(CHUNK_STEPS, CHUNK_NEUS_STEPS + 1, CHUNK_STEPS) - 1
    nloss_rel = float(np.max(np.abs(nlb - nla[ends]) / np.abs(nla[ends])))
    nspread = float(np.max(np.abs(nlc - nla) / np.abs(nla)))
    params = [{f"{g}.{k}": p.detach() for g, m in t.modules.items()
               for k, p in m.named_parameters()} for t in (na, nb, nc)]
    nprel, nwhere = _max_rel(params[0], params[1])
    nsrel, nswhere = _max_rel(params[0], params[2])
    nlock = _lockstep(named, nb.opt, {}, neus_replay,
                      lambda: nb._step(inp.draws, inp.sched, inp.binary)[0])
    nok = (not _nonzero(nca) and not _nonzero(ncb) and not _nonzero(ncc)
           and nlb.shape == ends.shape and np.all(np.isfinite(nlb))
           and na.global_step == nb.global_step == nc.global_step == CHUNK_NEUS_STEPS
           and nb._graph.graph is not None
           and na._graph is None and _lockstep_ok(nlock)
           and nloss_rel <= CHUNK_LOSS_REL and nprel <= CHUNK_PARAM_REL)
    say(phase, f"NeuS lockstep (learning rates and schedules at step {nlock_step}): "
        f"{_lockstep_line(nlock)}")
    say(phase, f"NeuS fits, chunked vs per step (per step again vs per step): losses at steps "
        f"{[int(e) + 1 for e in ends]} max rel {nloss_rel:.3e} (every step {nspread:.3e}); "
        f"parameters max |diff| / max |tensor| {nprel:.3e} {nwhere} ({nsrel:.3e} {nswhere}); "
        f"bit for bit {'yes' if nloss_rel == 0 and nprel == 0 else 'no'} ("
        f"{'yes' if nspread == 0 and nsrel == 0 else 'no'}) | ms per step {nms_a:.3f} -> "
        f"{nms_b:.3f} ({nms_c:.3f}), peak {npk_a:.2f} -> {npk_b:.2f} GiB | launches "
        f"{_nonzero(ncb)} (expect none) | {'ok' if nok else 'FAIL'}")
    if not nok:
        raise SmokeFailure(f"NeuS chunks: launches {nca} {ncb} {ncc}, lockstep {nlock}, "
                           f"fits: losses {nloss_rel} "
                           f"parameters {nprel} ({nwhere})")
    say(phase, f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 26: the multi-device path (parallel/, DiffusionTrainer(mesh=...),
# train_diffusion under torchrun, rasterize_sharded, the dry run)

DP_STEPS = 3          # 26(a): AdamW steps a run of the full-width fine-tune
DP_CLI_STEPS = 2      # 26(b): steps of the torchrun launch
DP_NPROC = 2          # 26(c): dry-run ranks, sharing this card over gloo
DP_RUNG = "full"      # 26(c): 300k gaussians at 512^2, Kc 4096; 4096 rays x 64


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_abs_diff(a, b) -> float:
    """The largest |a - b| over lists of tensors."""
    import torch

    with torch.no_grad():
        return float(torch.stack([(x - y).abs().max() for x, y in zip(a, b)]).max())


def phase_dp_step(engine, dev) -> dict:
    """26(a): the fine-tune step of phase 8's full-width engine on a
    ("data", "model") mesh of world size 1 over NCCL (the trainer's
    broadcast and its gradient all_reduce run, on one rank) against the
    same steps without a mesh: DP_STEPS steps a run from the same parameters
    on the same batch and draws, twice without a mesh, then on the mesh; the
    losses, gradient norms, parameters and EMA bit for bit, or within the
    two mesh-less runs' own difference where those differ."""
    import torch
    import torch.distributed as dist

    from v3d_tpu_torch.apps.train_diffusion import batches, make_dataset
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer, TrainConfig
    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import all_reduce_mean_, init_distributed, make_mesh

    phase = "26 dp step"
    t_phase = time.perf_counter()
    unet, t = engine.unet, engine.num_frames
    unet.zero_grad(set_to_none=True)
    data = batches(engine, make_dataset("synthetic", t, unet.context_dim), 1, t)
    batch = next(data)
    data.close()
    init = [p.detach().clone() for p in unet.parameters()]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run(mesh):
        with torch.no_grad():
            torch._foreach_copy_(list(unet.parameters()), init)
        trainer = DiffusionTrainer(engine, TrainConfig(log_every=1), num_frames=t, mesh=mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        stats, ms = [], []
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            stats.append(trainer.train_step(batch["latents"], batch["cond"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        counts = dict(LAUNCHES)
        if mesh is not None:   # what the mesh adds to a step: the gradients' all_reduce
            grads = [p.grad for p in trainer.params if p.grad is not None]
            stats.append(cuda_ms(lambda: all_reduce_mean_(grads, mesh), iters=3, warmup=1))
        unet.zero_grad(set_to_none=True)
        return trainer, stats, ms, counts

    port = _free_port()
    try:
        first, s1, ms1, c1 = run(None)
        params1 = [p.detach().clone() for p in first.params]
        ema1 = [e.clone() for e in first.ema]
        del first
        second, s2, ms2, c2 = run(None)
        d_own = {"params": _max_abs_diff(second.params, params1),
                 "ema": _max_abs_diff(second.ema, ema1),
                 "loss": max(abs(a["loss"] - b["loss"]) for a, b in zip(s1, s2)),
                 "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                                  for a, b in zip(s1, s2))}
        del second
        torch.cuda.empty_cache()
        init_distributed("cuda", init_method=f"tcp://localhost:{port}", rank=0,
                         world_size=1)
        mesh = make_mesh()
        backend = dist.get_backend()
        meshed, s3, ms3, c3 = run(mesh)
        reduce_ms = s3.pop()
        d_mesh = {"params": _max_abs_diff(meshed.params, params1),
                  "ema": _max_abs_diff(meshed.ema, ema1),
                  "loss": max(abs(a["loss"] - b["loss"]) for a, b in zip(s1, s3)),
                  "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                                   for a, b in zip(s1, s3))}
        del meshed, params1, ema1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
        with torch.no_grad():
            torch._foreach_copy_(list(unet.parameters()), init)
        del init
        torch.cuda.empty_cache()
    per_step = train_launches(unet, 64, use_checkpoint=True)
    expect = _scaled(per_step, DP_STEPS)
    bitwise = all(v == 0 for v in d_mesh.values())
    ok = (c1 == c2 == c3 == expect and backend == "nccl"
          and all(d_mesh[k] <= d_own[k] for k in d_mesh)
          and all(math.isfinite(s["loss"]) for s in s3))
    say(phase, f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over {backend} at world size 1, "
        f"{DP_STEPS} AdamW steps of phase 8's engine on one batch (1 video x {t} frames, "
        f"cudnn deterministic): losses {[s['loss'] for s in s3]} vs without a mesh "
        f"{[s['loss'] for s in s1]} | largest |difference| from the first mesh-less run: "
        f"mesh {d_mesh} (bit for bit: {'yes' if bitwise else 'no'}), second mesh-less run "
        f"{d_own} (the bound) | ms per step (host clock, synchronised) without a mesh "
        f"{[round(x, 1) for x in ms1]} {[round(x, 1) for x in ms2]}, on the mesh "
        f"{[round(x, 1) for x in ms3]}; the flat all_reduce of the gradients alone "
        f"{reduce_ms:.2f} ms (CUDA events, back to back) | launches per step "
        f"{ {k: v / DP_STEPS for k, v in c3.items() if v} } (expect "
        f"{ {k: v for k, v in per_step.items() if v} }) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"DP step at world size 1: launches {c1} {c2} {c3} (expect "
                           f"{expect}), differences {d_mesh} against {d_own}")
    say(phase, f"26(a) took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": c3, "ms_mesh": ms3, "ms_plain": ms1 + ms2, "diff": d_mesh,
            "diff_bound": d_own, "all_reduce_ms": reduce_ms, "per_step": per_step}


def phase_dp_ranks(dev, per_step: dict) -> dict:
    """26(b): ``train_diffusion`` launched by ``torch.distributed.run``
    (--standalone, one process, --model-axis 1) for DP_CLI_STEPS steps of
    the full-width engine, its launches after step i (its JSON lines)
    i times ``per_step`` (phase 8's step, ``train_launches``); 26(c):
    ``parallel.dryrun`` with DP_NPROC ranks on this card over gloo at the
    DP_RUNG rung: the DP fine-tune step of the tiny engine, the DP 3DGS /
    NeuS steps, the tile-sharded 3DGS step and the ray-parallel NeuS step,
    each against one process, and each rank's launches of the fine-tune
    step and of the tile-sharded step.  Run after phase 8's engine has left
    the card."""
    import os
    import tempfile

    from v3d_tpu_torch.parallel import dryrun

    phase = "26 dp ranks"
    t_phase = time.perf_counter()
    repo, env = _repo_env()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "v3d_tpu_torch.apps.train_diffusion",
               "--data", "synthetic", "--max-steps", str(DP_CLI_STEPS), "--model-axis", "1",
               "--log-every", "1", "--ckpt-dir", os.path.join(tmp, "ck"),
               "--log-dir", os.path.join(tmp, "logs")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                              timeout=400)
        cli_s = time.perf_counter() - t0
        steps = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        cli_launches = [s_.pop("launches", None) for s_ in steps]
        cli_want = [{k: i * v for k, v in per_step.items() if v}
                    for i in range(1, DP_CLI_STEPS + 1)]
        ok = (proc.returncode == 0 and len(steps) == DP_CLI_STEPS
              and cli_launches == cli_want
              and all(math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])
                      for s_ in steps))
        say(phase, f"python -m torch.distributed.run --standalone --nproc-per-node 1 -m "
            f"v3d_tpu_torch.apps.train_diffusion --data synthetic --max-steps {DP_CLI_STEPS} "
            f"--model-axis 1: exit {proc.returncode} in {cli_s:.1f} s (the launch, the "
            f"full-width engine, NCCL, the steps) | steps {steps} | launches after each "
            f"step {cli_launches} (expect {cli_want}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"torchrun launch: exit {proc.returncode}, steps {steps}, "
                               f"launches {cli_launches} (expect {cli_want}): "
                               f"{proc.stderr[-3000:]}")

    report, dry_s = run_dryrun(phase, DP_RUNG)
    ranks = report["ranks"]
    render = {"gs_composite_fwd": 1, "gs_composite_bwd": 1}
    got = [{k: v for k, v in r["refpoint"]["gs"]["launches"].items() if v} for r in ranks]
    got_train = [{k: v for k, v in r["train"]["launches"].items() if v} for r in ranks]
    tiny_step = dryrun_train_launches()
    gs, ne = ranks[0]["refpoint"]["gs"], ranks[0]["refpoint"]["neus"]
    ok = (len(ranks) == DP_NPROC and report["backend"] == "gloo"
          and all(g == render for g in got) and got_train == tiny_step
          and gs["render_max_abs"] <= dryrun.RENDER_MAX_ABS
          and gs["grad_rel"] <= dryrun.GS_GRAD_REL and ne["grad_rel"] <= dryrun.NEUS_GRAD_REL
          and all(r["train"]["loss_rel"] <= dryrun.TRAIN_LOSS_REL
                  and r["train"]["min_cos"] >= dryrun.TRAIN_MIN_COS for r in ranks))
    say(phase, f"dryrun --nproc {DP_NPROC} --backend gloo --rung {DP_RUNG}: {dry_s:.1f} s | "
        f"tile-sharded render max abs {gs['render_max_abs']} (<= {dryrun.RENDER_MAX_ABS}), "
        f"gradients {gs['grad_rel']} of the largest (<= {dryrun.GS_GRAD_REL}), ms single "
        f"{gs['ms_single']:.1f}, sharded a rank "
        f"{[round(r['refpoint']['gs']['ms_sharded'], 1) for r in ranks]}; NeuS gradients "
        f"{ne['grad_rel']} (<= {dryrun.NEUS_GRAD_REL}), ms single {ne['ms_single']:.1f}, "
        f"sharded {[round(r['refpoint']['neus']['ms_sharded'], 1) for r in ranks]} "
        f"| K4 / K5 launches per rank {got} (expect {render} each) | fine-tune (one "
        f"video, 2 frames a rank) loss rel {[r['train']['loss_rel'] for r in ranks]}, least "
        f"cosine {[r['train']['min_cos'] for r in ranks]}, launches per rank {got_train} "
        f"(expect {tiny_step}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"dry run: launches {got}, fine-tune {got_train} (expect "
                           f"{tiny_step}), report {json.dumps(ranks)[:3000]}")
    say(phase, f"phase 26 (b, c) took {time.perf_counter() - t_phase:.1f} s")
    return {"dp_cli": {"launches": cli_launches[-1]},
            "dp_render": {"launches": _rank_sum(ranks, lambda r: r["refpoint"]["gs"]["launches"])},
            "dp_tiny_train": {"launches": _rank_sum(ranks, lambda r: r["train"]["launches"])},
            "cli_s": cli_s, "dryrun_s": dry_s, "dryrun": report}


def _rank_sum(ranks, key) -> dict:
    """The launches ``key(rank)`` summed over the ranks."""
    total = {}
    for r in ranks:
        for k, v in key(r).items():
            total[k] = total.get(k, 0) + v
    return total


def _repo_env():
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    return repo, dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def run_dryrun(phase: str, rung: str, nproc: int = DP_NPROC) -> tuple:
    """``python -m v3d_tpu_torch.parallel.dryrun`` with ``nproc`` ranks on this
    card over gloo at ``rung``, its lines echoed; (its report, seconds)."""
    import os
    import tempfile

    repo, env = _repo_env()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dryrun.json")
        cmd = [sys.executable, "-m", "v3d_tpu_torch.parallel.dryrun", "--nproc",
               str(nproc), "--backend", "gloo", "--rung", rung, "--timeout", "300",
               "--join-timeout", "600", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                              timeout=700)
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            say(phase, line)
        if proc.returncode != 0:
            raise SmokeFailure(f"dry run: exit {proc.returncode}: {proc.stderr[-3000:]}")
        with open(out) as f:
            return json.load(f), seconds


def dryrun_train_launches(data: int = DP_NPROC) -> list:
    """Each "data" rank's launches of the dry run's fine-tune step: its share
    of the tiny engine's frame-split step (one video of 2 ``data`` frames;
    a rank of a model row launches what one process of its share would)."""
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.parallel import dryrun

    tiny = build_tiny_engine(num_frames=2 * data, device="cpu").unet
    return [{k: v for k, v in train_launches(tiny, dryrun.TRAIN_HW, tiny.use_checkpoint,
                                             ranks=data, rank=r).items() if v}
            for r in range(data)]


def dryrun_sample_launches(data: int = DP_NPROC) -> list:
    """Each "data" rank's launches of the dry run's sampling stage:
    SAMPLE_STEPS shares of the tiny engine's frame-parallel forward (f32)."""
    import torch

    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.parallel import dryrun

    t = max(2 * data, 2)
    tiny = build_tiny_engine(num_frames=t, device="cpu").unet
    hw = dryrun.SAMPLE_RES // 8
    return [{k: dryrun.SAMPLE_STEPS * v for k, v in forward_launches(
        tiny, hw, dtype=torch.float32, ranks=data, rank=r).items() if v}
        for r in range(data)]


# ---------------------------------------------------------------------------
# phase 27: frame-sharded sampling and the frame-split step

FRAMES_NPROC = 2           # 27(b): ranks sharing this card over gloo
FRAMES_STEPS = 2           # 27(b): Euler steps (of 25)
FRAMES_MIN_PSNR = 30.0     # dB, latents against one process (phases 4, 9's bar)
FRAMES_DRY_RUNG = "small"  # 27(c) when phase 26 did not run the dry run
FRAMES_RES = 512           # pixels (64^2 latents)


def build_frames_engine(device):
    """The V3D-512 engine of phase 5 (seeded bf16 weights) on ``device``."""
    import torch

    from v3d_tpu_torch.engines.builder import build_v3d_engine

    return build_v3d_engine(device=device, dtype=torch.bfloat16, seed=0)


def frames_inputs(engine, dev, seed: int = 5) -> tuple:
    """(c, uc, noise) of a FRAMES_RES^2 sample from a seeded draw on ``dev``:
    per-frame cond at the engine's shapes (uc: the image conds zeroed, the
    vector kept, as ``build_cond`` gives it), noise of its latent shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    t, h, w, ch = engine.latent_shape(FRAMES_RES, FRAMES_RES)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    c = {"crossattn": randn(t, 1, engine.unet.context_dim), "concat": randn(t, h, w, ch),
         "vector": randn(t, 768)}
    uc = {k: v if k == "vector" else torch.zeros_like(v) for k, v in c.items()}
    return c, uc, randn(t, h, w, ch)


def frames_forward_launches(unet, ranks=None, rank: int = 0) -> dict:
    """``forward_launches`` of a FRAMES_RES^2 forward in the UNet's dtype."""
    return forward_launches(unet, FRAMES_RES // 8, dtype=unet.dtype, ranks=ranks, rank=rank)


def _param_sum(unet) -> str:
    """A hash of the first values of the UNet's first tensors (the ranks
    build the same seeded engine)."""
    import hashlib

    h = hashlib.sha256()
    for p in list(unet.parameters())[:16]:
        h.update(p.detach().flatten()[:4096].float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_frames_one(engine, dev) -> dict:
    """27(a): the 25-step sample of phase 5's engine through
    ``sample_latents(mesh=)`` on a (1, 1) NCCL mesh against the same sample
    without a mesh (same c, uc, noise), each after one warm-up forward:
    PSNR of the latents, seconds, peak memory, launches exact both ways;
    then one process's FRAMES_STEPS-step sample, the reference of 27(b)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel.mesh import init_distributed, make_mesh

    phase = "27 frames"
    t_phase = time.perf_counter()
    c, uc, noise = frames_inputs(engine, dev)
    steps = engine.sampler.num_steps
    runs = {}

    def warm_up(mesh):
        """One forward of the sampler's network, so that neither timed
        sample pays a first call (the mesh's communicators start lazily)."""
        from v3d_tpu_torch.engines.wrappers import make_unet_network_fn

        rows = 2 * engine.num_frames
        x = torch.randn((rows,) + tuple(noise.shape[1:]), device=dev)
        cond = {k: torch.cat([uc[k], c[k]]) for k in c}
        with torch.no_grad():
            make_unet_network_fn(engine.unet, engine.num_frames, mesh=mesh)(
                x, torch.zeros(rows, device=dev), cond, torch.zeros(2, engine.num_frames,
                                                                     device=dev))
        torch.cuda.synchronize()

    def sample(mesh):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        z = engine.sample_latents(c, uc, FRAMES_RES, FRAMES_RES, noise=noise, mesh=mesh)
        torch.cuda.synchronize()
        return {"z": z, "s": time.perf_counter() - t0, "launches": dict(LAUNCHES),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    warm_up(None)
    runs["plain"] = sample(None)
    init_distributed("cuda", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                     world_size=1)
    try:
        mesh = make_mesh()
        backend = dist.get_backend()
        warm_up(mesh)
        runs["mesh"] = sample(mesh)
    finally:
        dist.destroy_process_group()
    expect = {"plain": _scaled(frames_forward_launches(engine.unet), steps),
              "mesh": _scaled(frames_forward_launches(engine.unet, ranks=1), steps)}
    quality = psnr(runs["mesh"]["z"], runs["plain"]["z"])
    ok = (backend == "nccl" and quality >= FRAMES_MIN_PSNR
          and bool(torch.isfinite(runs["mesh"]["z"]).all())
          and all(runs[k]["launches"] == expect[k] for k in runs))
    say(phase, f"(a) {steps}-step V3D-512 sample ({engine.num_frames} frames, CFG-doubled "
        f"to {2 * engine.num_frames}) through sample_latents(mesh=) on a (1, 1) {backend} "
        f"mesh vs without: PSNR {quality:.2f} dB (>= {FRAMES_MIN_PSNR:g}), max abs "
        f"{float((runs['mesh']['z'] - runs['plain']['z']).abs().max()):.3e} | seconds "
        f"{runs['mesh']['s']:.3f} on the mesh vs {runs['plain']['s']:.3f} without | peak "
        f"{runs['mesh']['peak_gib']:.2f} vs {runs['plain']['peak_gib']:.2f} GiB | launches "
        f"on the mesh {_nonzero(runs['mesh']['launches'])} (expect "
        f"{_nonzero(expect['mesh'])}), without {_nonzero(runs['plain']['launches'])} "
        f"(expect {_nonzero(expect['plain'])}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"frame-sharded sample on one rank: {quality} dB, launches "
                           f"{runs['mesh']['launches']} (expect {expect['mesh']})")
    saved = engine.sampler
    engine.sampler = dataclasses.replace(saved, num_steps=FRAMES_STEPS)
    try:
        ref = engine.sample_latents(c, uc, FRAMES_RES, FRAMES_RES, noise=noise).cpu()
    finally:
        engine.sampler = saved
    say(phase, f"27(a) took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": runs["mesh"]["launches"], "ref": ref,
            "param_sum": _param_sum(engine.unet),
            "seconds": {k: r["s"] for k, r in runs.items()}, "psnr": quality}


def _frames_rank(index: int, nproc: int, store: str, out_dir: str, build,
                 device: str) -> None:
    """A rank of 27(b): ``build(device)``'s engine (the full-width one on this
    card), FRAMES_STEPS steps of ``sample_latents(mesh=)`` over gloo; its
    latents, launches, exchange traffic and seconds into ``out_dir``."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel import frames
    from v3d_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))  # they share the host
    dev = init_distributed(device, timeout_s=300, backend="gloo",
                           init_method=f"file://{store}", rank=index, world_size=nproc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = make_mesh(device=dev.type)
        engine = build(dev)
        engine.sampler = dataclasses.replace(engine.sampler, num_steps=FRAMES_STEPS)
        c, uc, noise = frames_inputs(engine, dev)
        engine.sample_latents(c, uc, FRAMES_RES, FRAMES_RES, noise=noise, mesh=mesh)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        frames.reset_traffic()
        t0 = time.perf_counter()
        z = engine.sample_latents(c, uc, FRAMES_RES, FRAMES_RES, noise=noise, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        torch.save({"z": z.cpu(), "launches": dict(LAUNCHES), "traffic": dict(frames.TRAFFIC),
                    "seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "param_sum": _param_sum(engine.unet), "backend": dist.get_backend()},
                   os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def phase_frames_ranks(one: dict, build=build_frames_engine, device: str = "cuda:0") -> dict:
    """27(b): FRAMES_NPROC ranks sharing this card over gloo, each with the
    full-width engine, sample FRAMES_STEPS steps with the 36 CFG frames over
    "data" (18 a rank) against one process's FRAMES_STEPS steps on the same
    noise (27(a)'s ``ref``): PSNR and max abs of the latents, each rank's
    launches exact, seconds a forward and the bytes the exchanges moved."""
    import os
    import tempfile

    import torch

    from v3d_tpu_torch.parallel.dryrun import spawn_ranks

    phase = "27 frames"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_frames_rank, FRAMES_NPROC,
                    (FRAMES_NPROC, os.path.join(tmp, "store"), tmp, build, device),
                    timeout_s=400)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(FRAMES_NPROC)]
    unet = build("meta").unet
    expect = [_scaled(frames_forward_launches(unet, ranks=FRAMES_NPROC, rank=r), FRAMES_STEPS)
              for r in range(FRAMES_NPROC)]
    ref = one["ref"]
    quality = [psnr(r["z"], ref) for r in ranks]
    max_abs = [float((r["z"] - ref).abs().max()) for r in ranks]
    ok = (all(q >= FRAMES_MIN_PSNR for q in quality)
          and all(torch.equal(r["z"], ranks[0]["z"]) for r in ranks)
          and all(r["param_sum"] == one["param_sum"] and r["backend"] == "gloo"
                  for r in ranks)
          and [r["launches"] for r in ranks] == expect)
    say(phase, f"(b) {FRAMES_NPROC} ranks on this card over gloo, the full-width engine each, "
        f"{FRAMES_STEPS} Euler steps with {2 * len(ref) // FRAMES_NPROC} of the {2 * len(ref)} "
        f"CFG frames a rank "
        f"vs one process's {FRAMES_STEPS} steps: PSNR {[round(q, 2) for q in quality]} dB "
        f"(>= {FRAMES_MIN_PSNR:g}), max abs {max_abs} | seconds a forward "
        f"{[round(r['seconds'] / FRAMES_STEPS, 3) for r in ranks]} (host clock, synchronised; "
        f"gloo stages every exchange through the host) | exchanges a rank "
        f"{[r['traffic']['exchanges'] for r in ranks]} receiving "
        f"{[r['traffic']['bytes'] for r in ranks]} bytes | peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB | launches per rank "
        f"{[_nonzero(r['launches']) for r in ranks]} (expect "
        f"{[_nonzero(e) for e in expect]}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"frame-sharded sample on {FRAMES_NPROC} ranks: {quality} dB, "
                           f"launches {[r['launches'] for r in ranks]} (expect {expect})")
    say(phase, f"27(b) took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": _summed(*(r["launches"] for r in ranks)), "psnr": quality,
            "max_abs": max_abs, "seconds": [r["seconds"] for r in ranks],
            "traffic": [r["traffic"] for r in ranks]}


def phase_frames_dryrun(report=None) -> dict:
    """27(c): the dry run's sampling stage (max abs <= its bound) and its
    fine-tune step at the graft's shape (one video, 2 frames a rank; loss
    and cosines within its bounds), each rank's launches exact: phase 26's
    run of the dry run where it ran, else one at FRAMES_DRY_RUNG."""
    from v3d_tpu_torch.parallel import dryrun

    phase = "27 frames"
    if report is None:
        report, _ = run_dryrun(phase, FRAMES_DRY_RUNG)
    ranks = report["ranks"]
    got_s = [_nonzero(r["sampling"]["launches"]) for r in ranks]
    got_t = [_nonzero(r["train"]["launches"]) for r in ranks]
    want_s, want_t = dryrun_sample_launches(), dryrun_train_launches()
    ok = (report["backend"] == "gloo" and got_s == want_s and got_t == want_t
          and all(r["sampling"]["max_abs"] <= dryrun.SAMPLE_MAX_ABS
                  and r["train"]["loss_rel"] <= dryrun.TRAIN_LOSS_REL
                  and r["train"]["min_cos"] >= dryrun.TRAIN_MIN_COS for r in ranks))
    say(phase, f"(c) dry run on {len(ranks)} ranks over gloo ({report['rung']} rung): sampling "
        f"max abs {[r['sampling']['max_abs'] for r in ranks]} (<= {dryrun.SAMPLE_MAX_ABS}), "
        f"launches {got_s} (expect {want_s}); fine-tune at the graft's shape loss rel "
        f"{[r['train']['loss_rel'] for r in ranks]} (<= {dryrun.TRAIN_LOSS_REL}), least cosine "
        f"{[r['train']['min_cos'] for r in ranks]} (>= {dryrun.TRAIN_MIN_COS}), launches "
        f"{got_t} (expect {want_t}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"dry run's frame stages: {json.dumps(ranks)[:3000]}")
    return {"launches": _rank_sum(ranks, lambda r: r["sampling"]["launches"])}


# ---------------------------------------------------------------------------
# phase 28: the tensor-parallel forward over "model" (parallel/tensor.py) and
# the dry run's (2, 2) stages

TP_NPROC = 2           # 28(a): model ranks sharing this card over gloo, a (1, 2) mesh
TP_MIN_PSNR = 30.0     # dB, the denoised latents against one process (phases 4, 9's bar)
TP_FORWARDS = 1        # 28(a): timed forwards a side, after one warm-up forward (a forward
#                        over gloo takes ~13 s a rank)
TP_DRY_NPROC = 4       # 28(b): dry-run ranks on this card over gloo, a (2, 2) mesh
TP_DRY_RUNG = "small"  # 28(b): the recon stages' rung


def tp_inputs(engine, dev, seed: int = 7) -> tuple:
    """(x, sigma, cond, indicator) of one CFG-doubled denoise step of the
    engine at FRAMES_RES^2 (the sampler's shapes), from a seeded draw on
    ``dev``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    t, h, w, ch = engine.latent_shape(FRAMES_RES, FRAMES_RES)
    rows = 2 * t

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    cond = {"crossattn": randn(rows, 1, engine.unet.context_dim),
            "concat": randn(rows, h, w, ch), "vector": randn(rows, 768)}
    return randn(rows, h, w, ch), torch.exp(randn(rows)), cond, torch.zeros(2, t, device=dev)


def tp_denoise(engine, inputs):
    """One denoise step (the Denoiser around one UNet forward), no grad."""
    import torch

    from v3d_tpu_torch.engines.wrappers import make_unet_network_fn

    x, sigma, cond, indicator = inputs
    with torch.no_grad():
        return engine.denoiser(make_unet_network_fn(engine.unet, engine.num_frames), x,
                               sigma, cond, image_only_indicator=indicator)


def _timed_forwards(engine, inputs) -> dict:
    """TP_FORWARDS denoise steps after one warm-up, each rank's launch counts
    set to 0 just before them: the last output (on the host), seconds a
    forward, launches, peak memory."""
    import torch

    from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from v3d_tpu_torch.parallel import tensor as tp

    tp_denoise(engine, inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tp.reset_traffic()
    t0 = time.perf_counter()
    for _ in range(TP_FORWARDS):
        out = tp_denoise(engine, inputs)
    torch.cuda.synchronize()
    return {"out": out.float().cpu(), "s": (time.perf_counter() - t0) / TP_FORWARDS,
            "launches": dict(LAUNCHES),
            "traffic": {k: v // TP_FORWARDS for k, v in tp.TRAFFIC.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "param_bytes": tp.local_param_bytes(engine.unet)}


def tp_k2_checks(dev) -> list:
    """K2 at the ds1 layer on one rank's heads of a tensor-parallel forward
    (x (2, 18, 4096, 320), bf16): 3 heads (2 ranks) and 2 heads (4 ranks), its
    Q/K/V rows (192 / 128 of them) and a zero-padded output projection with
    no bias, against the plain version."""
    import torch

    from v3d_tpu_torch.ops.temporal_attention import (
        temporal_block_attention,
        temporal_block_attention_plain,
        temporal_block_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(3)
    b, t, s, c = 2, 18, 4096, 320
    x32 = torch.randn(b, t, s, c, device=dev, generator=gen)
    out = []
    for heads in (3, 2):
        inner = 64 * heads
        plan = temporal_block_plan(b, t, s, c, heads, 64)
        if plan["path"] != "wgmma":
            raise SmokeFailure(f"K2 at {heads} heads: plan {plan}")
        ws32 = [torch.randn(inner, c, device=dev, generator=gen) * c ** -0.5 for _ in range(3)]
        wo32 = torch.randn(c, inner, device=dev, generator=gen) * inner ** -0.5
        wo32[:, :32] = 0.0          # the padded half head
        ws32 += [wo32, torch.zeros(c, device=dev)]
        x = x32.bfloat16()
        ws = [w.bfloat16() for w in ws32]
        tokens = b * t * s
        out.append(_check(
            "temporal_block", f"ds1 TP rank {(b, t, s, c)} h{heads} (inner {inner})",
            torch.bfloat16, lambda: temporal_block_attention(x, *ws, heads),
            lambda: temporal_block_attention_plain(x, *ws, heads),
            lambda: temporal_block_attention_plain(x.float(), *ws32, heads),
            (8 * tokens * c * inner + 4 * b * s * heads * t * t * 64,
             (2 * tokens * c + 4 * c * inner + c) * 2),
            lambda: unfused_temporal_layer(x, *ws, heads), phase="28 tp"))
    return out


def phase_tp_one(engine, dev) -> dict:
    """28(a), one process: phase 5's engine, TP_FORWARDS CFG-doubled denoise
    steps at full width (36 frames at 64^2, bf16) after a warm-up, launches
    exact; the reference of the ranks' forwards.  And K2 at a rank's heads
    (``tp_k2_checks``)."""
    phase = "28 tp"
    t_phase = time.perf_counter()
    checks = tp_k2_checks(dev)
    one = _timed_forwards(engine, tp_inputs(engine, dev))
    expect = _scaled(frames_forward_launches(engine.unet), TP_FORWARDS)
    ok = one["launches"] == expect
    say(phase, f"(a) one process: {TP_FORWARDS} CFG-doubled V3D-512 denoise steps "
        f"({2 * engine.num_frames} frames at {FRAMES_RES // 8}^2 latents, bf16): "
        f"{one['s']:.3f} s a forward, peak {one['peak_gib']:.2f} GiB, parameters "
        f"{one['param_bytes']:,} B, launches {_nonzero(one['launches'])} (expect "
        f"{_nonzero(expect)}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"one-process denoise launches {one['launches']} (expect {expect})")
    say(phase, f"28(a) one process took {time.perf_counter() - t_phase:.1f} s")
    return dict(one, checks=checks, param_sum=_param_sum(engine.unet))


def _tp_rank(index: int, nproc: int, store: str, out_dir: str, device: str) -> None:
    """A rank of 28(a): the full-width engine, its UNet cut over "model" of a
    (1, nproc) mesh over gloo, ``_timed_forwards``; its numbers into
    ``out_dir``."""
    import os

    import torch
    import torch.distributed as dist

    from v3d_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from v3d_tpu_torch.parallel.tensor import tp_shard_

    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))  # they share the host
    dev = init_distributed(device, timeout_s=300, backend="gloo",
                           init_method=f"file://{store}", rank=index, world_size=nproc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = make_mesh(data=1, model=nproc, device=dev.type)
        engine = build_frames_engine(dev)
        param_sum = _param_sum(engine.unet)
        tp_shard_(engine.unet, mesh)
        inputs = tp_inputs(engine, dev)
        dist.barrier()
        got = _timed_forwards(engine, inputs)
        torch.save(dict(got, param_sum=param_sum, backend=dist.get_backend()),
                   os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def phase_tp_ranks(one: dict, device: str = "cuda:0") -> dict:
    """28(a), TP_NPROC ranks sharing this card over gloo: the same denoise
    steps with the UNet tensor-parallel over "model" against the one
    process's (``phase_tp_one``): PSNR, each rank's launches exactly one
    process's, seconds a forward, all-reduces and bytes a forward, parameter
    bytes per rank, peak per rank."""
    import os
    import tempfile

    import torch

    from v3d_tpu_torch.parallel.dryrun import spawn_ranks

    phase = "28 tp"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_tp_rank, TP_NPROC, (TP_NPROC, os.path.join(tmp, "store"), tmp, device),
                    timeout_s=400)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(TP_NPROC)]
    expect = _scaled(frames_forward_launches(build_frames_engine("meta").unet), TP_FORWARDS)
    quality = [psnr(r["out"], one["out"]) for r in ranks]
    max_abs = [float((r["out"] - one["out"]).abs().max()) for r in ranks]
    ok = (all(q >= TP_MIN_PSNR for q in quality)
          and all(torch.equal(r["out"], ranks[0]["out"]) for r in ranks)
          and all(r["param_sum"] == one["param_sum"] and r["backend"] == "gloo"
                  for r in ranks)
          and all(r["launches"] == expect for r in ranks))
    say(phase, f"(a) {TP_NPROC} ranks on this card over gloo, a (1, {TP_NPROC}) mesh, the "
        f"full-width UNet cut over model (heads and MLP columns), {TP_FORWARDS} denoise "
        f"steps vs one process's: PSNR {[round(q, 2) for q in quality]} dB (>= "
        f"{TP_MIN_PSNR:g}), max abs {max_abs} | seconds a forward "
        f"{[round(r['s'], 3) for r in ranks]} vs {one['s']:.3f} one process (host clock, "
        f"synchronised; gloo stages every all_reduce through the host) | a forward's "
        f"collectives per rank {[r['traffic'] for r in ranks]} | parameter bytes per rank "
        f"{[r['param_bytes'] for r in ranks]} vs {one['param_bytes']} | peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB vs {one['peak_gib']:.2f} | launches "
        f"per rank {[_nonzero(r['launches']) for r in ranks]} (expect one process's "
        f"{_nonzero(expect)}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"tensor-parallel forward on {TP_NPROC} ranks: {quality} dB, "
                           f"launches {[r['launches'] for r in ranks]} (expect {expect})")
    say(phase, f"28(a) ranks took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": _summed(*(r["launches"] for r in ranks)), "psnr": quality,
            "max_abs": max_abs, "seconds": [r["s"] for r in ranks],
            "traffic": [r["traffic"] for r in ranks]}


def phase_tp_dryrun() -> dict:
    """28(b): the dry run on TP_DRY_NPROC ranks on this card over gloo, a (2,
    2) mesh: the tensor-parallel fine-tune step and sampling (each within its
    bounds, each rank's launches its "data" share's), the full-size meta
    stage (every output shape, the gathered parameter count), the DP recon
    stages and the refpoint at TP_DRY_RUNG (K4 / K5 once a rank)."""
    from v3d_tpu_torch.parallel import dryrun

    phase = "28 tp"
    report, seconds = run_dryrun(phase, TP_DRY_RUNG, TP_DRY_NPROC)
    ranks = report["ranks"]
    data, model = dryrun.mesh_shape(TP_DRY_NPROC)
    want_t = [dryrun_train_launches(data)[r // model] for r in range(TP_DRY_NPROC)]
    want_s = [dryrun_sample_launches(data)[r // model] for r in range(TP_DRY_NPROC)]
    got_t = [_nonzero(r["train"]["launches"]) for r in ranks]
    got_s = [_nonzero(r["sampling"]["launches"]) for r in ranks]
    render = {"gs_composite_fwd": 1, "gs_composite_bwd": 1}
    got_r = [_nonzero(r["refpoint"]["gs"]["launches"]) for r in ranks]
    full = [r["fullsize"] for r in ranks]
    gs, ne = ranks[0]["refpoint"]["gs"], ranks[0]["refpoint"]["neus"]
    ok = (report["backend"] == "gloo" and len(ranks) == TP_DRY_NPROC
          and all(r["mesh"] == [data, model] for r in ranks)
          and got_t == want_t and got_s == want_s and all(g == render for g in got_r)
          and all(r["train"]["loss_rel"] <= dryrun.TRAIN_LOSS_REL
                  and r["train"]["min_cos"] >= dryrun.TRAIN_MIN_COS
                  and r["train"]["param_max_abs"] <= dryrun.TP_PARAM_MAX_ABS
                  and r["sampling"]["max_abs"] <= dryrun.SAMPLE_MAX_ABS for r in ranks)
          and all(f["out_shape"] == f["want_shape"] and f["params"] == f["params_gathered"]
                  for f in full)
          and gs["render_max_abs"] <= dryrun.RENDER_MAX_ABS
          and gs["grad_rel"] <= dryrun.GS_GRAD_REL and ne["grad_rel"] <= dryrun.NEUS_GRAD_REL)
    say(phase, f"(b) dryrun --nproc {TP_DRY_NPROC} --backend gloo --rung {TP_DRY_RUNG} on a "
        f"{data}x{model} mesh: {seconds:.1f} s | TP fine-tune loss rel "
        f"{[r['train']['loss_rel'] for r in ranks]} (<= {dryrun.TRAIN_LOSS_REL}), least "
        f"cosine {[r['train']['min_cos'] for r in ranks]} (>= {dryrun.TRAIN_MIN_COS}), "
        f"updated parameters max abs {[r['train']['param_max_abs'] for r in ranks]} (<= "
        f"{dryrun.TP_PARAM_MAX_ABS:g}), launches {got_t} (expect {want_t}) | TP sampling max "
        f"abs {[r['sampling']['max_abs'] for r in ranks]} (<= {dryrun.SAMPLE_MAX_ABS}), "
        f"launches {got_s} (expect {want_s}) | full-size: {full[0]['params']:,} parameters, "
        f"denoised {[f['out_shape'] for f in full]}, parameter bytes per rank "
        f"{[f['local_bytes'] for f in full]} of {full[0]['full_bytes']}, a forward's "
        f"collectives per rank {[f['traffic'] for f in full]} | refpoint render max abs "
        f"{gs['render_max_abs']}, 3DGS gradients {gs['grad_rel']}, NeuS gradients "
        f"{ne['grad_rel']}, K4 / K5 per rank {got_r} | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"dry run on {TP_DRY_NPROC} ranks: {json.dumps(ranks)[:3000]}")
    return {"launches": _summed(_rank_sum(ranks, lambda r: r["train"]["launches"]),
                                _rank_sum(ranks, lambda r: r["sampling"]["launches"]),
                                _rank_sum(ranks, lambda r: r["refpoint"]["gs"]["launches"])),
            "seconds": seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases",
                   default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,"
                           "25,26,27,28,29",
                   help="comma-separated subset of phases to run")
    args = p.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    import torch

    import v3d_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_env()
    say("run", f"phases {sorted(phases)}")
    if 2 in phases:
        phase_build()
    kernel_checks = phase_kernels() if 3 in phases else {}
    engine = (build_engine(dev)
              if phases & {4, 5, 9, 10, 12, 16, 17, 27, 28} else None)
    if 4 in phases:
        phase_unet(engine)
    gen = phase_generate(engine) if 5 in phases else {}
    routes = phase_routes(engine) if 9 in phases else {}
    if 10 in phases:
        phase_checkpoint(engine, dev)
    entry = phase_gen_entry_points(engine, gen) if 16 in phases else {}
    gen_expect = gen_launches(engine) if 12 in phases else {}
    iter_expect = iterative_launches(engine) if 17 in phases else {}
    frames_one = phase_frames_one(engine, dev) if 27 in phases else {}
    tp_one = phase_tp_one(engine, dev) if 28 in phases else {}
    del engine
    torch.cuda.empty_cache()
    frames = {}
    if 27 in phases:
        frames = {"frames_one": {"launches": frames_one["launches"]},
                  "frames_ranks": phase_frames_ranks(frames_one)}
    if 28 in phases:
        kernel_checks.setdefault("temporal_block", []).extend(tp_one["checks"])
        frames.update(tp_one={"launches": tp_one["launches"]},
                      tp_ranks=phase_tp_ranks(tp_one))
    image = phase_image(dev) if 21 in phases else {}
    flux = phase_flux(dev) if 29 in phases else {}
    fit, rgba = {}, None
    if phases & {6, 7, 18, 19, 20, 22, 25}:
        t0 = time.perf_counter()
        rgba = scene_frames(dev)
        say("6 fit", f"target frames {rgba.shape} (rgb + silhouette) rendered in "
            f"reference_mode() in {time.perf_counter() - t0:.2f} s, mean "
            f"{rgba[..., :3].mean():.3f}")
    if phases & {6, 7}:
        fit = phase_fit(rgba[..., :3], dev)
    if 7 in phases:
        phase_profile(fit["trainer"], fit["step_ms"])
    paths = {"gen": gen, "routes": routes, "fit": {"launches": fit.get("launches", {})},
             "image": image, "flux": flux, **frames}
    if 22 in phases:
        paths.update(phase_lpips(rgba, dev, fit.get("step_ms")))
    if 25 in phases:
        paths.update(phase_chunks(rgba[..., :3], dev))
    g_np = fit["trainer"].gaussians_np() if fit and 14 in phases else None
    del fit
    torch.cuda.empty_cache()
    paths["train"] = phase_train(dev) if 8 in phases else {}
    train_engine = paths["train"].pop("engine", None)
    if 18 in phases:
        paths["png_train"] = phase_png_train(train_engine, rgba, dev)
    if 26 in phases:
        from v3d_tpu_torch.apps.train_diffusion import build_train_engine

        paths["dp_train"] = phase_dp_step(train_engine or build_train_engine(device=dev), dev)
    del train_engine
    torch.cuda.empty_cache()
    dp = {}
    if 26 in phases:
        dp = phase_dp_ranks(dev, paths["dp_train"]["per_step"])
        paths.update(dp_cli=dp["dp_cli"], dp_render=dp["dp_render"],
                     dp_tiny_train=dp["dp_tiny_train"])
    if 27 in phases:
        paths["frames_dryrun"] = phase_frames_dryrun(dp.get("dryrun"))
    if 28 in phases:
        paths["tp_dryrun"] = phase_tp_dryrun()
    paths["ae"] = phase_ae(rgba[..., :3], dev) if 19 in phases else {}
    paths["pixelnerf"] = phase_pixelnerf(rgba[..., :3], dev) if 20 in phases else {}
    neus = phase_neus() if 11 in phases else {}
    if 12 in phases:
        assets = phase_full_asset(gen_expect)["assets"]
        paths["full_asset"] = {"launches": _summed(*(stage for a in assets
                                                     for stage in a["launches"].values()))}
    if 13 in phases:
        phase_refine(neus)
    if 14 in phases:
        gs_mesh = phase_gs_to_mesh(g_np)
        kernel_checks.setdefault("gs_composite_fwd", []).append(gs_mesh["check"])
        paths["gs_to_mesh"] = gs_mesh
    if 15 in phases:
        phase_dpt(neus)
    paths["entry"] = entry
    paths["iterative"] = phase_iterative(iter_expect) if 17 in phases else {}
    if 23 in phases:
        scenes = phase_scenes()
        for name, entries in scenes["checks"].items():
            kernel_checks.setdefault(name, []).extend(entries)
        paths.update(scenes["paths"])
    if 24 in phases:
        paths.update(phase_entry_points())

    report = []
    for name, meta in KERNELS.items():
        checks = kernel_checks.get(name, [])
        bf16 = [c for c in checks if c["dtype"] == "bfloat16"]
        head = bf16[0] if bf16 else checks[0] if checks else {}
        by_path = {k: p["launches"][name] for k, p in paths.items()
                   if p.get("launches", {}).get(name)}
        report.append({
            "name": f"{meta['label']} {name}", "route": "cuda",
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
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
