#!/usr/bin/env python3
"""Smoke test of the v3d_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one line before the last:

1. environment: ``nvidia-smi`` name and power limit, CUDA, nvcc, TF32 flags;
2. build of the hand-written kernels (v3d_tpu_torch/csrc, nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with error, and median CUDA-event time of both;
4. one full-width V3D-512 UNet forward (bf16, batch 36 at 64^2) with the
   kernels against the same forward in ``reference_mode()`` (plain versions);
5. the main path twice: ``v3d_tpu_torch.apps.generate.sample_one`` on a
   synthetic 512^2 RGBA image, 18 frames, 25 steps, CFG 3.5, seeded random
   bf16 weights; launch counts per generation, timings, peak memory.

Then one JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  No CUDA device: exit 2 at once.  Nothing here imports JAX or v3d_tpu.

TF32: both ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, so float32 products and
convolutions run in full float32 (the main path itself runs in bf16).
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
EXPECTED_LAUNCHES = {"flash_attn_fwd": 250, "temporal_block": 125,
                     "temporal_core": 275}
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


def _check(name, shape_tag, dtype, kernel_fn, plain_fn, plain_f32_fn) -> dict:
    """Run kernel and plain version on the same inputs; compare and time."""
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
    say("3 kernels", f"{KERNELS[name]['label']} {name} {shape_tag} "
        f"{str(dtype).split('.')[-1]}: max_abs {err:.3e} {metric} | kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} {shape_tag} {dtype} disagrees: {metric}")
    return {"shape": shape_tag, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels() -> dict:
    import torch

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

    # K1: 2-sample slices of ds1 and ds2, the layout the projection gives
    for tag, (b, h, s) in (("ds1", (2, 5, 4096)), ("ds2", (2, 10, 1024))):
        x32 = [randn(b, s, h, 64).transpose(1, 2) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in x32)
            up = [t.float() for t in (q, k, v)]
            results["flash_attn_fwd"].append(_check(
                "flash_attn_fwd", f"{tag} {(b, h, s, 64)}", dtype,
                lambda: flash_attn_fwd(q, k, v),
                lambda: flash_attn_fwd_plain(q, k, v),
                lambda: flash_attn_fwd_plain(*up)))

    # K2: the ds1 temporal layer, x (2, 18, 4096, 320), 5 heads of 64
    b, t, s, c, heads = 2, 18, 4096, 320, 5
    x32 = randn(b, t, s, c)
    w32 = [randn(c, c, scale=c ** -0.5) for _ in range(4)] + [randn(c, scale=0.1)]
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        ws = [w.to(dtype) for w in w32]
        up = [x.float()] + [w.float() for w in ws]
        results["temporal_block"].append(_check(
            "temporal_block", f"ds1 {(b, t, s, c)} h{heads}", dtype,
            lambda: temporal_block_attention(x, *ws, heads),
            lambda: temporal_block_attention_plain(x, *ws, heads),
            lambda: temporal_block_attention_plain(*up, heads)))

    # K3: n = b*s*heads = 20480 (ds2), 10240 (ds4), 2560 (ds8), projection
    # output layout (b, t, s, heads*64) as strided views of one buffer
    for tag, (s, heads) in (("ds2", (1024, 10)), ("ds4", (256, 20)),
                            ("ds8", (64, 20))):
        hd = heads * 64
        qkv32 = randn(2, 18, s, 3 * hd)
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
            up = [t.float() for t in (q, k, v)]
            results["temporal_core"].append(_check(
                "temporal_core", f"{tag} n={2 * s * heads}", dtype,
                lambda: temporal_core(q, k, v, heads),
                lambda: temporal_core_plain(q, k, v, heads),
                lambda: temporal_core_plain(*up, heads)))
    return results


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
        counts_ok = counts == EXPECTED_LAUNCHES
        say("5 generate", f"request {r}: {wall:.3f} s (cond "
            f"{timings['cond_s']:.3f}, sample {timings['sample_s']:.3f}, "
            f"decode {timings['decode_s']:.3f}) | peak "
            f"{peak:.2f} GiB | frames {frames.shape} {frames.dtype} "
            f"[{frames.min()}, {frames.max()}] std {frames.std():.2f} | "
            f"launches {counts} (expect {EXPECTED_LAUNCHES}) | "
            f"{'ok' if shape_ok and counts_ok else 'FAIL'}")
        if not (shape_ok and counts_ok):
            raise SmokeFailure(f"request {r}: frames {frames.shape}, "
                               f"launches {counts}")
        out = {"launches": counts, "timings": timings, "peak_gib": peak}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default="1,2,3,4,5",
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

    report = []
    for name, meta in KERNELS.items():
        checks = kernel_checks.get(name, [])
        bf16 = [c for c in checks if c["dtype"] == "bfloat16"]
        head = bf16[0] if bf16 else {}
        report.append({
            "name": f"{meta['label']} {name}", "route": "cuda",
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": gen.get("launches", {}).get(name),
            "max_abs_err": head.get("max_abs_err"), "ms": head.get("ms"),
            "plain_ms": head.get("plain_ms"), "at": head.get("shape"),
            "checks": checks})
    print(json.dumps({"kernels": report}), flush=True)
    last = {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}
    if phases != {1, 2, 3, 4, 5}:
        last["phases"] = sorted(phases)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
