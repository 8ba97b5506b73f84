"""Time K10 through ``ops.layer_norm.layer_norm_f32`` at every LayerNorm
shape of one V3D-512 UNet forward (``chip_smoke.K10_FORWARD_SHAPES``), one
SD 2.1 UNet2D forward (``K10_IMAGE_SHAPES``) and CLIP ViT-H's (257, 1280),
bf16 x with bf16 weight and bias, beside the plain chain it replaces
(LayerNormF32's upcast, f32 ``F.layer_norm`` and downcast) and
``F.layer_norm`` on the f32 copy alone (the library yardstick), each
replayed from a CUDA graph (``chip_smoke.graph_ms``: the card's time
alone) and each call on the next of a ring of inputs larger than the 50 MB
L2 together, so every call reads x from HBM.

    python3 v3d_tpu_torch/kernels/time_layer_norm.py

Inputs come from a seeded generator; each K10 output is held to the plain
chain as tests/test_torch_kernels_gpu.py holds it (every element within
one bf16 ulp at 2^-10 or above, < 0.1% of them differing).  Besides, each
call's time back to back with its host path (``chip_smoke.cuda_ms``), which
is what a call costs where the host paces the card.
Prints a line per shape and, last, one JSON object: the card, the ms per
shape of the three and the bound, and each forward's sums.  Needs one CUDA
card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RING_BYTES = 256 * 2**20   # the inputs of a ring: five times the L2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()

    import torch
    import torch.nn.functional as F

    from v3d_tpu_torch.ops.layer_norm import layer_norm_f32, layer_norm_f32_plain

    if not torch.cuda.is_available():
        raise SystemExit("time_layer_norm: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    sites = ([("v3d", s, n) for s, n in cs.K10_FORWARD_SHAPES]
             + [("sd", s, n) for s, n in cs.K10_IMAGE_SHAPES] + [("clip", (257, 1280), 66)])
    rows_out, sums = [], {}
    for tag, (rows, C), calls in sites:
        nbytes = rows * C * 2
        ring = max(2, min(8, -(-RING_BYTES // nbytes)))
        xs = [(torch.randn(rows, C, device=dev, generator=gen) + 0.3).to(torch.bfloat16)
              for _ in range(ring)]
        ups = [x.float() for x in xs]
        w = (1 + 0.1 * torch.randn(C, device=dev, generator=gen)).to(torch.bfloat16)
        b = (0.1 * torch.randn(C, device=dev, generator=gen)).to(torch.bfloat16)
        wf, bf = w.float(), b.float()
        out, ref = layer_norm_f32(xs[0], w, b), layer_norm_f32_plain(xs[0], w, b)
        diff = (out.float() - ref.float()).abs()
        big = torch.maximum(out.float().abs(), ref.float().abs()).clamp(min=2.0 ** -10)
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
        differing = float((diff > 0).float().mean())
        if not (bool((diff <= ulp).all()) and differing < 1e-3):
            raise SystemExit(f"K10 {(rows, C)} disagrees with the plain chain: max "
                             f"{float(diff.max())}, {differing:.2e} of elements")

        def ringed(fn, args):
            state = {"i": 0}

            def call():
                state["i"] = (state["i"] + 1) % len(args)
                return fn(args[state["i"]])
            return call

        ms = cs.graph_ms(ringed(lambda x: layer_norm_f32(x, w, b), xs))
        plain_ms = cs.graph_ms(ringed(lambda x: layer_norm_f32_plain(x, w, b), xs))
        host_ms = cs.cuda_ms(ringed(lambda x: layer_norm_f32(x, w, b), xs))
        plain_host_ms = cs.cuda_ms(ringed(lambda x: layer_norm_f32_plain(x, w, b), xs))
        library_ms = cs.graph_ms(ringed(lambda x: F.layer_norm(x, (C,), wf, bf, 1e-5), ups))
        bound = cs.bound_ms(*cs.layer_norm_work(rows, C, 2, 2), cs.PEAK_BF16)[0]
        s = sums.setdefault(tag, dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                      bound_ms=0.0))
        for k, v in (("calls", calls), ("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", library_ms), ("bound_ms", bound)):
            s[k] += v if k == "calls" else calls * v
        print(f"K10 {tag} {(rows, C)} bf16 x{calls}: kernel {ms:.4f} ms "
              f"({100 * bound / ms:.1f}% of the bound {bound:.4f}), plain chain "
              f"{plain_ms:.4f}, F.layer_norm on f32 {library_ms:.4f} | back to back "
              f"{host_ms:.4f} / chain {plain_host_ms:.4f} | {differing:.2e} of elements "
              f"differ by one ulp | ring of {ring}", flush=True)
        rows_out.append({"site": tag, "rows": rows, "C": C, "calls": calls, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                         "host_ms": host_ms, "plain_host_ms": plain_host_ms,
                         "differing": differing})
        del xs, ups
        torch.cuda.empty_cache()
    for tag, s in sums.items():
        print(f"{tag}: {s['calls']} calls a forward: kernel {s['ms']:.4f} ms, plain chain "
              f"{s['plain_ms']:.4f}, F.layer_norm on f32 {s['library_ms']:.4f}, bound "
              f"{s['bound_ms']:.4f}", flush=True)
    print(json.dumps({"card": card, "forward": sums, "shapes": rows_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
