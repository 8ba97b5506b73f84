"""Time K6 through ``ops.group_norm.group_norm_fwd`` at every GroupNorm
shape of one V3D-512 UNet forward (``chip_smoke.K6_FORWARD_SHAPES``) and at
the VAE decoder's maps, bf16 with bf16 scale and bias, each call replayed
from a CUDA graph (``chip_smoke.graph_ms``: the card's time alone).

    python3 v3d_tpu_torch/kernels/time_group_norm.py [--tree DIR]

``--tree`` imports ``v3d_tpu_torch`` from another checkout (its wrapper,
its sources, its build directory), so that one card session times two
trees' K6 in turns, e.g. a parent commit unpacked with ``git archive`` into
``build/parent``:

    for t in build/parent . . build/parent; do
        python3 v3d_tpu_torch/kernels/time_group_norm.py --tree $t; done

Inputs come from a seeded generator, the same in every tree; each output
is held against the tree's plain version (bf16 PSNR >= 40 dB vs plain
f32).  Prints a line per shape and, last, one JSON object: the tree, the
card, ms per shape and a forward's summed ms.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the VAE decoder's GroupNorm maps in a generation's 18-frame decode (+SiLU)
VAE_SHAPES = ((18, 512, 64, 64), (18, 512, 128, 128), (18, 256, 256, 256),
              (18, 128, 512, 512))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(ROOT),
                   help="checkout whose v3d_tpu_torch is timed (default: this one)")
    args = p.parse_args(argv)
    tree = Path(args.tree).resolve()
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(tree)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    cs = _chip_smoke()

    import torch

    import v3d_tpu_torch
    from v3d_tpu_torch.ops.group_norm import group_norm_act_plain, group_norm_fwd

    if Path(v3d_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"v3d_tpu_torch came from {v3d_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_group_norm: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, forward_ms = [], 0.0
    sites = cs.K6_FORWARD_SHAPES + tuple((s, True, 0) for s in VAE_SHAPES)
    for shape, silu, calls in sites:
        C = shape[1]
        fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
        x = (torch.randn(shape, device=dev, generator=gen) + 0.3).to(torch.bfloat16)
        x = x.contiguous(memory_format=fmt)
        w = (1 + 0.1 * torch.randn(C, device=dev, generator=gen)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(C, device=dev, generator=gen)).to(torch.bfloat16)
        quality = cs.psnr(group_norm_fwd(x, w, bias, 32, 1e-5, silu),
                          group_norm_act_plain(x.float(), w, bias, 32, 1e-5, silu))
        if not quality >= cs.BF16_MIN_PSNR:
            raise SystemExit(f"K6 {shape} disagrees with its plain version: {quality} dB")
        ms = cs.graph_ms(lambda: group_norm_fwd(x, w, bias, 32, 1e-5, silu))
        forward_ms += calls * ms
        print(f"K6 {shape}{' +SiLU' if silu else ''}: {ms:.4f} ms from a CUDA graph, "
              f"{quality:.2f} dB, {calls} calls a forward", flush=True)
        rows.append({"shape": list(shape), "silu": silu, "calls": calls, "graph_ms": ms,
                     "psnr_db": quality, "bound_ms": cs.bound_ms(
                         *cs.group_norm_work(shape, silu, 2, 2), cs.PEAK_BF16)[0]})
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "card": card, "forward_ms": forward_ms,
                      "forward_calls": sum(c for _, _, c in sites), "shapes": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
