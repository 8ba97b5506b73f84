"""Time K9 (``ops.flash_attention.flash_attn_fwd_wide``) at chip_smoke.py's
phase-3 shapes (the VAE decode (18, 4096, 1, 512), CLIP (1, 257, 16, 80),
d = 128 (4, 1024, 4, 128) and one key (18, 4096, 1 key, 512)) in float32
and bfloat16, q/k/v as (b, h, s, d) views of (b, s, h, d) buffers, with
``F.scaled_dot_product_attention`` on the same views beside it
(``chip_smoke.cuda_ms``: back-to-back calls between CUDA events; and
``chip_smoke.graph_ms``: the same calls replayed from a CUDA graph, the
card's time alone where the wrapper's host time is longer).

    python3 v3d_tpu_torch/kernels/time_flash_wide.py [--tree DIR] [--only TAGS]

``--tree`` imports ``v3d_tpu_torch`` from another checkout (its wrapper,
its sources, its build directory), so that one run on the card times two
trees' kernels in turns, e.g. a parent commit unpacked with ``git archive``
into ``build/parent``:

    for t in build/parent . . build/parent; do
        python3 v3d_tpu_torch/kernels/time_flash_wide.py --tree $t; done

``--only`` takes comma-separated tags ("vae", "clip", "d128", "sk1") and
dtypes ("f32", "bf16"), e.g. ``--only vae,clip,bf16``.  Inputs come from a
seeded generator, the same in every tree; each result is held against the
tree's plain version (float32: max rel <= 1e-4; bfloat16: PSNR >= 40 dB
against the plain version in float32).  Prints a line per case and, last,
one JSON object: the tree, the card and per case K9's and SDPA's ms, each
back to back and from a graph.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (tag, (b, sq, sk, h, d))
SHAPES = (("vae", (18, 4096, 4096, 1, 512)), ("clip", (1, 257, 257, 16, 80)),
          ("d128", (4, 1024, 1024, 4, 128)), ("sk1", (18, 4096, 1, 1, 512)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(ROOT),
                   help="checkout whose v3d_tpu_torch is timed (default: this one)")
    p.add_argument("--only", default="",
                   help="comma-separated shape tags and dtypes to run (default: all)")
    args = p.parse_args(argv)
    tree = Path(args.tree).resolve()
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(tree)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    cs = _chip_smoke()

    import torch
    import torch.nn.functional as F

    import v3d_tpu_torch
    from v3d_tpu_torch.ops import flash_attention as fa

    if Path(v3d_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"v3d_tpu_torch came from {v3d_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_wide: needs a CUDA card")
    only = {x for x in args.only.split(",") if x}
    tags = only & {t for t, _ in SHAPES} or {t for t, _ in SHAPES}
    dtypes = [dt for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
              if name in only or not only & {"f32", "bf16"}]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for tag, (b, sq, sk, h, d) in SHAPES:
        x32 = [torch.randn(b, s, h, d, device=dev, generator=gen).transpose(1, 2)
               for s in (sq, sk, sk)]
        if tag not in tags:
            continue
        for dtype in dtypes:
            q, k, v = (t.to(dtype) for t in x32)
            out = fa.flash_attn_fwd_wide(q, k, v)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                ref = fa.flash_attn_fwd_wide_plain(q, k, v)
                quality = float((out - ref).abs().max()) / float(ref.abs().max())
                ok = quality <= cs.F32_MAX_REL
            else:
                ref = fa.flash_attn_fwd_wide_plain(*(t.float() for t in (q, k, v)))
                quality = cs.psnr(out, ref)
                ok = quality >= cs.BF16_MIN_PSNR
            del out, ref
            if not ok or not bool(torch.isfinite(fa.flash_attn_fwd_wide(q, k, v)).all()):
                raise SystemExit(f"{tag} {dtype}: K9 disagrees with the plain version "
                                 f"({quality})")
            ms = cs.cuda_ms(lambda: fa.flash_attn_fwd_wide(q, k, v))
            sdpa_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            graph = cs.graph_ms(lambda: fa.flash_attn_fwd_wide(q, k, v))
            sdpa_graph = cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            name = str(dtype).split(".")[-1]
            print(f"{tag} {(b, sq, h, d)} sk={sk} {name}: K9 {ms:.4f} ms (from a CUDA "
                  f"graph {graph:.4f}), SDPA {sdpa_ms:.4f} ms ({sdpa_graph:.4f}), "
                  f"{ms / sdpa_ms:.2f}x, "
                  + (f"max_rel {quality:.2e}" if dtype == torch.float32
                     else f"psnr {quality:.2f} dB"), flush=True)
            rows.append({"tag": tag, "shape": [b, sq, sk, h, d], "dtype": name,
                         "ms": ms, "sdpa_ms": sdpa_ms, "graph_ms": graph,
                         "sdpa_graph_ms": sdpa_graph, "quality": quality})
            del q, k, v
        del x32
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "card": card, "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
