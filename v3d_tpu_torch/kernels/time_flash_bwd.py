"""Time the flash-attention backward pair K8 + K7 through
``ops.attention.flash_attn_bwd`` at the fine-tune step's shapes, ds1 (18, 5,
4096, 64) and ds2 (18, 10, 1024, 64), bf16, q/k/v/do as (b, h, s, d) views of
(b, s, h, d) buffers and o, lse from the tree's K1, with the backward of
``F.scaled_dot_product_attention`` on the same inputs beside it
(``chip_smoke.cuda_ms``: back-to-back calls between CUDA events).

    python3 v3d_tpu_torch/kernels/time_flash_bwd.py [--tree DIR]

``--tree`` imports ``v3d_tpu_torch`` from another checkout (its wrapper,
its sources, its build directory), so that one run on the card times
two trees' pairs in turns, e.g. a parent commit unpacked with ``git archive``
into ``build/parent``:

    for t in build/parent . . build/parent; do
        python3 v3d_tpu_torch/kernels/time_flash_bwd.py --tree $t; done

Inputs come from a seeded generator, the same in every tree; dq, dk and dv
are each held against the tree's plain backward in f32 (PSNR >= 40 dB).
Prints a line per shape and, last, one JSON object: the tree, the card and
per shape the pair's ms, SDPA's backward ms and the PSNRs.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (("ds1", (18, 5, 4096)), ("ds2", (18, 10, 1024)))


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
    import torch.nn.functional as F

    import v3d_tpu_torch
    from v3d_tpu_torch.ops import attention as A

    if Path(v3d_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"v3d_tpu_torch came from {v3d_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_bwd: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for tag, (b, h, s) in SHAPES:
        q, k, v, do = (torch.randn(b, s, h, 64, device=dev, generator=gen)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        o, lse = A.flash_attn_fwd(q, k, v, with_lse=True)
        got = A.flash_attn_bwd(q, k, v, o, lse, do)
        ref = A.flash_attn_bwd_plain(*(x.float() for x in (q, k, v, o)), lse, do.float())
        quality = [cs.psnr(g_, r_) for g_, r_ in zip(got, ref)]
        if not min(quality) >= cs.BF16_MIN_PSNR:
            raise SystemExit(f"{tag}: the pair disagrees with the plain backward: {quality}")
        del got, ref
        pair_ms = cs.cuda_ms(lambda: A.flash_attn_bwd(q, k, v, o, lse, do))
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        sdpa_ms = cs.cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True))
        print(f"{tag} {(b, h, s, 64)}: K8 + K7 {pair_ms:.4f} ms, SDPA backward "
              f"{sdpa_ms:.4f} ms, PSNR dq/dk/dv " + " / ".join(f"{x:.2f}" for x in quality)
              + " dB", flush=True)
        rows.append({"shape": [b, h, s, 64], "tag": tag, "pair_ms": pair_ms,
                     "sdpa_bwd_ms": sdpa_ms, "psnr_dq_dk_dv": quality})
        del q, k, v, do, o, lse, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "card": card, "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
